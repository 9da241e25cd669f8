"""The port's plain versions against the JAX package's oracles, exactly.

Inputs are made with numpy from a seed and handed to both packages.
The CPU runs every op's plain version, so these tests pin the integer
semantics that ``chip_smoke.py`` then holds each CUDA kernel to on the
card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels import ops as r_ops
from repro.kernels import qgemm as r_qgemm
from repro.kernels import ref as r_ref
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import qconv as t_qconv
from repro_torch.kernels import qgemm as t_qgemm
from repro_torch.kernels import ref as t_ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(t, r):
    np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    assert t.numpy().dtype == np.asarray(r).dtype


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


# ------------------------------------------------------------ round_shift

@pytest.mark.parametrize("shift", [0, 1, 2, 5, 13, 30])
def test_round_shift_scalar_on_half_boundaries(shift):
    rng = np.random.default_rng(shift)
    half = (1 << (shift - 1)) if shift else 0
    base = np.arange(-40, 41, dtype=np.int64) << shift
    v = np.concatenate([base + half, base - half, base + half - 1,
                        rng.integers(-2 ** 31, 2 ** 31 - 2 ** 30, 64),
                        [2 ** 31 - 1, -2 ** 31]])
    v = np.clip(v, -2 ** 31, 2 ** 31 - 1).astype(np.int32)
    _eq(t_ref.round_shift(_t(v), shift), r_ref.round_shift(jnp.asarray(v),
                                                           shift))
    _eq(t_ref.align_shift(_t(v), shift), r_ref.align_shift(jnp.asarray(v),
                                                           shift))


def test_round_shift_per_lane():
    rng = np.random.default_rng(1)
    s = np.array([0, 1, 2, 3, 7, 15, 30, 0, 5], np.int32)
    v = rng.integers(-2 ** 24, 2 ** 24, (6, 4, s.size)).astype(np.int32)
    v[0] = (np.arange(-4, 5) << s) + np.where(s > 0, 1 << np.maximum(s - 1, 0),
                                              0)
    v[1] = -v[0]
    want = r_ref.round_shift(jnp.asarray(v), jnp.asarray(s))
    _eq(t_ref.round_shift(_t(v), tuple(int(x) for x in s)), want)
    _eq(t_ref.round_shift(_t(v), _t(s)), want)
    for relu in (False, True):
        _eq(t_ref.requant(_t(v), tuple(int(x) for x in s), relu),
            r_ref.requant(jnp.asarray(v), jnp.asarray(s), relu))


# ------------------------------------------------------------------ gemm

GEMM = [(1, 64, 10, 7, False, False), (5, 33, 7, 0, True, False),
        (9, 130, 41, 9, True, True), (16, 257, 128, 12, False, True)]


@pytest.mark.parametrize("m,k,n,shift,relu,per_col", GEMM)
def test_qgemm_plain_matches_oracle(m, k, n, shift, relu, per_col):
    rng = np.random.default_rng(m * 1000 + k)
    x, w = _i8(rng, (m, k)), _i8(rng, (k, n))
    b = rng.integers(-2 ** 18, 2 ** 18, n).astype(np.int32)
    s = (tuple(int(v) for v in rng.integers(max(0, shift - 3), shift + 3, n))
         if per_col else shift)
    rs = jnp.asarray(s, jnp.int32) if per_col else s
    want = r_ref.qgemm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           rs, relu)
    _eq(t_qgemm.qgemm(_t(x), _t(w), _t(b), shift=s, relu=relu), want)
    _eq(t_ops.qgemm(_t(x), _t(w), None, shift=s, relu=relu),
        r_ref.qgemm_ref(jnp.asarray(x), jnp.asarray(w), None, rs, relu))


@pytest.fixture
def shimmed_pallas(monkeypatch):
    """Bring the JAX package's Pallas kernels back under jax >= 0.9,
    which renamed ``pltpu.TPUCompilerParams`` (scoped to one test)."""
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


@pytest.mark.parametrize("m,k,n,shift,relu,per_col", GEMM)
def test_qgemm_matches_reference_pallas_kernel(shimmed_pallas, m, k, n,
                                               shift, relu, per_col):
    rng = np.random.default_rng(n)
    x, w = _i8(rng, (m, k)), _i8(rng, (k, n))
    b = rng.integers(-2 ** 18, 2 ** 18, n).astype(np.int32)
    s = (tuple(int(v) for v in rng.integers(max(0, shift - 3), shift + 3, n))
         if per_col else shift)
    want = r_qgemm.qgemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         shift=s, relu=relu, interpret=True)
    _eq(t_qgemm.qgemm(_t(x), _t(w), _t(b), shift=s, relu=relu), want)


# ------------------------------------------------------------------ conv

CONV = [  # n, h, cin, cout, k, stride, groups, pool, per_lane
    (1, 9, 3, 8, 3, 1, 1, None, False),
    (2, 11, 6, 10, 3, 2, 1, (2, 2), False),
    (1, 13, 4, 5, 3, 1, 1, (3, 2), True),
    (2, 10, 8, 8, 3, 1, 8, None, False),       # depthwise
    (1, 10, 4, 12, 3, 2, 4, (2, 2), True),     # depthwise, multiplier 3
    (1, 9, 8, 12, 3, 1, 2, None, False),       # ragged grouped
    (1, 12, 6, 6, 5, 1, 3, (2, 2), True),      # ragged grouped + pool
]


def _conv_case(case, seed):
    n, h, cin, cout, k, st, g, pool, per_lane = case
    rng = np.random.default_rng(seed)
    x = _i8(rng, (n, h, h, cin))
    w = _i8(rng, (k, k, cin // g, cout))
    b = rng.integers(-2 ** 12, 2 ** 12, cout).astype(np.int32)
    base = max(0, int(np.log2(74 * 74 * np.sqrt(k * k * cin / g) / 40)))
    shift = (tuple(int(v) for v in rng.integers(max(0, base - 2), base + 3,
                                                cout))
             if per_lane else base)
    return x, w, b, shift, (st, st), g, pool


@pytest.mark.parametrize("case", CONV)
def test_qconv2d_ref_matches_oracle(case):
    x, w, b, shift, strides, g, pool = _conv_case(case, sum(case[:6]))
    rs = jnp.asarray(shift, jnp.int32) if isinstance(shift, tuple) else shift
    for relu in (True, False):
        want = r_ref.qconv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), strides, rs, relu, pool, g)
        _eq(t_ref.qconv2d_ref(_t(x), _t(w), _t(b), strides, shift, relu,
                              pool, g), want)
        _eq(t_ops.qconv2d_nhwc(_t(x), _t(w), _t(b), strides=strides,
                               shift=shift, relu=relu, pool=pool, groups=g),
            want)


def test_qconv2d_pads_and_nchw_wrapper():
    x, w, b, shift, strides, _, pool = _conv_case(CONV[1], 5)
    pads = (1, 2, 0, 1)
    xp = np.pad(x, ((0, 0), (1, 0), (2, 1), (0, 0)))
    want = r_ref.qconv2d_ref(jnp.asarray(xp), jnp.asarray(w), jnp.asarray(b),
                             strides, shift, True, pool)
    _eq(t_ops.qconv2d_nhwc(_t(x), _t(w), _t(b), strides=strides, pads=pads,
                           shift=shift, pool=pool), want)
    y = t_ops.qconv2d_nchw(_t(x.transpose(0, 3, 1, 2)),
                           _t(w.transpose(3, 2, 0, 1)), _t(b),
                           strides=strides, pads=pads, shift=shift, pool=pool)
    _eq(y.permute(0, 2, 3, 1).contiguous(), want)


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("pool", [None, (2, 2), (3, 2)])
def test_fused_skip_epilogue_equals_unfused_stages(per_lane, pool):
    """Conv + Add (+ MaxPool) in one call == the JAX package's standalone
    conv, add and pool oracles in sequence."""
    x, w, b, shift, strides, _, _ = _conv_case(
        (2, 12, 8, 8, 3, 1, 1, None, per_lane), 11)
    rng = np.random.default_rng(12)
    skip = _i8(rng, (2, 10, 10, 8))
    rs = jnp.asarray(shift, jnp.int32) if per_lane else shift
    conv = r_ref.qconv2d_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             strides, rs, True)
    for skip_shifts, merge_shift, merge_relu in (((0, 0), 0, False),
                                                 ((1, 0), 1, True),
                                                 ((0, 2), 3, True)):
        want = r_ref.qadd_ref([conv, jnp.asarray(skip)], skip_shifts,
                              merge_shift, merge_relu)
        if pool is not None:
            want = r_ref.maxpool2d_ref(want, *pool)
        got = t_qconv.qconv2d(_t(x), _t(w), _t(b), strides=strides,
                              shift=shift, relu=True, pool=pool,
                              skip=_t(skip), skip_shifts=skip_shifts,
                              merge_shift=merge_shift, merge_relu=merge_relu)
        _eq(got, want)


@pytest.mark.parametrize("pool", [None, (2, 2)])
@pytest.mark.parametrize("concat_shift,concat_relu", [(0, False), (1, True),
                                                      (2, False)])
def test_concat_epilogue_writes_its_slice_in_place(pool, concat_shift,
                                                   concat_relu):
    x, w, b, shift, strides, _, _ = _conv_case(
        (2, 10, 6, 5, 3, 1, 1, None, False), 21)
    conv = r_ref.qconv2d_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             strides, shift, True)
    want = r_ref.qconcat_ref([conv], [concat_shift], relu=concat_relu)
    if pool is not None:
        want = r_ref.maxpool2d_ref(want, *pool)
    oh = want.shape[1]
    buf = torch.full((2, oh, oh, 13), 77, dtype=torch.int8)
    out = t_ops.qconv2d_nhwc(_t(x), _t(w), _t(b), strides=strides,
                             shift=shift, pool=pool, out_buf=buf, out_off=4,
                             concat_shift=concat_shift,
                             concat_relu=concat_relu)
    assert out is buf                      # the caller's buffer, in place
    _eq(buf[..., 4:9].contiguous(), want)
    assert bool((buf[..., :4] == 77).all()) and bool((buf[..., 9:] == 77).all())


# ---------------------------------------------------- merges and pools

def test_qadd_and_qconcat_match_oracles():
    rng = np.random.default_rng(4)
    a, b_, c = (_i8(rng, (2, 5, 5, 6)) for _ in range(3))
    for shifts, shift, relu in (((0, 0), 0, False), ((2, 0), 1, True),
                                ((1, 3), 4, False)):
        _eq(t_ops.qadd_nhwc([_t(a), _t(b_)], shifts, shift=shift, relu=relu),
            r_ops.qadd_nhwc([jnp.asarray(a), jnp.asarray(b_)], shifts,
                            shift=shift, relu=relu))
    for shifts, relu in (((0, 0, 0), False), ((1, 0, 2), True)):
        _eq(t_ops.qconcat_nhwc([_t(a), _t(b_), _t(c)], shifts, axis=-1,
                               relu=relu),
            r_ops.qconcat_nhwc([jnp.asarray(v) for v in (a, b_, c)], shifts,
                               axis=-1, relu=relu))


@pytest.mark.parametrize("window,stride,pads", [
    (2, 2, (0, 0, 0, 0)), (3, 2, (0, 0, 0, 0)), (3, 2, (1, 1, 1, 1)),
    (3, 1, (1, 1, 1, 1)), (7, 1, (0, 0, 0, 0)), (2, 2, (0, 1, 1, 0))])
def test_pools_match_oracles(window, stride, pads):
    rng = np.random.default_rng(window * 10 + stride)
    x = _i8(rng, (2, 7, 7, 5))
    xj = jnp.asarray(x)
    _eq(t_ops.maxpool2d_nhwc(_t(x), window, stride, pads),
        r_ops.maxpool2d_nhwc(xj, window, stride, pads))
    _eq(t_ops.avgpool2d_nhwc(_t(x), window, stride, pads),
        r_ref.avgpool2d_ref(xj, window, stride, pads))
    xc = _t(x.transpose(0, 3, 1, 2))
    _eq(t_ops.maxpool2d_nchw(xc, window, stride, pads)
        .permute(0, 2, 3, 1).contiguous(),
        r_ops.maxpool2d_nhwc(xj, window, stride, pads))
    _eq(t_ops.avgpool2d_nchw(xc, window, stride, pads)
        .permute(0, 2, 3, 1).contiguous(),
        r_ref.avgpool2d_ref(xj, window, stride, pads))
    if not any(pads):
        _eq(t_ref.maxpool2d_ref(_t(x), window, stride),
            r_ref.maxpool2d_ref(xj, window, stride))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("hw,window,stride,pads", [
    (56, 56, 1, (0, 0, 0, 0)),           # mobilenet_tiny@224's GAP
    (7, 7, 1, (0, 0, 0, 0)),             # ResNet-18's GAP
    (20, 9, 2, (2, 3, 1, 4)),            # wide, padded, asymmetric
    (112, 3, 2, (1, 1, 1, 1))])          # ResNet-18's stem max-pool
def test_pools_reduce_a_window_in_a_few_ops(hw, window, stride, pads):
    """Each pool reduces its windows in one torch call, so the ops it
    issues do not grow with the window: a 56x56 global average pool
    issued 3,136 adds when it summed strided slices one by one, 95 % of
    a mobilenet_tiny@224 forward on the card."""
    x = _i8(np.random.default_rng(hw + window), (2, hw, hw, 6))
    xj = jnp.asarray(x)
    for t_pool, r_pool in ((t_ops.avgpool2d_nhwc, r_ref.avgpool2d_ref),
                           (t_ops.maxpool2d_nhwc, r_ops.maxpool2d_nhwc)):
        count = _CountOps()
        with count:
            got = t_pool(_t(x), window, stride, pads)
        assert count.n <= 32, count.n
        assert got.is_contiguous()
        _eq(got, r_pool(xj, window, stride, pads))


@pytest.mark.parametrize("c,hw,window,stride", [(1, 5, 3, 3), (33, 9, 3, 2),
                                                (130, 13, 2, 2)])
def test_pools_stay_in_integers_off_torch_pooling_kernels(monkeypatch, c, hw,
                                                         window, stride):
    """PyTorch's float64 CUDA max-pool faults with a misaligned address
    at some shapes (seen on the H100, one-channel inputs among them), so
    the plain pools reduce int8/int32 window views and call no torch
    pooling kernel."""
    def refuse(*a, **kw):
        raise AssertionError("a torch pooling kernel was called")
    for name in ("max_pool2d", "avg_pool2d"):
        monkeypatch.setattr(t_ref.F, name, refuse)
    x = _i8(np.random.default_rng(c), (3, hw, hw, c))
    w = _i8(np.random.default_rng(c + 1), (1, 1, c, 4))
    xj = jnp.asarray(x)
    _eq(t_ops.maxpool2d_nhwc(_t(x), window, stride),
        r_ops.maxpool2d_nhwc(xj, window, stride))
    _eq(t_ops.avgpool2d_nhwc(_t(x), window, stride, (1, 0, 1, 2)),
        r_ref.avgpool2d_ref(xj, window, stride, (1, 0, 1, 2)))
    _eq(t_qconv.qconv2d_plain(_t(x), _t(w), None, shift=3,
                              pool=(window, stride)),
        r_ref.qconv2d_ref(xj, jnp.asarray(w), None, (1, 1), 3, True,
                          (window, stride)))


def test_shift_arguments_are_range_checked():
    with pytest.raises(ValueError, match=r"\[0, 31\]"):
        t_qgemm.shift_args(32, 4, "cpu")
    with pytest.raises(ValueError, match=r"\[0, 31\]"):
        t_qgemm.shift_args((1, -1), 2, "cpu")
    with pytest.raises(ValueError, match="3 per-lane shifts for 4"):
        t_qgemm.shift_args((1, 2, 3), 4, "cpu")
    s, vec = t_qgemm.shift_args((1, 2, 31), 3, "cpu")
    assert s == 0 and vec.dtype == torch.int32 and vec.tolist() == [1, 2, 31]

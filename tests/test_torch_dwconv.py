"""The port's depthwise and ragged-grouped convs against the JAX
package's oracles, bit for bit.

The same seeded numpy inputs go through the port's
``ops.qconv2d_nhwc`` on the CPU (the wrappers' plain versions, which
``chip_smoke.py`` holds the CUDA kernels to on the card) and through the
reference's ``ref.qconv2d_ref`` (``groups=``), ``qadd_ref`` and
``qconcat_ref``, composed the way the reference's fused epilogues are
defined.  The reference's own Pallas depthwise and grouped kernels do
not run under jax 0.9 (``pl.unblocked`` is gone), so its oracles are the
reference side.  The wrappers' operand checks, which guard the CUDA
launches, run here on ``meta`` tensors: every check comes before the
device check.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro_torch.core.synthesis import CNN2Gate
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import qconv as t_qconv
from repro_torch.kernels import qgemm as t_qgemm
from repro_torch.kernels import ref as t_ref
from repro_torch.models import cnn as t_cnn


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _eq(t, r):
    np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    assert t.numpy().dtype == np.asarray(r).dtype


def _shift(rng, k_depth, cout, per_lane):
    """A requant shift that keeps random int8 sums of depth ``k_depth``
    mostly inside int8; per-lane: a vector scattered around it."""
    base = max(0, int(np.log2(74 * 74 * np.sqrt(k_depth) / 40)))
    if not per_lane:
        return base
    return tuple(int(v) for v in rng.integers(max(0, base - 2), base + 3,
                                              cout))


def _ref_conv(x, w, b, strides, shift, relu, pool, groups, pad=1):
    """The reference oracle on the pre-padded input."""
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    s = jnp.asarray(shift, jnp.int32) if isinstance(shift, tuple) else shift
    return r_ref.qconv2d_ref(jnp.asarray(xp), jnp.asarray(w), jnp.asarray(b),
                             strides, s, relu, pool, groups)


def _dw_case(seed, cin, m, per_lane):
    rng = np.random.default_rng(seed)
    cout = m * cin
    x = _i8(rng, (2, 13, 13, cin))
    w = _i8(rng, (3, 3, 1, cout))
    b = rng.integers(-2 ** 12, 2 ** 12, cout).astype(np.int32)
    return x, w, b, _shift(rng, 9, cout, per_lane)


# ------------------------------------------------------------- depthwise

@pytest.mark.parametrize("pool", [None, (2, 2), (3, 2)],
                         ids=["nopool", "pool2s2", "pool3s2"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_depthwise_matches_oracle(m, stride, pool):
    """Multiplier m (output channel c reads input c // m), strides 1 and
    2, fused pools, per-tensor and per-lane shifts, with and without
    ReLU."""
    for per_lane in (False, True):
        x, w, b, shift = _dw_case(100 * m + 10 * stride + per_lane, 6, m,
                                  per_lane)
        for relu in (True, False):
            want = _ref_conv(x, w, b, (stride, stride), shift, relu, pool,
                             groups=6)
            got = t_ops.qconv2d_nhwc(_t(x), _t(w), _t(b),
                                     strides=(stride, stride),
                                     pads=(1, 1, 1, 1), shift=shift,
                                     relu=relu, pool=pool, groups=6)
            _eq(got, want)


@pytest.mark.parametrize("pool", [None, (2, 2)], ids=["nopool", "pool2s2"])
@pytest.mark.parametrize("per_lane", [False, True],
                         ids=["per_tensor", "per_lane"])
def test_depthwise_130_channels_with_skip(per_lane, pool):
    """A ragged channel count and the fused residual skip == the
    reference's conv, add and pool oracles in sequence."""
    x, w, b, shift = _dw_case(130 + per_lane, 130, 1, per_lane)
    skip = _i8(np.random.default_rng(7), (2, 13, 13, 130))
    conv = _ref_conv(x, w, b, (1, 1), shift, False, None, groups=130)
    for skip_shifts, merge_shift, merge_relu in (((0, 0), 0, False),
                                                 ((2, 0), 1, True),
                                                 ((0, 1), 3, True)):
        want = r_ref.qadd_ref([conv, jnp.asarray(skip)], skip_shifts,
                              merge_shift, merge_relu)
        if pool is not None:
            want = r_ref.maxpool2d_ref(want, *pool)
        got = t_ops.qconv2d_nhwc(_t(x), _t(w), _t(b), pads=(1, 1, 1, 1),
                                 shift=shift, relu=False, pool=pool,
                                 groups=130, skip=_t(skip),
                                 skip_shifts=skip_shifts,
                                 merge_shift=merge_shift,
                                 merge_relu=merge_relu)
        _eq(got, want)


@pytest.mark.parametrize("pool", [None, (2, 2)], ids=["nopool", "pool2s2"])
@pytest.mark.parametrize("dw_first", [True, False],
                         ids=["dw_at_0", "dw_at_offset"])
def test_depthwise_writes_its_concat_slice_only(dw_first, pool):
    """A depthwise producer (m = 2) and a dense one share one merge
    buffer: each writes only its own channels, and the finished buffer
    == the reference's standalone Concat (+ pool) over both outputs."""
    rng = np.random.default_rng(31 + dw_first)
    cin, m, cdense = 4, 2, 6
    cdw = m * cin
    x = _i8(rng, (2, 11, 11, cin))
    wd, bd = _i8(rng, (3, 3, 1, cdw)), rng.integers(-999, 999, cdw)
    wc, bc = _i8(rng, (3, 3, cin, cdense)), rng.integers(-999, 999, cdense)
    bd, bc = bd.astype(np.int32), bc.astype(np.int32)
    ys = [_ref_conv(x, wd, bd, (1, 1), 4, False, None, groups=cin),
          _ref_conv(x, wc, bc, (1, 1), 6, False, None, groups=1)]
    shifts = (1, 0)
    order = [0, 1] if dw_first else [1, 0]
    want = r_ref.qconcat_ref([ys[i] for i in order],
                             [shifts[i] for i in order], axis=-1, relu=True)
    if pool is not None:
        want = r_ref.maxpool2d_ref(want, *pool)
    want = np.asarray(want)
    off = {0: 0, 1: cdw} if dw_first else {0: cdense, 1: 0}
    buf = torch.full(want.shape, 77, dtype=torch.int8)
    common = dict(pads=(1, 1, 1, 1), relu=False, pool=pool, out_buf=buf,
                  concat_relu=True)
    out = t_ops.qconv2d_nhwc(_t(x), _t(wd), _t(bd), shift=4, groups=cin,
                             out_off=off[0], concat_shift=shifts[0], **common)
    assert out is buf                       # the caller's buffer, in place
    other = slice(off[1], off[1] + cdense)      # the dense producer's
    assert bool((buf[..., other] == 77).all())
    t_ops.qconv2d_nhwc(_t(x), _t(wc), _t(bc), shift=6, out_off=off[1],
                       concat_shift=shifts[1], **common)
    _eq(buf, want)


# -------------------------------------------------------------- grouped

@pytest.mark.parametrize("per_lane", [False, True],
                         ids=["per_tensor", "per_lane"])
@pytest.mark.parametrize("pool", [None, (2, 2), (3, 2)],
                         ids=["nopool", "pool2s2", "pool3s2"])
@pytest.mark.parametrize("groups,cin,cout", [(2, 8, 12), (3, 9, 6)],
                         ids=["g2_8_12", "g3_9_6"])
def test_ragged_grouped_matches_oracle(groups, cin, cout, pool, per_lane):
    rng = np.random.default_rng(groups * 100 + cin + per_lane)
    x = _i8(rng, (2, 12, 12, cin))
    w = _i8(rng, (3, 3, cin // groups, cout))
    b = rng.integers(-2 ** 12, 2 ** 12, cout).astype(np.int32)
    shift = _shift(rng, 9 * cin // groups, cout, per_lane)
    for stride in (1, 2):
        want = _ref_conv(x, w, b, (stride, stride), shift, True, pool,
                         groups=groups)
        got = t_ops.qconv2d_nhwc(_t(x), _t(w), _t(b),
                                 strides=(stride, stride), pads=(1, 1, 1, 1),
                                 shift=shift, relu=True, pool=pool,
                                 groups=groups)
        _eq(got, want)


def test_grouped_conv_takes_no_merge():
    x, w = torch.zeros((1, 6, 6, 8), dtype=torch.int8), \
        torch.zeros((3, 3, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="merge fusion"):
        t_ops.qconv2d_nhwc(x, w, None, groups=2,
                           skip=torch.zeros((1, 4, 4, 8), dtype=torch.int8))


# ----------------------------------------------- pads on every route

#: groups, Cin, Cout of a conv on each of ``ops.conv_route``'s routes
ROUTES = {"dense": (1, 8, 12), "depthwise": (8, 8, 16), "grouped": (2, 8, 12)}


@pytest.mark.parametrize("trials", [None, 3], ids=["single", "trials"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_every_route_takes_the_unpadded_input_and_its_pads(route, trials):
    """``ops.qconv2d_nhwc`` hands each route's wrapper the unpadded input
    and the (asymmetric) pads, single and trial form: the result equals
    the plain version over the same unpadded input and pads, shape
    included (a second pad would widen it)."""
    groups, cin, cout = ROUTES[route]
    rng = np.random.default_rng(len(route) + (trials or 0))
    lead = () if trials is None else (trials,)
    x = _t(_i8(rng, ((trials or 1) * 2, 9, 11, cin)))
    w = _t(_i8(rng, lead + (3, 3, cin // groups, cout)))
    b = _t(rng.integers(-999, 999, cout).astype(np.int32))
    assert t_ops.conv_route(groups, cin, w.shape) == route
    kw = dict(strides=(1, 2), pads=(1, 2, 0, 1), shift=5, relu=True,
              pool=(2, 2), groups=groups)
    plain = t_qconv.qconv2d_plain if trials is None \
        else t_ref.qconv2d_trials_ref
    want = plain(x, w, b, **kw)
    assert want.shape == ((trials or 1) * 2, 4, 3, cout)
    assert torch.equal(t_ops.qconv2d_nhwc(x, w, b, **kw), want)


@pytest.mark.parametrize("trials", [None, 3], ids=["single", "trials"])
def test_the_depthwise_wrapper_pads_its_input(trials):
    """``qdwconv2d(x, pads=p)`` == ``qdwconv2d(ref.pad_nhwc(x, p))``, and
    the same for its trial form."""
    rng = np.random.default_rng(41)
    lead = () if trials is None else (trials,)
    x = _t(_i8(rng, ((trials or 1) * 2, 9, 11, 8)))
    w = _t(_i8(rng, lead + (3, 3, 1, 16)))
    b = _t(rng.integers(-999, 999, 16).astype(np.int32))
    fn = t_qconv.qdwconv2d if trials is None else t_qconv.qdwconv2d_trials
    kw = dict(strides=(2, 1), shift=4, pool=(2, 2))
    p = (1, 2, 0, 1)
    assert torch.equal(fn(x, w, b, pads=p, **kw),
                       fn(t_ref.pad_nhwc(x, p), w, b, **kw))


# ------------------------------------------------ the wrappers' checks

def _meta(shape, dtype=torch.int8):
    return torch.empty(shape, dtype=dtype, device="meta")


_X = (1, 8, 8, 8)
BAD_OPERANDS = [
    # (wrapper, x, w, bias, kwargs, error, message)
    ("dw", _X, (3, 3, 1, 12), None, {}, ValueError, "depthwise weight"),
    ("dw", _X, (3, 3, 2, 16), None, {}, ValueError, "depthwise weight"),
    ("dw", _X, (3, 3, 1, 8), None, dict(shift=32), ValueError,
     r"\[0, 31\]"),
    ("dw", _X, (3, 3, 1, 8), None, dict(merge_shift=-1), ValueError,
     r"\[0, 31\]"),
    ("dw", _X, (3, 3, 1, 8), (7,), {}, ValueError, "bias"),
    ("dw", _X, (3, 3, 1, 8), None, dict(pool=(9, 9)), ValueError, "pool"),
    ("dw", _X, (3, 3, 1, 8), None, dict(out_off=4), ValueError,
     "cannot hold"),
    ("g", _X, (3, 3, 4, 6), None, dict(groups=3), ValueError, "3 groups"),
    ("g", _X, (3, 3, 4, 7), None, dict(groups=2), ValueError, "2 groups"),
    ("g", _X, (3, 3, 3, 8), None, dict(groups=2), ValueError, "2 groups"),
    ("g", _X, (9, 9, 4, 8), None, dict(groups=2), ValueError, "window"),
    ("g", _X, (3, 3, 4, 8), None, dict(groups=2, shift=(1,) * 7),
     ValueError, "7 per-lane shifts"),
]


@pytest.mark.parametrize("case", BAD_OPERANDS,
                         ids=[f"{c[0]}-{c[-1]}-{i}"
                              for i, c in enumerate(BAD_OPERANDS)])
def test_wrappers_reject_bad_operands_before_the_device(case):
    kind, xs, ws, bs, kw, err, msg = case
    b = _meta(bs, torch.int32) if bs else None
    if "out_off" in kw:
        kw = dict(kw, out_buf=_meta((1, 6, 6, 10)))
    fn = t_qconv.qdwconv2d if kind == "dw" else t_qconv.qgconv2d
    with pytest.raises(err, match=msg):
        fn(_meta(xs), _meta(ws), b, **kw)


def test_wrappers_reject_wrong_types_and_layouts():
    with pytest.raises(TypeError, match="int8"):
        t_qconv.qdwconv2d(_meta(_X, torch.int32), _meta((3, 3, 1, 8)), None)
    with pytest.raises(TypeError, match="int8"):
        t_qconv.qgconv2d(_meta(_X), _meta((3, 3, 4, 8), torch.float32),
                         None, groups=2)
    x = _meta((1, 8, 8, 16))[..., ::2]             # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        t_qconv.qdwconv2d(x, _meta((3, 3, 1, 8)), None)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        t_qconv.qdwconv2d(_meta(_X), _meta((3, 3, 1, 16)), None,
                          out_buf=_meta((1, 6, 6, 20)), out_off=4)


# ----------------------------------- the executor's path through the ops

@pytest.fixture
def recorded(monkeypatch):
    """Record which wrapper each executor stage calls (the plain
    versions still run underneath)."""
    calls = []

    def wrap(mod, name):
        fn = getattr(mod, name)

        def rec(*a, **kw):
            calls.append((name, kw.get("out_buf") is not None,
                          kw.get("skip") is not None, kw.get("pool")))
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, rec)

    for name in ("qconv2d", "qdwconv2d", "qgconv2d"):
        wrap(t_qconv, name)
    wrap(t_qgemm, "qgemm")
    return calls


def _names(calls):
    return sorted(c[0] + ("_into" if c[1] else "") for c in calls)


def _run_cpu(graph, per_channel=False):
    gate = CNN2Gate.from_graph(graph, device="cpu")
    x = np.random.default_rng(3).standard_normal(
        graph.inputs[0].shape).astype(np.float32)
    gate.calibrate_quantization(x, per_channel=per_channel)
    return gate, gate.build()(x)


def test_mobilenet_forward_takes_four_dense_three_depthwise_one_gemm(
        recorded):
    _run_cpu(t_cnn.mobilenet_tiny(batch=1, in_hw=32), per_channel=True)
    assert _names(recorded) == ["qconv2d"] * 4 + ["qdwconv2d"] * 3 \
        + ["qgemm"]


def test_two_tower_graph_runs_its_grouped_convs_on_qgconv2d(recorded):
    b = t_cnn.GraphBuilder("two_tower", (1, 3, 40, 40), 5)
    b.conv(8, 5, stride=2, pad=2).maxpool(3, 2)
    b.conv(12, 3, pad=1, group=2).maxpool(3, 2)
    b.conv(8, 3, pad=1, group=2)
    b.fc(6, relu=False, softmax=True)
    _run_cpu(b.build())
    assert _names(recorded) == ["qconv2d", "qgconv2d", "qgconv2d", "qgemm"]
    pools = [c[3] for c in recorded if c[0] == "qgconv2d"]
    assert pools == [(3, 2), None]


def test_depthwise_producers_take_the_fused_skip_and_concat(recorded):
    b = t_cnn.GraphBuilder("dw_paths", (1, 3, 12, 12), 4)
    b.conv(8, 3, pad=1)
    split = b.tap()
    b.dwconv(3, pad=1, relu=False)
    left = b.tap()
    b.from_tap(split).dwconv(3, pad=1, relu=False)
    b.add_from(left, relu=True)
    merged = b.tap()
    b.conv(16, 3, pad=1, group=8, relu=False)      # depthwise, m = 2
    dw2 = b.tap()
    b.from_tap(merged).conv(6, 3, pad=1)
    b.concat_from(dw2)
    b.global_avgpool().fc(3, relu=False, softmax=True)
    gate, y = _run_cpu(b.build())
    assert bool(torch.isfinite(y).all())
    dw = [c for c in recorded if c[0] == "qdwconv2d"]
    assert [(c[1], c[2]) for c in dw] == [(False, False), (False, True),
                                          (True, False)]
    assert _names(recorded).count("qconv2d_into") == 1

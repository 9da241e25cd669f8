"""The port's SSD scan against the JAX package's.

The same inputs, made from a seed with numpy, go through the JAX
package's Pallas kernel ``repro.kernels.ssd_scan.ssd_scan(...,
interpret=True)``, its jnp ``models.mamba2.ssd_chunked`` and its
sequential oracle ``kernels.ref.ssd_ref``, and through the port's plain
version and ``ops.ssd_scan`` on the CPU (which runs the plain version).

Tolerances: where the port replays the chunked arithmetic of the JAX
function it is compared with (the same chunk, float32 throughout),
``rtol = atol = 1e-5``, as in ``test_torch_lm.py``: the einsums and the
cumulative sums take other orders.  Against the sequential oracle, and
across chunk lengths, the JAX package's own tolerance for the chunked
decomposition, ``atol = 1e-4, rtol = 1e-3`` (``tests/test_kernels.py``):
there the sums themselves are grouped differently.  bfloat16 outputs:
within one bf16 ulp plus 2e-6 of the JAX kernel's (both compute in
float32 and round once; the 2e-6 covers float32 rounding on outputs that
cancel to near 0, where one ulp is smaller).

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``; here its wrapper's operand checks run on ``meta``
tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro.kernels.ssd_scan import ssd_scan as r_ssd_scan
from repro.models import mamba2 as r_mamba2
from repro_torch.kernels import ops, ref as t_ref
from repro_torch.kernels import ssd_scan as t_ssd

CHUNKED = dict(rtol=1e-5, atol=1e-5)
DECOMPOSED = dict(rtol=1e-3, atol=1e-4)

# (b, l, h, p, g, n, chunk): the three shapes of tests/test_kernels.py
SHAPES = [(1, 64, 2, 16, 1, 16, 16),
          (2, 100, 4, 32, 2, 32, 32),   # ragged chunks, grouped B/C
          (1, 128, 8, 64, 1, 64, 64)]


def _inputs(b, l, h, p, g, n, seed):
    """x, dt, a, b, c, d, init_state as float32 numpy, with the JAX
    package's test distributions."""
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((b, l, h, p)) * 0.5).astype(np.float32),
        rng.uniform(0.001, 0.1, (b, l, h)).astype(np.float32),
        (-rng.uniform(0.5, 2.0, (h,))).astype(np.float32),
        (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32),
        (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32),
        rng.standard_normal((h,)).astype(np.float32),
        rng.standard_normal((b, h, p, n)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_matches_the_jax_kernel(shape):
    *dims, chunk = shape
    x, dt, a, b, c, d, _ = _inputs(*dims, seed=sum(dims))
    want = np.asarray(r_ssd_scan(*_j(x, dt, a, b, c, d), chunk=chunk,
                                 interpret=True))
    got = t_ssd.ssd_scan_plain(*_t(x, dt, a, b, c, d), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **CHUNKED)
    # on a CPU tensor the op runs the plain version, and counts nothing
    ops.reset_launch_counts()
    got = ops.ssd_scan(*_t(x, dt, a, b, c, d), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **CHUNKED)
    assert ops.launch_counts()["ssd_scan"] == 0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_matches_the_sequential_oracles(shape):
    *dims, chunk = shape
    x, dt, a, b, c, d, s0 = _inputs(*dims, seed=sum(dims) + 1)
    want_y, want_s = r_ref.ssd_ref(*_j(x, dt, a, b, c, d, s0))
    ref_y, ref_s = t_ref.ssd_ref(*_t(x, dt, a, b, c, d, s0))
    np.testing.assert_allclose(ref_y.numpy(), np.asarray(want_y), **CHUNKED)
    np.testing.assert_allclose(ref_s.numpy(), np.asarray(want_s), **CHUNKED)
    y, s = t_ssd.ssd_scan_plain(*_t(x, dt, a, b, c, d), chunk=chunk,
                                init_state=torch.from_numpy(s0),
                                return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **DECOMPOSED)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **DECOMPOSED)


@pytest.mark.parametrize("shape", SHAPES + [(2, 37, 6, 16, 3, 8, 16),
                                            (1, 1, 4, 16, 1, 16, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_state_extensions_match_ssd_chunked(shape):
    """``init_state`` in and the final state out, as the JAX package's
    ``ssd_chunked`` takes and returns them; ``d`` is left to the caller
    there, so it is None here.  The last two shapes: a ragged L with
    G = 3, and a decode step (L = 1)."""
    *dims, chunk = shape
    x, dt, a, b, c, _, s0 = _inputs(*dims, seed=sum(dims) + 2)
    for init in (None, s0):
        want_y, want_s = r_mamba2.ssd_chunked(
            *_j(x, dt, a, b, c), chunk,
            None if init is None else jnp.asarray(init))
        y, s = ops.ssd_scan(*_t(x, dt, a, b, c), chunk=chunk,
                            init_state=(None if init is None
                                        else torch.from_numpy(init)),
                            return_state=True)
        assert y.dtype == torch.float32 and s.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **CHUNKED)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **CHUNKED)


def test_init_state_is_not_written():
    x, dt, a, b, c, _, s0 = _inputs(1, 20, 2, 8, 1, 8, seed=4)
    init = torch.from_numpy(s0.copy())
    t_ssd.ssd_scan_plain(*_t(x, dt, a, b, c), chunk=8, init_state=init,
                         return_state=True)
    np.testing.assert_array_equal(init.numpy(), s0)


def test_chunk_invariance():
    """Different chunk lengths agree, with a state carried in and out:
    the decomposition is exact (the CUDA kernel's 64-position tiles rely
    on it)."""
    x, dt, a, b, c, d, s0 = _inputs(1, 96, 2, 16, 1, 16, seed=5)
    outs = [t_ssd.ssd_scan_plain(*_t(x, dt, a, b, c, d), chunk=chunk,
                                 init_state=torch.from_numpy(s0),
                                 return_state=True)
            for chunk in (16, 48, 64, 96, 200)]
    for y, s in outs[1:]:
        np.testing.assert_allclose(y.numpy(), outs[0][0].numpy(),
                                   **DECOMPOSED)
        np.testing.assert_allclose(s.numpy(), outs[0][1].numpy(),
                                   **DECOMPOSED)


def test_float64_inputs_compute_in_float64():
    """The plain version follows float64 inputs (chip_smoke's yardstick
    for the float32 versions); float32 and bf16 inputs compute in
    float32."""
    x, dt, a, b, c, d, s0 = _inputs(1, 40, 2, 16, 1, 16, seed=9)
    y32, s32 = t_ssd.ssd_scan_plain(*_t(x, dt, a, b, c, d), chunk=16,
                                    init_state=torch.from_numpy(s0),
                                    return_state=True)
    y64, s64 = t_ssd.ssd_scan_plain(
        *(t.double() for t in _t(x, dt, a, b, c, d)), chunk=16,
        init_state=torch.from_numpy(s0).double(), return_state=True)
    assert y64.dtype == s64.dtype == torch.float64
    assert y32.dtype == s32.dtype == torch.float32
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), **CHUNKED)
    np.testing.assert_allclose(s32.numpy(), s64.numpy(), **CHUNKED)
    assert not np.array_equal(y32.double().numpy(), y64.numpy())


def test_split_sequence_carries_the_state():
    """Two calls, the second started from the first's final state, give
    the one call's output: what decode relies on."""
    x, dt, a, b, c, d, _ = _inputs(2, 50, 4, 16, 2, 16, seed=6)
    tx, tdt, ta, tb, tc, td = _t(x, dt, a, b, c, d)
    y, s = ops.ssd_scan(tx, tdt, ta, tb, tc, td, chunk=16,
                        return_state=True)
    y1, s1 = ops.ssd_scan(tx[:, :31], tdt[:, :31], ta, tb[:, :31],
                          tc[:, :31], td, chunk=16, return_state=True)
    y2, s2 = ops.ssd_scan(tx[:, 31:], tdt[:, 31:], ta, tb[:, 31:],
                          tc[:, 31:], td, chunk=16, init_state=s1,
                          return_state=True)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               **DECOMPOSED)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), **DECOMPOSED)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(
    map(str, s)))
def test_bf16_inputs_match_the_jax_kernel(shape):
    *dims, chunk = shape
    x, dt, a, b, c, d, _ = _inputs(*dims, seed=sum(dims) + 7)
    jx, jb, jc = (jnp.asarray(v).astype(jnp.bfloat16) for v in (x, b, c))
    want = np.asarray(r_ssd_scan(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc,
                                 jnp.asarray(d), chunk=chunk,
                                 interpret=True).astype(jnp.float32))
    tx, tb, tc = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, b, c))
    got = t_ssd.ssd_scan_plain(tx, torch.from_numpy(dt), torch.from_numpy(a),
                               tb, tc, torch.from_numpy(d), chunk=chunk)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp + 2e-6), np.abs(got - want).max()


# ------------------------------------------------------ operand checks

def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _operands(b=2, l=9, h=4, p=16, g=2, n=16, dtype=torch.bfloat16):
    return dict(x=_meta((b, l, h, p), dtype), dt=_meta((b, l, h)),
                a=_meta((h,)), b=_meta((b, l, g, n), dtype),
                c=_meta((b, l, g, n), dtype))


def _call(ops_kw, **kw):
    o = ops_kw
    return t_ssd.ssd_scan(o["x"], o["dt"], o["a"], o["b"], o["c"], **kw)


BAD = [
    ("heads_not_a_group_multiple", dict(g=3), {}, ValueError, "B/C groups"),
    ("state_too_wide", dict(n=129), {}, ValueError, "state size 129"),
    ("dt_shape", None, dict(dt=_meta((2, 8, 4))), ValueError, "do not match"),
    ("a_shape", None, dict(a=_meta((3,))), ValueError, "do not match"),
    ("bc_shapes_differ", None, dict(c=_meta((2, 9, 2, 8), torch.bfloat16)),
     ValueError, r"b, c \(B, L, G, N\)"),
    ("x_rank", None, dict(x=_meta((2, 9, 64), torch.bfloat16)), ValueError,
     r"x \(B, L, H, P\)"),
    ("x_float16", dict(dtype=torch.float16), {}, TypeError,
     "float32 or bfloat16"),
    ("bc_dtype_differs", None, dict(b=_meta((2, 9, 2, 16))), TypeError,
     "of one dtype"),
    ("dt_bf16", None, dict(dt=_meta((2, 9, 4), torch.bfloat16)), TypeError,
     "float32 dt"),
    ("empty_sequence", dict(l=0), {}, ValueError, "empty x"),
]


@pytest.mark.parametrize("name,dims,swap,exc,match", BAD,
                         ids=[c[0] for c in BAD])
def test_operand_checks_run_before_the_device_check(name, dims, swap, exc,
                                                    match):
    o = _operands(**(dims or {}))
    o.update(swap)
    with pytest.raises(exc, match=match):
        _call(o)


def test_optional_operand_checks_and_the_device_check():
    o = _operands()
    with pytest.raises(ValueError, match=r"d \(3,\)"):
        _call(o, d=_meta((3,)))
    with pytest.raises(ValueError, match="init_state"):
        _call(o, init_state=_meta((2, 4, 16, 8)))
    with pytest.raises(TypeError, match="float32 dt, a, d, init_state"):
        _call(o, init_state=_meta((2, 4, 16, 16), torch.bfloat16))
    x = _meta((2, 4, 9, 16), torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        t_ssd.ssd_scan(x, o["dt"], o["a"], o["b"], o["c"])
    # well-formed operands off the CPU and off CUDA: the device check
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        _call(o, d=_meta((4,)), init_state=_meta((2, 4, 16, 16)),
              return_state=True)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.ssd_scan(o["x"], o["dt"], o["a"], o["b"], o["c"])
    assert ops.launch_counts()["ssd_scan"] == 0



# ------------------------------------- the bf16 kernel's arithmetic, on the CPU

#: chip_smoke's SSD allowance against the plain version (``SSD_F32_TOL``:
#: the JAX package's chunked-vs-sequential tolerance), plus one bf16 ulp of
#: the plain output for a bf16 y.
SSD_F32_TOL = (1e-4, 1e-3)


def _kernel_chunk(chunk):
    """The chunk the bf16 kernel takes for the caller's: a multiple of 64
    in [64, 256]."""
    return min(256, max(64, chunk // 64 * 64))


def _round(v, how):
    """A float32 factor as the tensor cores see it: two bf16 halves
    (``"split"``, hi + lo), one bf16 (``"bf16"``) or TF32 (``"tf32"``, 10
    mantissa bits, to nearest)."""
    if how == "split":
        hi = v.bfloat16().float()
        return hi + (v - hi).bfloat16().float()
    if how == "bf16":
        return v.bfloat16().float()
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16_kernel_model(x, dt, a, b, c, d=None, *, chunk, init_state=None,
                       m="split", wx="split", s="split"):
    """The chunk-parallel bf16 CUDA kernel's arithmetic in plain torch: at
    the kernel's chunk, L = cumsum(dt a) added in order in float32; (a)
    each chunk's state (w o x)^T B with w = exp(L_last - L) dt; (b) the
    states entering the chunks, S <- exp(L_last) S + s_c; (c) y =
    exp(L_t) C S_in^T + (C B^T o exp(L_t - L_s) dt_s, masked before the
    exp) x (+ d x), rounded once to x's dtype; for s < a, a = 16 (t //
    16) the first of the 16 rows that one warp of the kernel holds, the
    decay is exp(L_t - L_a) (exp(L_a - L_s) dt_s), as the kernel forms
    it.  The float32 factors M,
    w o x and S_in go into the products as ``m``, ``wx``, ``s`` say
    (:func:`_round`); bf16 x, B, C and the float32 sums are exact here,
    as the tensor cores' products are."""
    bsz, length, h, p = x.shape
    n = b.shape[3]
    grp = h // b.shape[2]
    q = _kernel_chunk(chunk)
    nc = -(-length // q)
    pad = nc * q - length
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    xf = xf.reshape(bsz, nc, q, h, p)
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad)).reshape(
        bsz, nc, q, h)

    def heads(t):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return torch.repeat_interleave(t, grp, dim=2).reshape(bsz, nc, q, h,
                                                              n)
    bf, cf = heads(b), heads(c)
    step = dtf * a.float()
    ld = torch.empty_like(step)
    acc = torch.zeros_like(step[:, :, 0])
    for i in range(q):
        acc = acc + step[:, :, i]
        ld[:, :, i] = acc
    # (a)
    w = torch.exp(ld[:, :, -1:] - ld) * dtf
    s_own = torch.einsum("bcqhp,bcqhn->bchpn", _round(w[..., None] * xf, wx),
                         bf)
    # (b)
    state = (init_state.float() if init_state is not None
             else torch.zeros((bsz, h, p, n)))
    s_in = []
    for ci in range(nc):
        s_in.append(state)
        state = torch.exp(ld[:, :, -1])[:, ci, :, None, None] * state \
            + s_own[:, ci]
    # (c)
    idx = torch.arange(q)
    tri = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    diff = torch.where(tri, ld[:, :, :, None, :] - ld[:, :, None, :, :], 0.0)
    gmat = torch.where(tri, torch.exp(diff) * dtf[:, :, None, :, :], 0.0)
    ref = ld[:, :, idx // 16 * 16]                       # L_a of row t
    below = (idx[:, None] // 16 > idx[None, :] // 16)[None, None, :, :, None]
    factored = torch.exp(ld - ref)[:, :, :, None, :] * (
        torch.exp(torch.where(below, ref[:, :, :, None, :]
                              - ld[:, :, None, :, :], 0.0))
        * dtf[:, :, None, :, :])
    gmat = torch.where(below, factored, gmat)
    mm = torch.einsum("bcthn,bcshn->bctsh", cf, bf) * gmat
    y = torch.exp(ld)[..., None] * torch.einsum(
        "bcthn,bchpn->bcthp", cf, _round(torch.stack(s_in, 1), s))
    y = y + torch.einsum("bctsh,bcshp->bcthp", _round(mm, m), xf)
    y = y.reshape(bsz, nc * q, h, p)[:, :length]
    if d is not None:
        y = y + d.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), state


def _share_of_ssd_allowance(got, want):
    """chip_smoke's SSD rule: the largest |got - want| as a share of
    ``atol + rtol |want|`` (SSD_F32_TOL), plus one bf16 ulp of ``want``
    for a bf16 output (at most 1 passes)."""
    allowance = SSD_F32_TOL[0] + SSD_F32_TOL[1] * want.float().abs()
    if want.dtype == torch.bfloat16:
        allowance = allowance + torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp_min(1e-30))) - 7)
    return ((got.float() - want.float()).abs() / allowance).max().item()


# (b, l, h, p, g, n, chunk): a ragged L, G = 2, the chunks 16 and 256
MODEL_SHAPES = [(2, 100, 4, 16, 2, 32, 16),
                (1, 300, 4, 16, 2, 16, 256),
                (1, 129, 2, 8, 1, 24, 64)]


@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_model_gives_the_plain_versions_y_and_state(shape):
    *dims, chunk = shape
    x, dt, a, b, c, d, s0 = _inputs(*dims, seed=sum(dims) + 11)
    want_y, want_s = t_ssd.ssd_scan_plain(*_t(x, dt, a, b, c, d),
                                          chunk=chunk,
                                          init_state=torch.from_numpy(s0),
                                          return_state=True)
    y, s = _bf16_kernel_model(*_t(x, dt, a, b, c, d), chunk=chunk,
                              init_state=torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), **DECOMPOSED)
    np.testing.assert_allclose(s.numpy(), want_s.numpy(), **DECOMPOSED)


@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_model_matches_the_jax_functions(shape):
    """The same inputs through the JAX package's ``ssd_chunked`` (with an
    initial state, returning the final one) and its Pallas ``ssd_scan``
    in interpret mode (with d)."""
    *dims, chunk = shape
    x, dt, a, b, c, d, s0 = _inputs(*dims, seed=sum(dims) + 12)
    want_y, want_s = r_mamba2.ssd_chunked(*_j(x, dt, a, b, c), chunk,
                                          jnp.asarray(s0))
    y, s = _bf16_kernel_model(*_t(x, dt, a, b, c), chunk=chunk,
                              init_state=torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **DECOMPOSED)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **DECOMPOSED)
    want = np.asarray(r_ssd_scan(*_j(x, dt, a, b, c, d), chunk=chunk,
                                 interpret=True))
    y, _ = _bf16_kernel_model(*_t(x, dt, a, b, c, d), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), want, **DECOMPOSED)


def _strong_decay_inputs(seed, b=2, l=600, h=4, p=64, g=2, n=64):
    """bf16 x, B, C at chip_smoke's distributions (dt up to 1, a down to
    -16: decay exponents that reach hundreds within a 256-chunk), with an
    initial state."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy((rng.standard_normal((b, l, h, p)) * 0.5)
                             .astype(np.float32)).bfloat16(),
            torch.from_numpy(rng.uniform(0.001, 1.0, (b, l, h))
                             .astype(np.float32)),
            torch.from_numpy(-rng.uniform(0.5, 16.0, (h,)).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((b, l, g, n)) * 0.3)
                             .astype(np.float32)).bfloat16(),
            torch.from_numpy((rng.standard_normal((b, l, g, n)) * 0.3)
                             .astype(np.float32)).bfloat16(),
            torch.from_numpy(rng.standard_normal((b, h, p, n))
                             .astype(np.float32)))


def _model_share(seed, **rounding):
    """The model's largest share of the SSD allowance against the plain
    version, over y and the final state, at chunk 256."""
    x, dt, a, b, c, s0 = _strong_decay_inputs(seed)
    want_y, want_s = t_ssd.ssd_scan_plain(x, dt, a, b, c, chunk=256,
                                          init_state=s0, return_state=True)
    y, s = _bf16_kernel_model(x, dt, a, b, c, chunk=256, init_state=s0,
                              **rounding)
    return max(_share_of_ssd_allowance(y, want_y),
               _share_of_ssd_allowance(s, want_s))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_factors_stay_within_the_plain_versions_allowance(seed):
    """M = C B^T o decay, w o x and S_in, each as two bf16 halves: within
    one bf16 ulp plus the float32 allowance of the plain version (about
    0.87 of it: a one-ulp flip)."""
    assert _model_share(seed) <= 1


@pytest.mark.parametrize("factor", ["m", "wx", "s"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_bf16_factor_misses_the_plain_versions_allowance(seed, factor):
    """Why the kernel splits every float32 factor: any one of them rounded
    once to bf16 carries 2^-9 of relative error into outputs that cancel,
    2-17x the allowance at these inputs."""
    assert _model_share(seed, **{factor: "bf16"}) > 1


@pytest.mark.parametrize("seed", [0, 1])
def test_a_tf32_m_misses_the_plain_versions_allowance(seed):
    """Nor would TF32 do for M (10 mantissa bits): 1.75-2.2x the allowance
    at these inputs (about 0.95-1.1x at others)."""
    assert _model_share(seed, m="tf32") > 1


def test_state_out_may_be_the_initial_state():
    """``state_out`` receives the final state in place, and may alias
    ``init_state`` (the kernel reads each element before writing it)."""
    x, dt, a, b, c, d, s0 = _inputs(2, 70, 4, 16, 2, 16, seed=13)
    want_y, want_s = ops.ssd_scan(*_t(x, dt, a, b, c, d), chunk=32,
                                  init_state=torch.from_numpy(s0),
                                  return_state=True)
    state = torch.from_numpy(s0.copy())
    y, s = t_ssd.ssd_scan(*_t(x, dt, a, b, c, d), chunk=32,
                          init_state=state, state_out=state)
    assert s is state
    assert torch.equal(y, want_y) and torch.equal(state, want_s)
    with pytest.raises(ValueError, match="state_out"):
        _call(_operands(), state_out=_meta((2, 4, 16, 8)))

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


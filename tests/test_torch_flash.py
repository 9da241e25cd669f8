"""The port's flash attention against the JAX package's Pallas kernel.

The same inputs, made from a seed with numpy, go through
``repro.kernels.flash_attention.flash_attention(..., interpret=True)``
and through the port's plain version and ``ops.flash_attention`` on the
CPU (which runs the plain version).  Tolerances: float32 ``atol = rtol =
2e-5`` (both compute in float32; the blocked sums and exponentials take
other orders and libraries); bfloat16 within one bf16 ulp of the JAX
result (both compute in float32 and round once to bf16, so they differ
only where the float32 values straddle a rounding boundary).

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``; here its wrapper's operand checks run on ``meta``
tensors, and a plain-torch model of its bf16 rounding (P multiplied into
V as two bf16 halves) is held to chip_smoke's bf16 allowance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as r_flash
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ops, ref as t_ref

# (name, B, H, HKV, Sq, Skv, D, causal, window, q_offset)
CASES = [
    ("mha_square", 1, 2, 2, 16, 16, 16, True, None, 0),
    ("gqa2_sq_ne_skv", 2, 4, 2, 13, 37, 16, True, None, 24),
    ("gqa4_ragged_skv", 1, 8, 2, 40, 150, 16, True, None, 110),
    ("noncausal_ragged", 2, 4, 1, 9, 131, 16, False, None, 0),
    ("window", 1, 4, 2, 70, 300, 16, True, 33, 230),
    ("window_noncausal", 1, 2, 1, 20, 50, 16, False, 8, 10),
    ("d120_gqa4_window", 1, 8, 2, 33, 160, 120, True, 40, 127),
    ("d120_prefill", 1, 4, 4, 64, 64, 120, True, None, 0),
]


def _inputs(b, h, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


def _jax(q, k, v, dtype, **kw):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    out = r_flash.flash_attention(jnp.asarray(q).astype(jd),
                                  jnp.asarray(k).astype(jd),
                                  jnp.asarray(v).astype(jd),
                                  interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _torch(fn, q, k, v, dtype, **kw):
    td = getattr(torch, dtype)
    out = fn(*(torch.from_numpy(a).to(td) for a in (q, k, v)), **kw)
    assert out.dtype == td
    return out.float().numpy()


def _assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_version_matches_the_jax_kernel(case, dtype):
    _, b, h, hkv, sq, skv, d, causal, window, q_offset = case
    q, k, v = _inputs(b, h, hkv, sq, skv, d, seed=sq * skv + d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _jax(q, k, v, dtype, **kw)
    _assert_close(_torch(t_flash.flash_attention_plain, q, k, v, dtype, **kw),
                  want, dtype)
    # on a CPU tensor the op runs the plain version, and counts nothing
    ops.reset_launch_counts()
    _assert_close(_torch(ops.flash_attention, q, k, v, dtype, **kw), want,
                  dtype)
    assert ops.launch_counts()["flash_attention"] == 0


def test_fully_masked_rows_keep_the_jax_kernels_value():
    """A row that sees no key: the JAX kernel's ``-1e30`` sentinel weighs
    every entry 1, padding included, so the row is sum(v) / 128 (Skv = 20
    padded to the 128-key block), not 0 and not the oracle's mean."""
    q, k, v = _inputs(1, 1, 1, 8, 20, 16, seed=7)
    kw = dict(causal=True, window=4, q_offset=30)
    want = _jax(q, k, v, "float32", **kw)
    got = _torch(t_flash.flash_attention_plain, q, k, v, "float32", **kw)
    np.testing.assert_allclose(want, np.broadcast_to(
        v.sum(2, keepdims=True) / 128, want.shape), atol=1e-6)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert t_flash.masked_row_divisor(20) == 128
    assert t_flash.masked_row_divisor(300) == 384
    assert t_flash.masked_row_divisor(300, block_k=64) == 320
    # the oracle divides by Skv instead
    oracle = t_ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                 **kw).numpy()
    np.testing.assert_allclose(oracle, np.broadcast_to(
        v.mean(2, keepdims=True), oracle.shape), atol=1e-6)


def test_plain_version_matches_the_oracle_where_every_row_sees_a_key():
    q, k, v = _inputs(2, 6, 2, 30, 45, 16, seed=3)
    kw = dict(causal=True, window=12, q_offset=15)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(
        t_flash.flash_attention_plain(tq, tk, tv, **kw).numpy(),
        t_ref.attention_ref(tq, tk, tv, **kw).numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_flash_attention_passes_scale_on(dtype):
    """``ops.flash_attention(..., scale=)`` as the reference's
    ``ops.flash_attention`` takes it, against that op in interpret mode."""
    from repro.kernels import ops as r_ops
    q, k, v = _inputs(1, 2, 2, 8, 8, 16, seed=11)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = np.asarray(r_ops.flash_attention(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)), scale=0.5,
        interpret=True).astype(jnp.float32))
    got = _torch(ops.flash_attention, q, k, v, dtype, scale=0.5)
    _assert_close(got, want, dtype)
    default = _torch(ops.flash_attention, q, k, v, dtype)
    assert np.abs(got - default).max() > 0.1


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("q,k,v,kw,exc,match", [
    (_meta((1, 4, 8, 16), torch.float16), _meta((1, 2, 8, 16), torch.float16),
     _meta((1, 2, 8, 16), torch.float16), {}, TypeError, "float32 or bfloat16"),
    (_meta((1, 4, 8, 16)), _meta((1, 2, 8, 16), torch.float32),
     _meta((1, 2, 8, 16)), {}, TypeError, "of one dtype"),
    (_meta((4, 8, 16)), _meta((1, 2, 8, 16)), _meta((1, 2, 8, 16)), {},
     ValueError, r"\(B, H, Sq, D\)"),
    (_meta((1, 4, 8, 16)), _meta((1, 3, 8, 16)), _meta((1, 3, 8, 16)), {},
     ValueError, "does not group"),
    (_meta((1, 4, 8, 16)), _meta((1, 2, 8, 32)), _meta((1, 2, 8, 32)), {},
     ValueError, "does not group"),
    (_meta((1, 4, 8, 16)), _meta((1, 2, 8, 16)), _meta((1, 2, 9, 16)), {},
     ValueError, r"\(B, HKV, Skv, D\)"),
    (_meta((1, 4, 8, 160)), _meta((1, 2, 8, 160)), _meta((1, 2, 8, 160)), {},
     ValueError, "head dim 160"),
    (_meta((1, 4, 8, 16)), _meta((1, 2, 0, 16)), _meta((1, 2, 0, 16)), {},
     ValueError, "no keys"),
    (_meta((1, 4, 8, 16)), _meta((1, 2, 8, 16)), _meta((1, 2, 8, 16)),
     {"window": 0}, ValueError, "window must be"),
    (_meta((1, 4, 8, 16)), _meta((1, 2, 8, 16)), _meta((1, 2, 8, 16)),
     {"q_offset": -1}, ValueError, "q_offset"),
    (_meta((1, 8, 4, 16)).transpose(1, 2), _meta((1, 2, 8, 16)),
     _meta((1, 2, 8, 16)), {}, ValueError, "contiguous"),
    (_meta((1, 4, 8, 16)), _meta((1, 2, 8, 16)), _meta((1, 2, 8, 16)), {},
     ValueError, "runs on CUDA or the CPU"),
], ids=["fp16", "mixed_dtypes", "rank3_q", "heads_do_not_group",
        "d_mismatch", "k_v_shapes", "head_dim_over_128", "no_keys",
        "window_0", "negative_offset", "non_contiguous", "meta_device"])
def test_wrapper_checks_operands_before_the_device(q, k, v, kw, exc, match):
    """Every operand check comes before the device check, so it runs on
    ``meta`` tensors here; a well-formed meta operand reaches the device
    check and is refused there, never handed to the plain version."""
    with pytest.raises(exc, match=match):
        t_flash.flash_attention(q, k, v, **kw)
    assert t_flash.launches["flash_attention"] == 0


def _bf16_kernel_model(q, k, v, *, split, causal=True, q_offset=0, bk=128):
    """The bf16 CUDA kernel's rounding in plain torch: scores of bf16 q and
    k summed in float32 (wgmma's products are exact), the online softmax
    in float32 over 128-key tiles, and P·V with P rounded to bf16, either
    once (``split=False``) or as hi = bf16(p) plus lo = bf16(p - hi)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    pad = -skv % bk
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    qf = q.float().reshape(b, hkv, h // hkv, sq, d)
    qpos = q_offset + torch.arange(sq)[:, None]
    m = torch.full((b, hkv, h // hkv, sq, 1), t_flash.NEG_INF)
    l_ = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, h // hkv, sq, d))
    for k0 in range(0, skv + pad, bk):
        kb, vb = kp[:, :, None, k0:k0 + bk], vp[:, :, None, k0:k0 + bk]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * d ** -0.5
        kpos = k0 + torch.arange(bk)[None, :]
        mask = (kpos < skv) & ((kpos <= qpos) if causal else True)
        s = torch.where(mask, s, torch.full_like(s, t_flash.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_ = l_ * corr + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = torch.matmul(hi, vb)
        if split:
            pv = pv + torch.matmul((p - hi).bfloat16().float(), vb)
        acc = acc * corr + pv
        m = m_new
    return (acc / l_).reshape(b, h, sq, d).bfloat16()


def _share_of_bf16_allowance(got, want):
    """chip_smoke's bf16 rule: the largest |got - want| as a share of one
    bf16 ulp of ``want`` plus 2e-6 (at most 1 passes)."""
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return ((got.float() - want).abs() / (ulp + 2e-6)).max().item()


# (B, H, HKV, Sq, Skv, D, causal, q_offset)
SPLIT_CASES = [(1, 2, 1, 256, 256, 128, True, 0),
               (1, 4, 2, 200, 330, 64, True, 130),
               (2, 2, 1, 130, 130, 120, False, 0)]


def _split_inputs(seed, b, h, hkv, sq, skv, d):
    q, k, v = _inputs(b, h, hkv, sq, skv, d, seed=seed)
    return tuple(torch.from_numpy(a).bfloat16() for a in (q, k, v))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_p_stays_within_one_bf16_ulp_of_the_plain_version(seed):
    for b, h, hkv, sq, skv, d, causal, off in SPLIT_CASES:
        q, k, v = _split_inputs(seed, b, h, hkv, sq, skv, d)
        want = t_flash.flash_attention_plain(q, k, v, causal=causal,
                                             q_offset=off)
        got = _bf16_kernel_model(q, k, v, split=True, causal=causal,
                                 q_offset=off)
        assert _share_of_bf16_allowance(got, want) <= 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_bf16_p_misses_the_plain_versions_allowance(seed):
    """Why the kernel splits P: rounded once to bf16, P carries 2^-9 of
    relative error into outputs that cancel towards 0, far beyond one ulp
    + 2e-6 of them."""
    for b, h, hkv, sq, skv, d, causal, off in SPLIT_CASES:
        q, k, v = _split_inputs(seed, b, h, hkv, sq, skv, d)
        want = t_flash.flash_attention_plain(q, k, v, causal=causal,
                                             q_offset=off)
        got = _bf16_kernel_model(q, k, v, split=False, causal=causal,
                                 q_offset=off)
        assert _share_of_bf16_allowance(got, want) > 1

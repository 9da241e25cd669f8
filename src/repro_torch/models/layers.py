"""Transformer building blocks of the dense LMs, in PyTorch.

The counterpart of ``repro.models.layers`` less MoE.  Parameters live in
small ``nn.Module``s (:class:`Norm`, :class:`Attention`, :class:`MLP`)
whose attribute names are the JAX package's parameter keys, so a
parameter tree converts key for key; the math is in free functions with
the JAX package's names, taking those modules.  Parameters do not
require grad: this is the serving path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[cfg.dtype]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def fill_normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Fill ``p`` with normal(0, 1) * std drawn in float32 and cast to
    p's dtype, as the JAX package initialises its weights."""
    x = torch.randn(p.shape, generator=gen, device=p.device,
                    dtype=torch.float32)
    p.copy_((x * std).to(p.dtype))


# ------------------------------------------------------------------ norms

class Norm(nn.Module):
    """RMS norm (``scale``) or layer norm (``scale``, ``bias``), float32."""

    def __init__(self, cfg: ModelConfig, d: int, device=None):
        super().__init__()
        self.scale = _param((d,), torch.float32, device)
        self.bias = (_param((d,), torch.float32, device)
                     if cfg.norm_type == "layer" else None)


def init_norm(cfg: ModelConfig, d: int, device=None) -> Norm:
    p = Norm(cfg, d, device)
    p.scale.fill_(1.0)
    if p.bias is not None:
        p.bias.zero_()
    return p


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "layer":
        return layer_norm(x, p.scale, p.bias, cfg.norm_eps)
    return rms_norm(x, p.scale, cfg.norm_eps)


# ------------------------------------------------------------------- rope

def rope_frequencies(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of x (B, S, H, D) by angles (B, S, D/2)."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int] = (2, 3, 3)) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): positions (3, B, S) carry (temporal,
    height, width) ids; the D/2 frequency channels are split into three
    sections in the given proportions and each section rotates by its
    own position component."""
    hd = x.shape[-1]
    half = hd // 2
    total = sum(sections)
    bounds = [half * sections[0] // total,
              half * (sections[0] + sections[1]) // total]
    freqs = rope_frequencies(hd, theta, x.device)
    section_id = torch.zeros((half,), dtype=torch.long, device=x.device)
    section_id[bounds[0]:bounds[1]] = 1
    section_id[bounds[1]:] = 2
    pos = torch.movedim(positions, 0, -1).float()[..., section_id]
    return _rotate(x, pos * freqs)


# -------------------------------------------------------------- attention

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int], q_offset: int,
                      chunk: int) -> torch.Tensor:
    """Online-softmax attention over KV chunks, O(Sq * chunk) score
    memory; the same math as the flash kernel, in plain PyTorch."""
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = h // hkv
    scale = d ** -0.5
    nchunks = -(-skv // chunk)
    pad = nchunks * chunk - skv
    kp = F.pad(k, (0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, pad))
    qf = q.float()
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq, 1), -1e30, device=q.device)
    l_ = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for ci in range(nchunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        kr = torch.repeat_interleave(kp[:, :, sl], g, dim=1).float()
        vr = torch.repeat_interleave(vp[:, :, sl], g, dim=1).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
        kpos = ci * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = kpos < skv
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_ = l_ * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vr)
        m = m_new
    l_ = torch.where(l_ == 0.0, torch.ones_like(l_), l_)
    return (acc / l_).to(q.dtype)


def naive_attention(q, k, v, *, causal, window, q_offset):
    return ops.ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)


def run_attention(cfg: ModelConfig, q, k, v, *, causal: bool = True,
                  q_offset: int = 0) -> torch.Tensor:
    """Dispatch on cfg.attention_impl.  Shapes: q (B,H,Sq,D), kv (B,HKV,Skv,D)."""
    window = cfg.sliding_window
    if cfg.attention_impl == "flash":
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window, q_offset=q_offset)
    if cfg.attention_impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, chunk=cfg.attention_chunk)
    return naive_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode: q (B,H,1,D) over cache (B,HKV,S,D) with valid
    ``lengths`` (B,): one masked GQA matmul pair (memory-bound)."""
    b, h, _, d = q.shape
    hkv = k_cache.shape[1]
    g = h // hkv
    scale = d ** -0.5
    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * scale
    kpos = torch.arange(k_cache.shape[2], device=q.device)[None, :]
    mask = kpos < lengths[:, None]
    if window is not None:
        mask &= kpos > (lengths[:, None] - 1 - window)
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return o.reshape(b, h, 1, d).to(q.dtype)


# ------------------------------------------------------------ projections

class Attention(nn.Module):
    """Projections ``wq`` (d, H*hd), ``wk``/``wv`` (d, HKV*hd), ``wo``
    (H*hd, d); biases ``bq``/``bk``/``bv`` with ``qkv_bias``; float32
    ``q_norm``/``k_norm`` (hd,) with ``qk_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = dtype_of(cfg)
        self.wq = _param((d, h * hd), dt, device)
        self.wk = _param((d, kv * hd), dt, device)
        self.wv = _param((d, kv * hd), dt, device)
        self.wo = _param((h * hd, d), dt, device)
        bias = cfg.qkv_bias
        self.bq = _param((h * hd,), dt, device) if bias else None
        self.bk = _param((kv * hd,), dt, device) if bias else None
        self.bv = _param((kv * hd,), dt, device) if bias else None
        qk = cfg.qk_norm
        self.q_norm = _param((hd,), torch.float32, device) if qk else None
        self.k_norm = _param((hd,), torch.float32, device) if qk else None


def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   device=None) -> Attention:
    p = Attention(cfg, device)
    s = cfg.d_model ** -0.5
    for w in (p.wq, p.wk, p.wv, p.wo):
        fill_normal_(w, s, gen)
    for bias in (p.bq, p.bk, p.bv):
        if bias is not None:
            bias.zero_()
    for norm in (p.q_norm, p.k_norm):
        if norm is not None:
            norm.fill_(1.0)
    return p


def qkv_project(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                positions: Optional[torch.Tensor], rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,H,S,hd), k/v (B,HKV,S,hd) with bias/qk-norm/rope."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if rope and cfg.pos_embedding == "rope" and positions is not None:
        if cfg.mrope:
            q = apply_mrope(q, positions, cfg.rope_theta)
            k = apply_mrope(k, positions, cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


# -------------------------------------------------------------------- mlp

class MLP(nn.Module):
    """Gated SiLU (``w_gate``, ``w_up`` (d, f), ``w_down`` (f, d)) or GELU
    (``w_up``, ``b_up``, ``w_down``, ``b_down``)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        dt = dtype_of(cfg)
        gated = cfg.mlp_type == "gated_silu"
        self.w_gate = _param((d, f), dt, device) if gated else None
        self.w_up = _param((d, f), dt, device)
        self.b_up = None if gated else _param((f,), dt, device)
        self.w_down = _param((f, d), dt, device)
        self.b_down = None if gated else _param((d,), dt, device)


def init_mlp(cfg: ModelConfig, gen: torch.Generator, device=None,
             d_ff: Optional[int] = None) -> MLP:
    p = MLP(cfg, device, d_ff)
    d, f = p.w_up.shape
    if p.w_gate is not None:
        fill_normal_(p.w_gate, d ** -0.5, gen)
    fill_normal_(p.w_up, d ** -0.5, gen)
    fill_normal_(p.w_down, f ** -0.5, gen)
    for bias in (p.b_up, p.b_down):
        if bias is not None:
            bias.zero_()
    return p


def mlp(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "gated_silu":
        return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p.w_up + p.b_up, approximate="tanh") @ p.w_down \
        + p.b_down

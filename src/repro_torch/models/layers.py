"""Transformer building blocks of the LMs, in PyTorch.

The counterpart of ``repro.models.layers``.  Parameters live in small
``nn.Module``s (:class:`Norm`, :class:`Attention`, :class:`MLP`,
:class:`MoE`) whose attribute names are the JAX package's parameter
keys, so a parameter tree converts key for key; the math is in free
functions with the JAX package's names, taking those modules.
Parameters are created not requiring grad, for serving;
``optim.init_train_state`` makes them trainable.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

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
                positions: Optional[torch.Tensor], rope: bool = True,
                heads: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,H,S,hd), k/v (B,HKV,S,hd) with bias/qk-norm/rope.
    ``heads(t, n)`` lays a projection out so that it splits into n heads
    (a sharding policy's ``heads_ready``)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if heads is not None:
        q, k, v = heads(q, h), heads(k, kv), heads(v, kv)
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


# -------------------------------------------------------------------- moe

class MoE(nn.Module):
    """``router`` (d, E), float32 whatever the model's dtype; the
    experts' gated-SiLU weights ``w_gate``, ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = dtype_of(cfg)
        self.router = _param((d, e), torch.float32, device)
        self.w_gate = _param((e, d, f), dt, device)
        self.w_up = _param((e, d, f), dt, device)
        self.w_down = _param((e, f, d), dt, device)


def init_moe(cfg: ModelConfig, gen: torch.Generator, device=None) -> MoE:
    p = MoE(cfg, device)
    d, f = cfg.d_model, cfg.d_ff
    fill_normal_(p.router, d ** -0.5, gen)
    fill_normal_(p.w_gate, d ** -0.5, gen)
    fill_normal_(p.w_up, d ** -0.5, gen)
    fill_normal_(p.w_down, f ** -0.5, gen)
    return p


class Routing(NamedTuple):
    """One MoE layer's routing of G groups of Tg tokens: the router's
    softmax ``probs`` (G, Tg, E) float32; per (token, slot) the chosen
    expert ``idx`` (G, Tg, k), its renormalised gate ``gate`` (float32),
    its place ``pos`` in that expert's queue and whether it was ``kept``
    (pos < capacity); and the ``capacity`` C of every queue."""

    probs: torch.Tensor
    idx: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    kept: torch.Tensor
    capacity: int


def moe_group_size(cfg: ModelConfig, seq: int) -> int:
    """Tokens per routing group: ``moe_group_size`` where it divides the
    sequence, else the whole row (a decode step's row is one token)."""
    g = cfg.moe_group_size
    return g if g and seq % g == 0 else seq


def moe_routing(cfg: ModelConfig, router: torch.Tensor,
                xt: torch.Tensor) -> Routing:
    """Capacity-limited top-k routing of xt (G, Tg, D), as the JAX
    package routes: the router in float32, softmax, the k largest
    probabilities with ties to the lower expert (``jax.lax.top_k``'s
    rule: a stable descending sort), the k gates renormalised to sum to
    1, and each (token, slot) queued at its expert in token-major order
    within its group, dropped at position >= C."""
    g, tg, _ = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ router, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :k], order[..., :k]
    gate = gate / gate.sum(-1, keepdim=True)
    # capacity_factor >= e / k makes the routing dropless
    capacity = min(tg * k, max(1, int(cfg.capacity_factor * k * tg / e)))
    # a slot's queue position is the count of earlier (token, slot)s of
    # its group at its expert: its rank among them in a stable sort by
    # expert (the JAX package takes a cumsum over (Tg * k, E) one-hots)
    flat = idx.reshape(g, tg * k)
    by_expert, order = torch.sort(flat, dim=1, stable=True)
    first = torch.searchsorted(by_expert, torch.arange(
        e, device=xt.device).expand(g, e).contiguous())
    rank = torch.arange(tg * k, device=xt.device) - first.gather(1, by_expert)
    pos = torch.empty_like(flat).scatter_(1, order, rank).reshape(g, tg, k)
    return Routing(probs, idx, gate, pos, pos < capacity, capacity)


def moe(cfg: ModelConfig, p: MoE, x: torch.Tensor,
        experts: Optional[Tuple[int, int]] = None,
        reduce: Optional[Callable] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's group-wise capacity MoE on x (B, S, D); returns
    (y, the Switch load-balancing aux loss, float32).

    The JAX package dispatches with (G, Tg, E, C) one-hot einsums; here
    the kept tokens are gathered into each expert's (C, D) queue and the
    experts' outputs gathered back, weighted by the gates rounded to x's
    dtype and summed in float32.  A queue slot holds at most one token,
    so the gathered queues equal the einsum's exactly; an empty slot is
    zeros, as there.  Only the combine's summation order differs.

    Under a sharding policy (``ShardingPolicy.local_moe``) ``p`` holds
    only the experts ``experts`` = (first, count) and y is this rank's
    partial sum, the other experts' slots contributing zeros;
    ``reduce`` sums a tensor over the ranks that hold other rows of the
    batch, so that the aux loss is that of the whole batch."""
    b0, s0, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tg = moe_group_size(cfg, s0)
    xt = x.reshape(b0 * s0 // tg, tg, d)
    g = xt.shape[0]
    r = moe_routing(cfg, p.router, xt)
    cap = r.capacity
    # each kept (token, slot)'s queue slot; dropped ones to a spare slot
    dest = torch.where(r.kept, r.idx * cap + r.pos,
                       torch.full_like(r.idx, e * cap)).reshape(g, tg * k)
    rows = torch.arange(g, device=x.device)[:, None]
    src = torch.full((g, e * cap + 1), tg, dtype=torch.long,
                     device=x.device)
    src[rows, dest] = torch.arange(tg, device=x.device).repeat_interleave(
        k)[None].expand(g, -1)
    xpad = torch.nn.functional.pad(xt, (0, 0, 0, 1))     # row tg: zeros
    xe = xpad[rows, src[:, :e * cap]]                    # (G, E*C, D)
    xe = xe.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    if experts is None or experts == (0, e):
        hidden = F.silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
        ye = torch.bmm(hidden, p.w_down)                 # (E, G*C, D)
    else:
        e0, el = experts
        xl = xe[e0:e0 + el]
        hidden = F.silu(torch.bmm(xl, p.w_gate)) * torch.bmm(xl, p.w_up)
        ye = F.pad(torch.bmm(hidden, p.w_down),
                   (0, 0, 0, 0, e0, e - e0 - el))
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    ye = torch.nn.functional.pad(ye, (0, 0, 0, 1))       # the spare slot
    w = torch.where(r.kept, r.gate, torch.zeros_like(r.gate)).to(x.dtype)
    y = (w.float()[..., None] * ye[rows, dest].reshape(g, tg, k, d).float())
    y = y.sum(2).to(x.dtype)
    # Switch aux loss: e * sum(mean prob * share of kept slots), per e
    kept = torch.zeros(e, device=x.device).scatter_add_(
        0, r.idx.reshape(-1), r.kept.reshape(-1).float())
    if reduce is None:
        me = r.probs.mean((0, 1))
        ce = kept / (g * tg)
    else:
        n = reduce(torch.full((), float(g * tg), device=x.device))
        me = reduce(r.probs.sum((0, 1))) / n
        ce = reduce(kept) / n
    return y.reshape(b0, s0, d), e * torch.sum(me * ce)

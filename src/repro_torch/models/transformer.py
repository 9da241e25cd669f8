"""Decoder and encoder-decoder stacks over the layer library, in
PyTorch.

The counterpart of ``repro.models.transformer`` for every family: the
JAX package scans stacked per-layer parameters with ``lax.scan``; here
the layers are an ``nn.ModuleList`` and the stacks loop over it.

Cache convention, as in the JAX package: every attention layer owns
``k``/``v`` of shape (L, B, HKV, S, hd); mamba layers own ``conv_x``,
``conv_b``, ``conv_c`` (L, B, K-1, C) and ``ssm`` (L, B, H, P, N);
a hybrid cache is ``{"mamba": <mamba cache, (groups, every, ...)>,
"attn": <k/v cache, (groups, ...)>}``; an encoder-decoder cache adds
the cross-attention's ``xk``/``xv`` (L, B, HKV, encoder_seq, hd),
computed once from the encoder's output.  ``lengths`` (B,) or a scalar
tracks the valid entries, and a decode step writes at position
``lengths``.  Unlike the JAX package, which returns a new cache, a decode
step writes into the cache it is given and returns that same cache: a
copy of a 28-layer cache per token would double the step's memory
traffic.

The full-sequence stacks the training loss runs (``stack_forward``,
``hybrid_forward``, ``encoder_forward``, ``decoder_forward_encdec``) take
``remat``, wrapped once around each layer as the JAX package's
``_maybe_remat`` wraps its scan body: ``"full"`` recomputes the layer in
the backward pass, ``"dots"`` keeps only the outputs of its 2-D matrix
products.  ``train`` sends a mamba layer's SSD scan through its plain
version under autograd (see :func:`.mamba2.ssd_chunked`).

Every function takes ``policy``, a :class:`repro_torch.sharding.ShardingPolicy`
or None, and calls it where the JAX package does: ``attn_qkv`` on q/k/v
before attention, ``act`` on each block's output, ``mamba_inner`` in the
mamba block, ``sharded_decode_attention`` in a decode step over a
sequence-sharded cache.  Under a policy the tensors are DTensors;
attention, the SSD scan and the MoE experts run on each rank's local
shards through the policy, and the prefill stacks build their caches
as the JAX package does (padded per layer, then stacked) and lay them
out by the policy's ``cache_spec``.  With ``policy=None`` every path is
the single-device one.  The stacks also take ``unroll``, for the JAX
package's signature: the depth loop here is Python, so it changes
nothing (the dry run reads it).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from . import layers as L
from . import mamba2 as M

Cache = Dict[str, Any]
MAMBA_FAMILIES = ("ssm", "hybrid")


# ------------------------------------------------------------ cache utils

def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write new k/v (B, HKV, T, hd) at per-sequence offsets ``lengths``
    ((B,) or a scalar), in place.  As ``lax.dynamic_update_slice`` does,
    each start is clamped into [0, S - T] so that the write fits."""
    b, _, s, _ = k_cache.shape
    t = k.shape[2]
    start = torch.as_tensor(lengths, device=k_cache.device).to(torch.long)
    start = start.expand(b).clamp(0, s - t)
    rows = torch.arange(b, device=k_cache.device)[:, None]
    cols = start[:, None] + torch.arange(t, device=k_cache.device)[None, :]
    # advanced indices (B, T) around a slice put their dims first:
    # the target is (B, T, HKV, hd)
    k_cache[rows, :, cols] = k.transpose(1, 2).to(k_cache.dtype)
    v_cache[rows, :, cols] = v.transpose(1, 2).to(v_cache.dtype)
    return k_cache, v_cache


# -------------------------------------------------------- decoder layers

class DecoderLayer(nn.Module):
    """``norm1``, ``attn``, ``norm2`` and either ``mlp`` or, in the
    ``moe`` family, ``moe``: one attention layer (an encoder layer too)."""

    def __init__(self, norm1: L.Norm, attn: L.Attention, norm2: L.Norm,
                 mlp: Optional[L.MLP] = None, moe: Optional[L.MoE] = None):
        super().__init__()
        self.norm1, self.attn, self.norm2 = norm1, attn, norm2
        self.mlp, self.moe = mlp, moe


class MambaLayer(nn.Module):
    """``norm1``, ``mamba``: one layer of the ``ssm`` and ``hybrid``
    families."""

    def __init__(self, norm1: L.Norm, mamba: M.Mamba2):
        super().__init__()
        self.norm1, self.mamba = norm1, mamba


def empty_decoder_layer(cfg: ModelConfig, device=None) -> nn.Module:
    if cfg.family in MAMBA_FAMILIES:
        return MambaLayer(L.Norm(cfg, cfg.d_model, device),
                          M.Mamba2(cfg, device))
    ffn = ({"moe": L.MoE(cfg, device)} if cfg.family == "moe"
           else {"mlp": L.MLP(cfg, device)})
    return DecoderLayer(L.Norm(cfg, cfg.d_model, device),
                        L.Attention(cfg, device),
                        L.Norm(cfg, cfg.d_model, device), **ffn)


def init_decoder_layer(cfg: ModelConfig, gen: torch.Generator,
                       device=None) -> nn.Module:
    if cfg.family in MAMBA_FAMILIES:
        return MambaLayer(L.init_norm(cfg, cfg.d_model, device),
                          M.init_mamba2(cfg, gen, device))
    norm1 = L.init_norm(cfg, cfg.d_model, device)
    attn = L.init_attention(cfg, gen, device)
    ffn = ({"moe": L.init_moe(cfg, gen, device)} if cfg.family == "moe"
           else {"mlp": L.init_mlp(cfg, gen, device)})
    return DecoderLayer(norm1, attn, L.init_norm(cfg, cfg.d_model, device),
                        **ffn)


def _gathered(policy, h):
    return h if policy is None else policy.gathered(h)


def _heads_ready(policy):
    return None if policy is None else policy.heads_ready


def _act(policy, y):
    return y if policy is None else policy.act(y)


def _attention(cfg: ModelConfig, q, k, v, causal: bool = True,
               q_offset: int = 0, policy=None):
    """``layers.run_attention``, on each rank's heads under a policy."""
    if policy is None:
        return L.run_attention(cfg, q, k, v, causal=causal,
                               q_offset=q_offset)
    return policy.local_attention(
        functools.partial(L.run_attention, cfg, causal=causal,
                          q_offset=q_offset), q, k, v)


def attn_block_full(cfg: ModelConfig, p: DecoderLayer, x: torch.Tensor,
                    positions: torch.Tensor, q_offset: int = 0,
                    causal: bool = True, policy=None
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over the layer's own sequence (prefill).  Returns
    (out, (k, v)) so prefill can stash the cache."""
    h = _gathered(policy, L.apply_norm(cfg, p.norm1, x))
    q, k, v = L.qkv_project(cfg, p.attn, h, positions,
                            heads=_heads_ready(policy))
    if policy is not None:
        q, k, v = policy.attn_qkv(q, k, v)
    o = _attention(cfg, q, k, v, causal, q_offset, policy)
    o = o.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
    return x + _act(policy, o @ p.attn.wo), (k, v)


def attn_block_decode(cfg: ModelConfig, p: DecoderLayer, x: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      lengths: torch.Tensor, policy=None):
    """One-token decode against the cache.  x: (B, 1, D).

    Sliding-window archs may hand a *ring buffer* cache of size == window:
    the write position wraps and every slot stays visible once filled;
    the ring then IS the window (RoPE is applied at write time, so scores
    depend only on absolute positions, not storage slots)."""
    b = x.shape[0]
    h = L.apply_norm(cfg, p.norm1, x)
    pos = lengths.reshape(-1, 1).expand(b, 1)
    if cfg.mrope:  # decode: all three M-RoPE components advance together
        pos = pos[None].expand((3,) + pos.shape)
    q, k, v = L.qkv_project(cfg, p.attn, h, pos, heads=_heads_ready(policy))
    cache_size = k_cache.shape[2]
    window = cfg.sliding_window
    ring = window is not None and cache_size == window
    write_at = lengths % cache_size if ring else lengths
    write = update_kv_cache if policy is None else policy.update_kv_cache
    k_cache, v_cache = write(k_cache, v_cache, k, v, write_at)
    valid = (lengths + 1).expand(b)
    if ring:
        valid = torch.clamp(valid, max=cache_size)
        window = None  # the ring already implements the window
    attend = (L.decode_attention if policy is None
              else policy.sharded_decode_attention
              if policy.seq_sharded_decode else policy.decode_attention)
    o = attend(q, k_cache, v_cache, valid, window)
    o = o.transpose(1, 2).reshape(b, 1, -1)
    # under a policy the residual stream leaves every block in one
    # layout, as the full-sequence blocks leave it (DTensor would keep a
    # pending sum)
    return x + _act(policy, o @ p.attn.wo), (k_cache, v_cache)


def mlp_block(cfg: ModelConfig, p: DecoderLayer, x: torch.Tensor,
              policy=None):
    """The feed-forward half of a layer.  Returns (x, aux): the MoE's
    load-balancing loss (float32), or 0.0 without experts."""
    h = _gathered(policy, L.apply_norm(cfg, p.norm2, x))
    if cfg.family != "moe":
        return x + _act(policy, L.mlp(cfg, p.mlp, h)), 0.0
    moe = functools.partial(L.moe, cfg)
    y, aux = (moe(p.moe, h) if policy is None
              else policy.local_moe(moe, p.moe, h))
    return x + _act(policy, y), aux


def decoder_layer_full(cfg: ModelConfig, p: nn.Module, x: torch.Tensor,
                       positions: torch.Tensor, q_offset: int = 0,
                       train: bool = False, policy=None):
    """Full-sequence pass of one layer.  Returns (x, (k, v), aux), or
    (x, None, 0.0) for a mamba layer."""
    if cfg.family in MAMBA_FAMILIES:
        h = _gathered(policy, L.apply_norm(cfg, p.norm1, x))
        y = M.mamba2_forward(cfg, p.mamba, h, train=train, policy=policy)
        return x + _act(policy, y), None, 0.0
    x, kv = attn_block_full(cfg, p, x, positions, q_offset, policy=policy)
    x, aux = mlp_block(cfg, p, x, policy)
    return x, kv, aux


def decoder_layer_full_with_state(cfg: ModelConfig, p: MambaLayer,
                                  x: torch.Tensor, policy=None
                                  ) -> Tuple[torch.Tensor, Cache]:
    """Mamba layer full pass that also returns the final SSM/conv state
    (the prefill path of ``ssm`` and ``hybrid``)."""
    h = _gathered(policy, L.apply_norm(cfg, p.norm1, x))
    y, state = M.mamba2_forward(cfg, p.mamba, h, return_state=True,
                                policy=policy)
    return x + _act(policy, y), state


def decoder_layer_decode(cfg: ModelConfig, p: nn.Module, x: torch.Tensor,
                         cache: Cache, lengths: torch.Tensor, policy=None):
    """One-token step of one layer against its cache, written in place.
    Returns (x, the layer's cache, aux)."""
    if cfg.family in MAMBA_FAMILIES:
        h = L.apply_norm(cfg, p.norm1, x)
        y, state = M.mamba2_decode_step(cfg, p.mamba, h, cache,
                                        policy=policy)
        return x + _act(policy, y), state, 0.0
    x, (kc, vc) = attn_block_decode(cfg, p, x, cache["k"], cache["v"],
                                    lengths, policy)
    x, aux = mlp_block(cfg, p, x, policy)
    return x, {"k": kc, "v": vc}, aux


# ------------------------------------------------------------------ remat

#: The 2-D matrix products whose outputs ``"dots"`` keeps: what
#: ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` saves
#: (a batched product, ``bmm``, is recomputed).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn: Callable, remat: str) -> Callable:
    """``fn`` under the remat policy ``remat``: ``"none"``, ``"full"``
    (everything recomputed in the backward pass) or ``"dots"`` (the 2-D
    products' outputs kept, the rest recomputed)."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            _ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat policy {remat!r}")


# ----------------------------------------------------------------- stacks

def init_stack(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
               device=None) -> nn.ModuleList:
    return nn.ModuleList(init_decoder_layer(cfg, gen, device)
                         for _ in range(n_layers))


def empty_stack(cfg: ModelConfig, n_layers: int,
                device=None) -> nn.ModuleList:
    """A stack of uninitialised layers, to be filled from a checkpoint."""
    return nn.ModuleList(empty_decoder_layer(cfg, device)
                         for _ in range(n_layers))


def stack_forward(cfg: ModelConfig, stack: nn.ModuleList, x: torch.Tensor,
                  positions: torch.Tensor, remat: str = "none",
                  train: bool = False, policy=None, unroll: bool = False
                  ) -> Tuple[torch.Tensor, Any]:
    """Full-sequence pass over all layers.  Returns (x, the sum of the
    layers' aux losses): a float32 scalar tensor, or 0.0 without
    experts."""
    def body(p, h):
        h, _kv, aux = decoder_layer_full(cfg, p, h, positions, train=train,
                                         policy=policy)
        return h, aux

    body = _maybe_remat(body, remat)
    total = 0.0
    for p in stack:
        x, aux = body(p, x)
        total = total + aux
    return x, total


def _stack(policy, ts):
    return torch.stack(ts) if policy is None else policy.stack(ts)


def _padded_kv(k: torch.Tensor, cache_len: int) -> torch.Tensor:
    return F.pad(k, (0, 0, 0, cache_len - k.shape[2]))


def _laid_out(policy, cache: Cache) -> Cache:
    return cache if policy is None else policy.distribute_cache(cache)


def stack_prefill(cfg: ModelConfig, stack: nn.ModuleList, x: torch.Tensor,
                  positions: torch.Tensor, cache_len: int, policy=None,
                  unroll: bool = False) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence pass returning the populated cache, padded with zeros
    to ``cache_len`` (which must hold the sequence).  A mamba stack's
    cache is its layers' final states, whatever ``cache_len`` is."""
    if cfg.family in MAMBA_FAMILIES:
        states = []
        for p in stack:
            x, st = decoder_layer_full_with_state(cfg, p, x, policy)
            states.append(st)
        return x, _laid_out(policy, {k: _stack(policy, [st[k] for st in states])
                                     for k in states[0]})
    b, s, _ = x.shape
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} is shorter than the "
                         f"{s}-token sequence")
    if policy is not None:
        ks, vs = [], []
        for p in stack:
            x, (k, v), _aux = decoder_layer_full(cfg, p, x, positions,
                                                 policy=policy)
            ks.append(_padded_kv(k, cache_len))
            vs.append(_padded_kv(v, cache_len))
        return x, policy.distribute_cache({"k": policy.stack(ks),
                                           "v": policy.stack(vs)})
    shape = (len(stack), b, cfg.n_kv_heads, cache_len, cfg.hd)
    cache = {"k": x.new_zeros(shape), "v": x.new_zeros(shape)}
    for i, p in enumerate(stack):
        x, (k, v), _aux = decoder_layer_full(cfg, p, x, positions)
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
    return x, cache


def stack_decode(cfg: ModelConfig, stack: nn.ModuleList, x: torch.Tensor,
                 cache: Cache, lengths: torch.Tensor, policy=None,
                 unroll: bool = False) -> Tuple[torch.Tensor, Cache]:
    for i, p in enumerate(stack):
        x, _, _aux = decoder_layer_decode(
            cfg, p, x, {k: v[i] for k, v in cache.items()}, lengths, policy)
    return x, cache


# ------------------------------------------------------- hybrid (zamba2)

class HybridStack(nn.Module):
    """``mamba_stack`` (one :class:`MambaLayer` a layer) and
    ``shared_attn``, ONE dense attention + MLP layer applied after every
    ``hybrid_attn_every`` mamba layers with its weights shared (zamba2's
    shared block, acting on the running hidden state as in the JAX
    package)."""

    def __init__(self, mamba_stack: nn.ModuleList, shared_attn: DecoderLayer):
        super().__init__()
        self.mamba_stack, self.shared_attn = mamba_stack, shared_attn


def _as_dense(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, family="dense")


def init_hybrid(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> HybridStack:
    return HybridStack(init_stack(cfg, gen, cfg.n_layers, device),
                       init_decoder_layer(_as_dense(cfg), gen, device))


def empty_hybrid(cfg: ModelConfig, device=None) -> HybridStack:
    return HybridStack(empty_stack(cfg, cfg.n_layers, device),
                       empty_decoder_layer(_as_dense(cfg), device))


def hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, every): the mamba layers between two applications of the
    shared block, and how many such groups there are."""
    every = cfg.hybrid_attn_every or cfg.n_layers
    if cfg.n_layers % every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not group "
                         f"by hybrid_attn_every {every}")
    return cfg.n_layers // every, every


def _group(cfg: ModelConfig, p: HybridStack, gi: int) -> nn.ModuleList:
    _, every = hybrid_groups(cfg)
    return p.mamba_stack[gi * every:(gi + 1) * every]


def hybrid_forward(cfg: ModelConfig, p: HybridStack, x: torch.Tensor,
                   positions: torch.Tensor, remat: str = "none",
                   train: bool = False, policy=None,
                   unroll: bool = False) -> torch.Tensor:
    """The mamba groups under ``remat``, one wrap a layer; the shared
    block unwrapped, as in the JAX package."""
    dense_cfg = _as_dense(cfg)
    for gi in range(hybrid_groups(cfg)[0]):
        x, _aux = stack_forward(cfg, _group(cfg, p, gi), x, positions,
                                remat, train, policy, unroll)
        x, _kv, _aux = decoder_layer_full(dense_cfg, p.shared_attn, x,
                                          positions, policy=policy)
    return x


def hybrid_prefill(cfg: ModelConfig, p: HybridStack, x: torch.Tensor,
                   positions: torch.Tensor, cache_len: int, policy=None,
                   unroll: bool = False) -> Tuple[torch.Tensor, Cache]:
    """Full pass returning ``{"mamba": states (groups, every, ...),
    "attn": k/v (groups, B, HKV, cache_len, hd)}``."""
    b, s, _ = x.shape
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} is shorter than the "
                         f"{s}-token sequence")
    dense_cfg = _as_dense(cfg)
    groups, _ = hybrid_groups(cfg)
    states, ks, vs = [], [], []
    if policy is None:
        shape = (groups, b, cfg.n_kv_heads, cache_len, cfg.hd)
        attn = {"k": x.new_zeros(shape), "v": x.new_zeros(shape)}
    for gi in range(groups):
        x, st = stack_prefill(cfg, _group(cfg, p, gi), x, positions,
                              cache_len, policy, unroll)
        states.append(st)
        x, (k, v), _aux = decoder_layer_full(dense_cfg, p.shared_attn, x,
                                             positions, policy=policy)
        if policy is None:
            attn["k"][gi, :, :, :s] = k
            attn["v"][gi, :, :, :s] = v
        else:
            ks.append(_padded_kv(k, cache_len))
            vs.append(_padded_kv(v, cache_len))
    mamba = {k: _stack(policy, [st[k] for st in states]) for k in states[0]}
    if policy is not None:
        attn = {"k": policy.stack(ks), "v": policy.stack(vs)}
    return x, _laid_out(policy, {"mamba": mamba, "attn": attn})


def hybrid_decode(cfg: ModelConfig, p: HybridStack, x: torch.Tensor,
                  cache: Cache, lengths: torch.Tensor, policy=None,
                  unroll: bool = False) -> Tuple[torch.Tensor, Cache]:
    dense_cfg = _as_dense(cfg)
    for gi in range(hybrid_groups(cfg)[0]):
        x, _ = stack_decode(cfg, _group(cfg, p, gi), x,
                            {k: v[gi] for k, v in cache["mamba"].items()},
                            lengths, policy, unroll)
        x, _, _aux = decoder_layer_decode(
            dense_cfg, p.shared_attn, x,
            {k: v[gi] for k, v in cache["attn"].items()}, lengths, policy)
    return x, cache


# ------------------------------------------------------ enc-dec (whisper)

class CrossLayer(DecoderLayer):
    """A decoder layer of an encoder-decoder model: a
    :class:`DecoderLayer` (``norm1``, ``attn``, ``norm2``, ``mlp``) plus
    ``norm_x`` and ``xattn``, the cross-attention over the encoder's
    output."""

    def __init__(self, norm1: L.Norm, attn: L.Attention, norm2: L.Norm,
                 mlp: L.MLP, norm_x: L.Norm, xattn: L.Attention):
        super().__init__(norm1, attn, norm2, mlp)
        self.norm_x, self.xattn = norm_x, xattn


class EncDecStack(nn.Module):
    """``encoder`` (one :class:`DecoderLayer` a layer, run without the
    causal mask), ``decoder`` (one :class:`CrossLayer` a layer) and
    ``enc_norm``, the norm after the encoder."""

    def __init__(self, encoder: nn.ModuleList, decoder: nn.ModuleList,
                 enc_norm: L.Norm):
        super().__init__()
        self.encoder, self.decoder, self.enc_norm = encoder, decoder, enc_norm


def init_encdec_layer(cfg: ModelConfig, gen: torch.Generator, cross: bool,
                      device=None) -> DecoderLayer:
    d = cfg.d_model
    parts = (L.init_norm(cfg, d, device), L.init_attention(cfg, gen, device),
             L.init_norm(cfg, d, device), L.init_mlp(cfg, gen, device))
    if not cross:
        return DecoderLayer(*parts)
    return CrossLayer(*parts, L.init_norm(cfg, d, device),
                      L.init_attention(cfg, gen, device))


def _empty_encdec_layer(cfg: ModelConfig, cross: bool,
                        device=None) -> DecoderLayer:
    d = cfg.d_model
    parts = (L.Norm(cfg, d, device), L.Attention(cfg, device),
             L.Norm(cfg, d, device), L.MLP(cfg, device))
    if not cross:
        return DecoderLayer(*parts)
    return CrossLayer(*parts, L.Norm(cfg, d, device),
                      L.Attention(cfg, device))


def init_encdec(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> EncDecStack:
    return EncDecStack(
        nn.ModuleList(init_encdec_layer(cfg, gen, False, device)
                      for _ in range(cfg.encoder_layers)),
        nn.ModuleList(init_encdec_layer(cfg, gen, True, device)
                      for _ in range(cfg.n_layers)),
        L.init_norm(cfg, cfg.d_model, device))


def empty_encdec(cfg: ModelConfig, device=None) -> EncDecStack:
    return EncDecStack(
        nn.ModuleList(_empty_encdec_layer(cfg, False, device)
                      for _ in range(cfg.encoder_layers)),
        nn.ModuleList(_empty_encdec_layer(cfg, True, device)
                      for _ in range(cfg.n_layers)),
        L.Norm(cfg, cfg.d_model, device))


def encoder_forward(cfg: ModelConfig, p: EncDecStack, x: torch.Tensor,
                    remat: str = "none", policy=None,
                    unroll: bool = False) -> torch.Tensor:
    """Bidirectional encoder over precomputed frame embeddings x (B, Se,
    D), positions 0..Se-1."""
    positions = torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[:2])

    def body(layer, h):
        h, _kv = attn_block_full(cfg, layer, h, positions, causal=False,
                                 policy=policy)
        return mlp_block(cfg, layer, h, policy)[0]

    body = _maybe_remat(body, remat)
    for layer in p.encoder:
        x = body(layer, x)
    return _gathered(policy, L.apply_norm(cfg, p.enc_norm, x))


def cross_attention(cfg: ModelConfig, p: CrossLayer, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor],
                    policy=None) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (B, HKV,
    Se, hd): q's bias only, no mask."""
    b, s, _ = x.shape
    hn = _gathered(policy, L.apply_norm(cfg, p.norm_x, x))
    q = hn @ p.xattn.wq
    if cfg.qkv_bias:
        q = q + p.xattn.bq
    if policy is not None:
        q = policy.heads_ready(q, cfg.n_heads)
    q = q.reshape(b, s, cfg.n_heads, cfg.hd).transpose(1, 2)
    k, v = enc_kv
    o = _attention(cfg, q, k, v, causal=False, policy=policy)
    o = o.transpose(1, 2).reshape(b, s, -1) @ p.xattn.wo
    return x + _act(policy, o)


def encoder_kv(cfg: ModelConfig, decoder: nn.ModuleList,
               enc_out: torch.Tensor, policy=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross K/V from the encoder's output, stacked
    (L, B, HKV, Se, hd): written into one buffer, or under a policy
    (DTensors) computed per layer and stacked."""
    stacked = policy is not None
    heads_ready = _heads_ready(policy)
    b, se, _ = enc_out.shape
    shape = (len(decoder), b, cfg.n_kv_heads, se, cfg.hd)
    if not stacked:
        xk, xv = enc_out.new_empty(shape), enc_out.new_empty(shape)
    ks, vs = [], []
    for i, layer in enumerate(decoder):
        k = enc_out @ layer.xattn.wk
        v = enc_out @ layer.xattn.wv
        if cfg.qkv_bias:
            k, v = k + layer.xattn.bk, v + layer.xattn.bv
        if stacked:
            k, v = (heads_ready(t, cfg.n_kv_heads) for t in (k, v))
        k = k.reshape(b, se, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
        v = v.reshape(b, se, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
        if stacked:
            ks.append(k)
            vs.append(v)
        else:
            xk[i], xv[i] = k, v
    if stacked:
        return policy.stack(ks), policy.stack(vs)
    return xk, xv


def decoder_forward_encdec(cfg: ModelConfig, p: EncDecStack, x: torch.Tensor,
                           positions: torch.Tensor, enc_out: torch.Tensor,
                           remat: str = "none", policy=None,
                           unroll: bool = False) -> torch.Tensor:
    """The decoder over the encoder's output: the cross K/V of every
    layer first, then each layer (self-attention, cross-attention, MLP)
    under ``remat``."""
    xk, xv = encoder_kv(cfg, p.decoder, enc_out, policy)

    def body(layer, h, ek, ev):
        h, _kv = attn_block_full(cfg, layer, h, positions, policy=policy)
        h = cross_attention(cfg, layer, h, (ek, ev), policy)
        return mlp_block(cfg, layer, h, policy)[0]

    body = _maybe_remat(body, remat)
    for i, layer in enumerate(p.decoder):
        x = body(layer, x, xk[i], xv[i])
    return x


def decoder_prefill_encdec(cfg: ModelConfig, p: EncDecStack, x: torch.Tensor,
                           positions: torch.Tensor, enc_out: torch.Tensor,
                           cache_len: int, policy=None,
                           unroll: bool = False) -> Tuple[torch.Tensor, Cache]:
    """Full decoder pass returning the cache: the self-attention's
    ``k``/``v`` padded with zeros to ``cache_len``, and ``xk``/``xv``."""
    b, s, _ = x.shape
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} is shorter than the "
                         f"{s}-token sequence")
    xk, xv = encoder_kv(cfg, p.decoder, enc_out, policy)
    shape = (len(p.decoder), b, cfg.n_kv_heads, cache_len, cfg.hd)
    if policy is None:
        cache = {"k": x.new_zeros(shape), "v": x.new_zeros(shape),
                 "xk": xk, "xv": xv}
    ks, vs = [], []
    for i, layer in enumerate(p.decoder):
        x, (k, v) = attn_block_full(cfg, layer, x, positions, policy=policy)
        if policy is None:
            cache["k"][i, :, :, :s] = k
            cache["v"][i, :, :, :s] = v
        else:
            ks.append(_padded_kv(k, cache_len))
            vs.append(_padded_kv(v, cache_len))
        x = cross_attention(cfg, layer, x, (xk[i], xv[i]), policy)
        x, _aux = mlp_block(cfg, layer, x, policy)
    if policy is not None:
        cache = policy.distribute_cache({"k": policy.stack(ks),
                                         "v": policy.stack(vs),
                                         "xk": xk, "xv": xv})
    return x, cache


def decoder_decode_encdec(cfg: ModelConfig, p: EncDecStack, x: torch.Tensor,
                          cache: Cache, lengths: torch.Tensor, policy=None,
                          unroll: bool = False) -> Tuple[torch.Tensor, Cache]:
    """One-token step: the causal self-attention cache, written in place,
    and the static cross K/V."""
    for i, layer in enumerate(p.decoder):
        x, _ = attn_block_decode(cfg, layer, x, cache["k"][i],
                                 cache["v"][i], lengths, policy)
        x = cross_attention(cfg, layer, x, (cache["xk"][i], cache["xv"][i]),
                            policy)
        x, _aux = mlp_block(cfg, layer, x, policy)
    return x, cache

"""Decoder stacks over the layer library, in PyTorch.

The counterpart of ``repro.models.transformer`` for the dense, ``ssm``
and ``hybrid`` families: the JAX package scans stacked per-layer
parameters with ``lax.scan``; here the layers are an ``nn.ModuleList``
and the stacks loop over it.

Cache convention, as in the JAX package: every attention layer owns
``k``/``v`` of shape (L, B, HKV, S, hd); mamba layers own ``conv_x``,
``conv_b``, ``conv_c`` (L, B, K-1, C) and ``ssm`` (L, B, H, P, N);
a hybrid cache is ``{"mamba": <mamba cache, (groups, every, ...)>,
"attn": <k/v cache, (groups, ...)>}``.  ``lengths`` (B,) or a scalar
tracks the valid entries, and a decode step writes at position
``lengths``.  Unlike the JAX package, which returns a new cache, a decode
step writes into the cache it is given and returns that same cache: a
copy of a 28-layer cache per token would double the step's memory
traffic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch import nn

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
    """``norm1``, ``attn``, ``norm2``, ``mlp``: one dense decoder layer."""

    def __init__(self, norm1: L.Norm, attn: L.Attention, norm2: L.Norm,
                 mlp: L.MLP):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.mlp = norm1, attn, norm2, mlp


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
    return DecoderLayer(L.Norm(cfg, cfg.d_model, device),
                        L.Attention(cfg, device),
                        L.Norm(cfg, cfg.d_model, device),
                        L.MLP(cfg, device))


def init_decoder_layer(cfg: ModelConfig, gen: torch.Generator,
                       device=None) -> nn.Module:
    if cfg.family in MAMBA_FAMILIES:
        return MambaLayer(L.init_norm(cfg, cfg.d_model, device),
                          M.init_mamba2(cfg, gen, device))
    return DecoderLayer(L.init_norm(cfg, cfg.d_model, device),
                        L.init_attention(cfg, gen, device),
                        L.init_norm(cfg, cfg.d_model, device),
                        L.init_mlp(cfg, gen, device))


def attn_block_full(cfg: ModelConfig, p: DecoderLayer, x: torch.Tensor,
                    positions: torch.Tensor, q_offset: int = 0,
                    causal: bool = True
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over the layer's own sequence (prefill).  Returns
    (out, (k, v)) so prefill can stash the cache."""
    h = L.apply_norm(cfg, p.norm1, x)
    q, k, v = L.qkv_project(cfg, p.attn, h, positions)
    o = L.run_attention(cfg, q, k, v, causal=causal, q_offset=q_offset)
    o = o.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
    return x + o @ p.attn.wo, (k, v)


def attn_block_decode(cfg: ModelConfig, p: DecoderLayer, x: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      lengths: torch.Tensor):
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
    q, k, v = L.qkv_project(cfg, p.attn, h, pos)
    cache_size = k_cache.shape[2]
    window = cfg.sliding_window
    ring = window is not None and cache_size == window
    write_at = lengths % cache_size if ring else lengths
    k_cache, v_cache = update_kv_cache(k_cache, v_cache, k, v, write_at)
    valid = (lengths + 1).expand(b)
    if ring:
        valid = torch.clamp(valid, max=cache_size)
        window = None  # the ring already implements the window
    o = L.decode_attention(q, k_cache, v_cache, valid, window)
    o = o.transpose(1, 2).reshape(b, 1, -1)
    return x + o @ p.attn.wo, (k_cache, v_cache)


def mlp_block(cfg: ModelConfig, p: DecoderLayer,
              x: torch.Tensor) -> torch.Tensor:
    return x + L.mlp(cfg, p.mlp, L.apply_norm(cfg, p.norm2, x))


def decoder_layer_full(cfg: ModelConfig, p: nn.Module, x: torch.Tensor,
                       positions: torch.Tensor, q_offset: int = 0):
    """Full-sequence pass of one layer.  Returns (x, (k, v)), or (x,
    None) for a mamba layer."""
    if cfg.family in MAMBA_FAMILIES:
        h = L.apply_norm(cfg, p.norm1, x)
        return x + M.mamba2_forward(cfg, p.mamba, h), None
    x, kv = attn_block_full(cfg, p, x, positions, q_offset)
    return mlp_block(cfg, p, x), kv


def decoder_layer_full_with_state(cfg: ModelConfig, p: MambaLayer,
                                  x: torch.Tensor
                                  ) -> Tuple[torch.Tensor, Cache]:
    """Mamba layer full pass that also returns the final SSM/conv state
    (the prefill path of ``ssm`` and ``hybrid``)."""
    h = L.apply_norm(cfg, p.norm1, x)
    y, state = M.mamba2_forward(cfg, p.mamba, h, return_state=True)
    return x + y, state


def decoder_layer_decode(cfg: ModelConfig, p: nn.Module, x: torch.Tensor,
                         cache: Cache, lengths: torch.Tensor):
    """One-token step of one layer against its cache, written in place."""
    if cfg.family in MAMBA_FAMILIES:
        h = L.apply_norm(cfg, p.norm1, x)
        y, state = M.mamba2_decode_step(cfg, p.mamba, h, cache)
        return x + y, state
    x, (kc, vc) = attn_block_decode(cfg, p, x, cache["k"], cache["v"],
                                    lengths)
    return mlp_block(cfg, p, x), {"k": kc, "v": vc}


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
                  positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence pass over all layers."""
    for p in stack:
        x, _kv = decoder_layer_full(cfg, p, x, positions)
    return x


def stack_prefill(cfg: ModelConfig, stack: nn.ModuleList, x: torch.Tensor,
                  positions: torch.Tensor, cache_len: int
                  ) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence pass returning the populated cache, padded with zeros
    to ``cache_len`` (which must hold the sequence).  A mamba stack's
    cache is its layers' final states, whatever ``cache_len`` is."""
    if cfg.family in MAMBA_FAMILIES:
        states = []
        for p in stack:
            x, st = decoder_layer_full_with_state(cfg, p, x)
            states.append(st)
        return x, {k: torch.stack([st[k] for st in states])
                   for k in states[0]}
    b, s, _ = x.shape
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} is shorter than the "
                         f"{s}-token sequence")
    shape = (len(stack), b, cfg.n_kv_heads, cache_len, cfg.hd)
    cache = {"k": x.new_zeros(shape), "v": x.new_zeros(shape)}
    for i, p in enumerate(stack):
        x, (k, v) = decoder_layer_full(cfg, p, x, positions)
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
    return x, cache


def stack_decode(cfg: ModelConfig, stack: nn.ModuleList, x: torch.Tensor,
                 cache: Cache, lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, Cache]:
    for i, p in enumerate(stack):
        x, _ = decoder_layer_decode(
            cfg, p, x, {k: v[i] for k, v in cache.items()}, lengths)
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
                   positions: torch.Tensor) -> torch.Tensor:
    dense_cfg = _as_dense(cfg)
    for gi in range(hybrid_groups(cfg)[0]):
        x = stack_forward(cfg, _group(cfg, p, gi), x, positions)
        x, _kv = decoder_layer_full(dense_cfg, p.shared_attn, x, positions)
    return x


def hybrid_prefill(cfg: ModelConfig, p: HybridStack, x: torch.Tensor,
                   positions: torch.Tensor, cache_len: int
                   ) -> Tuple[torch.Tensor, Cache]:
    """Full pass returning ``{"mamba": states (groups, every, ...),
    "attn": k/v (groups, B, HKV, cache_len, hd)}``."""
    b, s, _ = x.shape
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} is shorter than the "
                         f"{s}-token sequence")
    dense_cfg = _as_dense(cfg)
    groups, _ = hybrid_groups(cfg)
    shape = (groups, b, cfg.n_kv_heads, cache_len, cfg.hd)
    attn = {"k": x.new_zeros(shape), "v": x.new_zeros(shape)}
    states = []
    for gi in range(groups):
        x, st = stack_prefill(cfg, _group(cfg, p, gi), x, positions,
                              cache_len)
        states.append(st)
        x, (k, v) = decoder_layer_full(dense_cfg, p.shared_attn, x,
                                       positions)
        attn["k"][gi, :, :, :s] = k
        attn["v"][gi, :, :, :s] = v
    mamba = {k: torch.stack([st[k] for st in states]) for k in states[0]}
    return x, {"mamba": mamba, "attn": attn}


def hybrid_decode(cfg: ModelConfig, p: HybridStack, x: torch.Tensor,
                  cache: Cache, lengths: torch.Tensor
                  ) -> Tuple[torch.Tensor, Cache]:
    dense_cfg = _as_dense(cfg)
    for gi in range(hybrid_groups(cfg)[0]):
        x, _ = stack_decode(cfg, _group(cfg, p, gi), x,
                            {k: v[gi] for k, v in cache["mamba"].items()},
                            lengths)
        x, _ = decoder_layer_decode(
            dense_cfg, p.shared_attn, x,
            {k: v[gi] for k, v in cache["attn"].items()}, lengths)
    return x, cache

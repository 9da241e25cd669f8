"""Dense decoder stacks over the layer library, in PyTorch.

The counterpart of ``repro.models.transformer`` for the dense family: the
JAX package scans stacked per-layer parameters with ``lax.scan``; here
the layers are an ``nn.ModuleList`` and the stacks loop over it.

Cache convention, as in the JAX package: every attention layer owns
``k``/``v`` of shape (L, B, HKV, S, hd); ``lengths`` (B,) or a scalar
tracks the valid entries, and a decode step writes at position
``lengths``.  Unlike the JAX package, which returns a new cache, a decode
step writes into the cache it is given and returns that same cache: a
copy of a 28-layer cache per token would double the step's memory
traffic.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from . import layers as L

Cache = Dict[str, torch.Tensor]


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


def empty_decoder_layer(cfg: ModelConfig, device=None) -> DecoderLayer:
    return DecoderLayer(L.Norm(cfg, cfg.d_model, device),
                        L.Attention(cfg, device),
                        L.Norm(cfg, cfg.d_model, device),
                        L.MLP(cfg, device))


def init_decoder_layer(cfg: ModelConfig, gen: torch.Generator,
                       device=None) -> DecoderLayer:
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


def decoder_layer_full(cfg: ModelConfig, p: DecoderLayer, x: torch.Tensor,
                       positions: torch.Tensor, q_offset: int = 0):
    """Full-sequence pass of one layer.  Returns (x, (k, v))."""
    x, kv = attn_block_full(cfg, p, x, positions, q_offset)
    return mlp_block(cfg, p, x), kv


def decoder_layer_decode(cfg: ModelConfig, p: DecoderLayer, x: torch.Tensor,
                         cache: Cache, lengths: torch.Tensor):
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
    to ``cache_len`` (which must hold the sequence)."""
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
            cfg, p, x, {"k": cache["k"][i], "v": cache["v"][i]}, lengths)
    return x, cache

"""The Model API over the dense, SSM and hybrid LMs, in PyTorch.

    model = Model(cfg)                         # on CUDA; device="cpu" asks for the CPU
    params = model.init(torch.Generator(model.device).manual_seed(0))
    logits = model.forward(params, batch)
    logits, cache = model.prefill(params, batch, cache_len)
    logits, cache = model.decode_step(params, batch, cache)

The counterpart of ``repro.models.model.Model`` for the ``dense``,
``ssm`` (mamba2) and ``hybrid`` (zamba2) families.  Batches are dicts:
``tokens`` (B, S) (``positions`` optional) for forward and prefill,
``tokens`` (B, 1) and ``lengths`` (B,) or a scalar (the current cache
fill) for decode.  ``decode_step`` writes into the cache it is given
(see :mod:`.transformer`).  The training loss and the dry-run input
specs are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import device as tdevice
from repro_torch.configs.base import ModelConfig
from . import layers as L
from . import mamba2 as M
from . import transformer as T

#: Families the port does not run yet, and the ROADMAP item that brings
#: each one.
UNPORTED_FAMILIES = {
    "moe": "Queue 1 item 9a (MoE layers)",
    "vlm": "Queue 1 item 9b (VLM embeddings input and M-RoPE positions)",
    "encdec": "Queue 1 item 9d (encoder-decoder stacks)",
}


def _vocab_pad(v: int, mult: int = 256) -> int:
    """Pad the vocabulary to a multiple of 256, as the JAX package does."""
    return -(-v // mult) * mult


class LMParams(nn.Module):
    """An LM's parameters: ``embed`` (padded vocab, d), ``stack`` (one
    :class:`~.transformer.DecoderLayer` or
    :class:`~.transformer.MambaLayer` per layer, or a hybrid's
    :class:`~.transformer.HybridStack`), ``final_norm``, and ``lm_head``
    (d, padded vocab) unless the embeddings are tied."""

    def __init__(self, embed: torch.Tensor, stack: nn.Module,
                 final_norm: L.Norm, lm_head: Optional[torch.Tensor]):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.stack = stack
        self.final_norm = final_norm
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))


class Model:
    def __init__(self, cfg: ModelConfig, device: tdevice.DeviceLike = None):
        if cfg.family in UNPORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported to "
                f"PyTorch yet (ROADMAP {UNPORTED_FAMILIES[cfg.family]})")
        if cfg.family not in ("dense", "ssm", "hybrid"):
            raise ValueError(f"unknown model family {cfg.family!r}")
        self.cfg = cfg
        self.device = tdevice.resolve(device)
        self.dtype = L.dtype_of(cfg)
        self.padded_vocab = _vocab_pad(cfg.vocab_size)

    # ------------------------------------------------------------- init
    def empty_params(self) -> LMParams:
        """Uninitialised parameters of this model's shapes, on its device."""
        cfg, dev = self.cfg, self.device
        shape = (self.padded_vocab, cfg.d_model)
        return LMParams(
            torch.empty(shape, dtype=self.dtype, device=dev),
            T.empty_hybrid(cfg, dev) if cfg.family == "hybrid" else
            T.empty_stack(cfg, cfg.n_layers, dev),
            L.Norm(cfg, cfg.d_model, dev),
            None if cfg.tie_embeddings else
            torch.empty(shape[::-1], dtype=self.dtype, device=dev))

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> LMParams:
        """Random parameters from ``gen`` (a generator on the model's
        device), with the JAX package's distributions and scales: normal
        embeddings * 0.02, projections * fan_in ** -0.5, zero biases,
        unit norms; a mamba layer's as :func:`.mamba2.init_mamba2`
        draws them (its B and C conv taps are zeros)."""
        cfg, dev = self.cfg, self.device
        embed = torch.empty((self.padded_vocab, cfg.d_model),
                            dtype=self.dtype, device=dev)
        L.fill_normal_(embed, 0.02, gen)
        stack = (T.init_hybrid(cfg, gen, dev) if cfg.family == "hybrid"
                 else T.init_stack(cfg, gen, cfg.n_layers, dev))
        lm_head = None
        if not cfg.tie_embeddings:
            lm_head = torch.empty((cfg.d_model, self.padded_vocab),
                                  dtype=self.dtype, device=dev)
            L.fill_normal_(lm_head, cfg.d_model ** -0.5, gen)
        return LMParams(embed, stack, L.init_norm(cfg, cfg.d_model, dev),
                        lm_head)

    # ----------------------------------------------------------- embed/out
    def _embed(self, params: LMParams, batch: Dict[str, Any]) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        return params.embed[tokens.long()]

    def _logits(self, params: LMParams, x: torch.Tensor) -> torch.Tensor:
        x = L.apply_norm(self.cfg, params.final_norm, x)
        if params.lm_head is None:
            logits = x @ params.embed.T
        else:
            logits = x @ params.lm_head
        return logits[..., :self.cfg.vocab_size]

    def _positions(self, batch: Dict[str, Any], seq: int,
                   bsz: int) -> torch.Tensor:
        if "positions" in batch:
            return torch.as_tensor(batch["positions"], device=self.device)
        return torch.arange(seq, dtype=torch.int32,
                            device=self.device)[None].expand(bsz, seq)

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def forward(self, params: LMParams, batch: Dict[str, Any]) -> torch.Tensor:
        x = self._embed(params, batch)
        positions = self._positions(batch, x.shape[1], x.shape[0])
        if self.cfg.family == "hybrid":
            x = T.hybrid_forward(self.cfg, params.stack, x, positions)
        else:
            x = T.stack_forward(self.cfg, params.stack, x, positions)
        return self._logits(params, x)

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, cache_len: int) -> T.Cache:
        """An empty cache; a sliding-window model gets a ring buffer of
        the window's size when ``cache_len`` exceeds it.  An ``ssm``
        model's is its layers' zero states (``cache_len`` unused); a
        ``hybrid`` model's nests the states of its mamba layers, grouped
        (groups, every, ...), and the shared block's k/v per group."""
        cfg = self.cfg
        dev = self.device
        if cfg.family in T.MAMBA_FAMILIES:
            st = M.init_mamba_state(cfg, batch, self.dtype, dev)
            if cfg.family == "ssm":
                return {k: v.new_zeros((cfg.n_layers,) + v.shape)
                        for k, v in st.items()}
            groups, every = T.hybrid_groups(cfg)
            shape = (groups, batch, cfg.n_kv_heads, cache_len, cfg.hd)
            return {"mamba": {k: v.new_zeros((groups, every) + v.shape)
                              for k, v in st.items()},
                    "attn": {k: torch.zeros(shape, dtype=self.dtype,
                                            device=dev) for k in ("k", "v")}}
        window = cfg.sliding_window
        eff = min(cache_len, window) if window else cache_len
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, eff, cfg.hd)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    @torch.no_grad()
    def prefill(self, params: LMParams, batch: Dict[str, Any],
                cache_len: int) -> Tuple[torch.Tensor, T.Cache]:
        """Logits of the last position (B, 1, vocab) and the cache,
        padded to ``cache_len`` (an ``ssm`` model's cache is its layers'
        final states, whatever ``cache_len`` is)."""
        x = self._embed(params, batch)
        positions = self._positions(batch, x.shape[1], x.shape[0])
        if self.cfg.family == "hybrid":
            x, cache = T.hybrid_prefill(self.cfg, params.stack, x, positions,
                                        cache_len)
        else:
            x, cache = T.stack_prefill(self.cfg, params.stack, x, positions,
                                       cache_len)
        return self._logits(params, x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, params: LMParams, batch: Dict[str, Any],
                    cache: T.Cache) -> Tuple[torch.Tensor, T.Cache]:
        """One new token per sequence: tokens (B, 1); lengths (B,) or a
        scalar, the current cache fill.  Writes the cache in place."""
        x = self._embed(params, batch)
        lengths = torch.as_tensor(batch["lengths"],
                                  device=self.device).to(torch.int32)
        if self.cfg.family == "hybrid":
            x, cache = T.hybrid_decode(self.cfg, params.stack, x, cache,
                                       lengths)
        else:
            x, cache = T.stack_decode(self.cfg, params.stack, x, cache,
                                      lengths)
        return self._logits(params, x), cache

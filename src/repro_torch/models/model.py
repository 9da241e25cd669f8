"""The Model API over the LM fleet, in PyTorch.

    model = Model(cfg)                         # on CUDA; device="cpu" asks for the CPU
    params = model.init(torch.Generator(model.device).manual_seed(0))
    loss = model.loss(params, batch)           # train (autograd)
    logits = model.forward(params, batch)
    logits, cache = model.prefill(params, batch, cache_len)
    logits, cache = model.decode_step(params, batch, cache)

The counterpart of ``repro.models.model.Model`` for every family:
``dense``, ``moe`` (granite-moe, llama4-scout), ``vlm`` (qwen2-vl),
``ssm`` (mamba2), ``hybrid`` (zamba2) and ``encdec`` (whisper).
Batches are dicts: ``tokens`` (B, S), or ``embeds`` (B, S, D) for a
model with ``input_embeds``, with ``positions`` optional ((3, B, S) with
M-RoPE) and ``audio_embeds`` (B, encoder_seq, D) for an encoder-decoder,
for forward and prefill, plus ``labels`` (B, S) for the loss (negative
labels are masked out); ``tokens`` (B, 1) or ``embeds`` (B, 1, D) and
``lengths`` (B,) or a scalar (the current cache fill) for decode.
``decode_step`` writes into the cache it is given (see
:mod:`.transformer`).

``loss`` is the only entry point that records autograd: ``forward``,
``prefill`` and ``decode_step`` serve under ``torch.no_grad``.  It runs
the stacks under ``Model(remat=...)`` and sends every mamba layer's scan
through its plain version, since the SSD kernel, like the flash kernel,
has no backward (``ops`` refuses them a gradient).  ``input_specs``
gives ``meta`` tensors of an input shape cell's batch, the counterpart
of the JAX package's ``ShapeDtypeStruct`` stand-ins.

``Model(cfg, policy=ShardingPolicy(mesh, cfg))`` runs on a device mesh
(:mod:`repro_torch.sharding`): ``init`` distributes the parameters by
the policy, ``init_cache`` lays the cache out by its ``cache_spec``,
every entry point lays its batch out by ``batch_specs`` and returns
DTensors (``.full_tensor()`` gathers one).  Plain tensors met inside a
policy's run (positions, masks) are taken as replicated.  ``unroll`` is
the JAX package's flag for its dry run; the depth loop is Python here,
so it changes nothing.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import device as tdevice
from repro_torch.configs.base import ModelConfig, ShapeConfig
from . import layers as L
from . import mamba2 as M
from . import transformer as T

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
#: Rows of the encoder-decoder's learned decoder position table.
DEC_POS_ROWS = 8192


def _vocab_pad(v: int, mult: int = 256) -> int:
    """Pad the vocabulary to a multiple of 256, as the JAX package does."""
    return -(-v // mult) * mult


def _frozen(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class LMParams(nn.Module):
    """An LM's parameters: ``embed`` (padded vocab, d) unless the model
    takes input embeddings, ``stack`` (one
    :class:`~.transformer.DecoderLayer` or
    :class:`~.transformer.MambaLayer` per layer, a hybrid's
    :class:`~.transformer.HybridStack` or an encoder-decoder's
    :class:`~.transformer.EncDecStack`), ``final_norm``, ``lm_head``
    (d, padded vocab) unless the head is tied to ``embed``, and an
    encoder-decoder's learned decoder positions ``dec_pos`` (8192, d)."""

    def __init__(self, embed: Optional[torch.Tensor], stack: nn.Module,
                 final_norm: L.Norm, lm_head: Optional[torch.Tensor],
                 dec_pos: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = _frozen(embed)
        self.stack = stack
        self.final_norm = final_norm
        self.lm_head = _frozen(lm_head)
        self.dec_pos = _frozen(dec_pos)


class Model:
    def __init__(self, cfg: ModelConfig, device: tdevice.DeviceLike = None,
                 *, remat: str = "none", policy=None, unroll: bool = False):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown model family {cfg.family!r}")
        self.cfg = cfg
        self.remat = remat
        self.policy = policy
        self.unroll = unroll or cfg.scan_unroll
        self.device = tdevice.resolve(device)
        self.dtype = L.dtype_of(cfg)
        self.padded_vocab = _vocab_pad(cfg.vocab_size)

    # ------------------------------------------------------------- init
    @property
    def _has_embed(self) -> bool:
        """An ``embed`` table, as the JAX package keeps one: for token
        input, and always for an encoder-decoder."""
        return not self.cfg.input_embeds or self.cfg.family == "encdec"

    @property
    def _tied(self) -> bool:
        return self.cfg.tie_embeddings and self._has_embed

    def _empty(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=self.dtype, device=self.device)

    def empty_params(self) -> LMParams:
        """Uninitialised parameters of this model's shapes, on its device."""
        cfg, dev = self.cfg, self.device
        vd = (self.padded_vocab, cfg.d_model)
        stack = {"hybrid": T.empty_hybrid,
                 "encdec": T.empty_encdec}.get(cfg.family)
        return LMParams(
            self._empty(vd) if self._has_embed else None,
            stack(cfg, dev) if stack else
            T.empty_stack(cfg, cfg.n_layers, dev),
            L.Norm(cfg, cfg.d_model, dev),
            None if self._tied else self._empty(vd[::-1]),
            self._empty((DEC_POS_ROWS, cfg.d_model))
            if cfg.family == "encdec" else None)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> LMParams:
        """Random parameters from ``gen`` (a generator on the model's
        device), with the JAX package's distributions and scales: normal
        embeddings and decoder positions * 0.02, projections and the
        router * fan_in ** -0.5, zero biases, unit norms; a mamba layer's
        as :func:`.mamba2.init_mamba2` draws them (its B and C conv taps
        are zeros).  Under a policy every rank draws the same full values
        and keeps its shards (``policy.param_shardings``)."""
        params = self._init(gen)
        if self.policy is not None:
            self.policy.param_shardings(params)
        return params

    def _init(self, gen: torch.Generator) -> LMParams:
        cfg, dev = self.cfg, self.device
        embed = dec_pos = lm_head = None
        if self._has_embed:
            embed = self._empty((self.padded_vocab, cfg.d_model))
            L.fill_normal_(embed, 0.02, gen)
        if cfg.family == "hybrid":
            stack = T.init_hybrid(cfg, gen, dev)
        elif cfg.family == "encdec":
            stack = T.init_encdec(cfg, gen, dev)
            dec_pos = self._empty((DEC_POS_ROWS, cfg.d_model))
            L.fill_normal_(dec_pos, 0.02, gen)
        else:
            stack = T.init_stack(cfg, gen, cfg.n_layers, dev)
        if not self._tied:
            lm_head = self._empty((cfg.d_model, self.padded_vocab))
            L.fill_normal_(lm_head, cfg.d_model ** -0.5, gen)
        return LMParams(embed, stack, L.init_norm(cfg, cfg.d_model, dev),
                        lm_head, dec_pos)

    # ------------------------------------------------------------ policy
    def _sharded(self):
        """The context of a run under the policy: plain tensors met in
        it are replicated DTensors."""
        if self.policy is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        if self.policy is None:
            return batch
        return self.policy.shard_batch(
            {k: v if k == "cache" else torch.as_tensor(v, device=self.device)
             for k, v in batch.items()})

    def _act(self, x):
        return x if self.policy is None else self.policy.act(x)

    # ----------------------------------------------------------- embed/out
    def _embed(self, params: LMParams, batch: Dict[str, Any]) -> torch.Tensor:
        if self.cfg.input_embeds and "embeds" in batch:
            return torch.as_tensor(batch["embeds"],
                                   device=self.device).to(self.dtype)
        if params.embed is None:
            raise KeyError(f"{self.cfg.name} takes 'embeds' and has no "
                           f"'embed' table for tokens")
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        if self.policy is not None:
            return self.policy.embed(params.embed, tokens)
        return params.embed[tokens.long()]

    def _logits(self, params: LMParams, x: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """Logits of the vocabulary.  For the loss (``train``) of a model
        whose padded vocabulary is sharded over several ranks, the padded
        columns are masked to -inf instead of sliced off: a slice of a
        sharded dimension that the shards do not divide would gather
        every rank's logits."""
        x = L.apply_norm(self.cfg, params.final_norm, x)
        if self.policy is not None:
            x = self.policy.gathered(x)
        if params.lm_head is None:
            logits = x @ params.embed.T
        else:
            logits = x @ params.lm_head
        v = self.cfg.vocab_size
        if (train and v < logits.shape[-1] and self.policy is not None
                and self.policy.splits_last(logits)):
            col = torch.arange(logits.shape[-1], device=self.device)
            return logits.masked_fill(col >= v, float("-inf"))
        return logits[..., :v]

    def _dec_pos(self, params: LMParams, seq: int) -> torch.Tensor:
        """The learned decoder positions of 0..seq-1, zeros past the
        table (the backbone run beyond its design length, as in the JAX
        package; a decode step clamps to the last row instead)."""
        table = params.dec_pos
        if seq <= table.shape[0]:
            return table[:seq]
        return torch.nn.functional.pad(table, (0, 0, 0, seq - table.shape[0]))

    def _positions(self, batch: Dict[str, Any], seq: int,
                   bsz: int) -> torch.Tensor:
        if "positions" in batch:
            return torch.as_tensor(batch["positions"], device=self.device)
        base = torch.arange(seq, dtype=torch.int32,
                            device=self.device)[None].expand(bsz, seq)
        return base[None].expand(3, bsz, seq) if self.cfg.mrope else base

    def _encode(self, params: LMParams, batch: Dict[str, Any],
                x: torch.Tensor, remat: str = "none"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """An encoder-decoder's encoder output, and x with the decoder
        positions added."""
        enc = torch.as_tensor(batch["audio_embeds"],
                              device=self.device).to(x.dtype)
        enc_out = T.encoder_forward(self.cfg, params.stack, enc, remat,
                                    self.policy, self.unroll)
        return enc_out, x + self._dec_pos(params, x.shape[1])[None]

    # ------------------------------------------------------------ forward
    def _forward(self, params: LMParams, batch: Dict[str, Any],
                 train: bool) -> Tuple[torch.Tensor, Any]:
        """(logits of every position, the stack's summed MoE aux loss or
        0.0), recording autograd where grad mode is on.  ``train`` runs
        the stacks under ``self.remat`` and the mamba scans on their
        plain version."""
        cfg = self.cfg
        remat = self.remat if train else "none"
        pol, unroll = self.policy, self.unroll
        batch = self._batch(batch)
        x = self._act(self._embed(params, batch))
        positions = self._positions(batch, x.shape[1], x.shape[0])
        aux = 0.0
        if cfg.family == "encdec":
            enc_out, x = self._encode(params, batch, x, remat)
            x = T.decoder_forward_encdec(cfg, params.stack, x, positions,
                                         enc_out, remat, pol, unroll)
        elif cfg.family == "hybrid":
            x = T.hybrid_forward(cfg, params.stack, x, positions, remat,
                                 train, pol, unroll)
        else:
            x, aux = T.stack_forward(cfg, params.stack, x, positions, remat,
                                     train, pol, unroll)
        return self._logits(params, x, train), aux

    @torch.no_grad()
    def forward(self, params: LMParams, batch: Dict[str, Any]) -> torch.Tensor:
        """Logits of every position.  A stack's summed MoE aux loss (0.0
        without experts) is kept as ``_last_aux``, as the JAX package's
        ``forward`` keeps it."""
        with self._sharded():
            logits, aux = self._forward(params, batch, train=False)
        if self.cfg.family not in ("encdec", "hybrid"):
            self._last_aux = aux
        return logits

    def loss(self, params: LMParams, batch: Dict[str, Any]) -> torch.Tensor:
        """Mean next-token cross entropy over the labels >= 0, as the JAX
        package computes it: float32 logits, logsumexp minus the picked
        logit, masked, divided by max(count, 1); a MoE model adds 0.01 *
        its summed aux loss / n_layers.  A float32 0-d tensor, with an
        autograd graph to the parameters that require grad."""
        with self._sharded():
            batch = self._batch(batch)
            logits, aux = self._forward(params, batch, train=True)
            logits = logits.float()
            labels = torch.as_tensor(batch["labels"],
                                     device=self.device).long()
            lse = torch.logsumexp(logits, dim=-1)
            if self.policy is None:
                picked = logits.gather(-1, labels.clamp(min=0)[..., None]
                                       )[..., 0]
            else:
                picked = self.policy.pick(logits, labels.clamp(min=0))
            mask = (labels >= 0).float()
            loss = (torch.sum((lse - picked) * mask)
                    / torch.clamp(torch.sum(mask), min=1.0))
            if self.cfg.family == "moe":
                loss = loss + 0.01 * aux / max(self.cfg.n_layers, 1)
        return loss

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, cache_len: int) -> T.Cache:
        """An empty cache; a sliding-window model gets a ring buffer of
        the window's size when ``cache_len`` exceeds it.  An ``ssm``
        model's is its layers' zero states (``cache_len`` unused); a
        ``hybrid`` model's nests the states of its mamba layers, grouped
        (groups, every, ...), and the shared block's k/v per group; an
        ``encdec`` model's adds the cross-attention's ``xk``/``xv`` (L, B,
        HKV, encoder_seq, hd), which a prefill fills.  Under a policy the
        cache is laid out by its ``cache_spec``."""
        cache = self._init_cache(batch, cache_len)
        if self.policy is not None:
            cache = self.policy.distribute_cache(cache)
        return cache

    def _init_cache(self, batch: int, cache_len: int) -> T.Cache:
        cfg = self.cfg
        dev = self.device
        if cfg.family == "encdec":
            lead = (cfg.n_layers, batch, cfg.n_kv_heads)
            return {k: torch.zeros(lead + (n, cfg.hd), dtype=self.dtype,
                                   device=dev)
                    for k, n in (("k", cache_len), ("v", cache_len),
                                 ("xk", cfg.encoder_seq),
                                 ("xv", cfg.encoder_seq))}
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
        pol, unroll = self.policy, self.unroll
        with self._sharded():
            batch = self._batch(batch)
            x = self._act(self._embed(params, batch))
            positions = self._positions(batch, x.shape[1], x.shape[0])
            if self.cfg.family == "encdec":
                enc_out, x = self._encode(params, batch, x)
                x, cache = T.decoder_prefill_encdec(
                    self.cfg, params.stack, x, positions, enc_out, cache_len,
                    pol, unroll)
            elif self.cfg.family == "hybrid":
                x, cache = T.hybrid_prefill(self.cfg, params.stack, x,
                                            positions, cache_len, pol, unroll)
            else:
                x, cache = T.stack_prefill(self.cfg, params.stack, x,
                                           positions, cache_len, pol, unroll)
            return self._logits(params, x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, params: LMParams, batch: Dict[str, Any],
                    cache: T.Cache) -> Tuple[torch.Tensor, T.Cache]:
        """One new token per sequence: tokens (B, 1) or embeds (B, 1, D);
        lengths (B,) or a scalar, the current cache fill.  Writes the
        cache in place.  An encoder-decoder adds the decoder position of
        each row's fill, clamped to the table's last row."""
        pol, unroll = self.policy, self.unroll
        with self._sharded():
            batch = self._batch(batch)
            x = self._act(self._embed(params, batch))
            lengths = torch.as_tensor(batch["lengths"],
                                      device=self.device).to(torch.int32)
            if self.cfg.family == "encdec":
                pos = lengths.expand(x.shape[0]).clamp(max=DEC_POS_ROWS - 1)
                x = x + params.dec_pos[pos.long()][:, None]
                x, cache = T.decoder_decode_encdec(self.cfg, params.stack, x,
                                                   cache, lengths, pol, unroll)
            elif self.cfg.family == "hybrid":
                x, cache = T.hybrid_decode(self.cfg, params.stack, x, cache,
                                           lengths, pol, unroll)
            else:
                x, cache = T.stack_decode(self.cfg, params.stack, x, cache,
                                          lengths, pol, unroll)
            return self._logits(params, x), cache

    # --------------------------------------------------------- input specs
    def input_specs(self, shape: ShapeConfig,
                    batch_override: Optional[int] = None) -> Dict[str, Any]:
        """``meta`` tensors of one shape cell's batch (no allocation), as
        the JAX package's ``ShapeDtypeStruct`` stand-ins: a ``train``
        cell's tokens or embeds and labels, a ``prefill`` cell's inputs,
        a ``decode`` cell's one token, ``lengths`` and the cache of
        ``init_cache(batch, seq_len)``.  VLM and audio cells take
        precomputed embeddings; M-RoPE adds ``positions``."""
        cfg = self.cfg
        b = batch_override or shape.global_batch
        s = shape.seq_len

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")
        i32, dt = torch.int32, self.dtype
        if shape.kind in ("train", "prefill"):
            batch: Dict[str, Any] = {}
            if cfg.input_embeds:
                batch["embeds"] = meta((b, s, cfg.d_model), dt)
            else:
                batch["tokens"] = meta((b, s), i32)
            if shape.kind == "train":
                batch["labels"] = meta((b, s), i32)
            if cfg.mrope:
                batch["positions"] = meta((3, b, s), i32)
            if cfg.family == "encdec":
                batch["audio_embeds"] = meta((b, cfg.encoder_seq,
                                              cfg.d_model), dt)
            return batch
        batch = {"lengths": meta((b,), i32)}
        if cfg.input_embeds:
            batch["embeds"] = meta((b, 1, cfg.d_model), dt)
        else:
            batch["tokens"] = meta((b, 1), i32)
        if cfg.mrope:   # the JAX package's decode cell: (B, 1)
            batch["positions"] = meta((b, 1), i32)
        batch["cache"] = Model(cfg, "meta").init_cache(b, s)
        return batch

"""Model/run configuration system.

One ``ModelConfig`` describes every architecture family in the fleet
(dense / MoE / SSM / hybrid / enc-dec / VLM); per-arch modules in this
package instantiate it with the exact assigned hyper-parameters and a
reduced ``smoke()`` variant for CPU tests.  ``ShapeConfig`` describes
the assigned input-shape cells.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0               # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 32000
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope: bool = False             # 3-component M-RoPE (qwen2-vl)
    sliding_window: Optional[int] = None
    attention_impl: str = "naive"   # naive | chunked | flash
    attention_chunk: int = 1024
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # routing-group token bound: tokens route within groups of at most
    # this many tokens, so dispatch/combine stay linear in sequence
    # length (0 = one group per batch row, the einsum-dispatch baseline)
    moe_group_size: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 128
    # hybrid (zamba2): one shared attention block applied every k layers
    hybrid_attn_every: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500
    # frontend stubs: inputs are precomputed embeddings, not token ids
    input_embeds: bool = False
    # norm / mlp style
    norm_type: str = "rms"          # rms | layer
    mlp_type: str = "gated_silu"    # gated_silu | gelu
    pos_embedding: str = "rope"     # rope | learned | none
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_position: int = 1 << 20
    dtype: str = "bfloat16"
    # roofline dry-run: unroll inner chunk scans (attention/SSD) so XLA
    # cost_analysis counts every iteration (while bodies count once)
    scan_unroll: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, h, kv = self.hd, self.n_heads, self.n_kv_heads
        n = 0
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        mlp_dense = 3 * d * f if self.mlp_type == "gated_silu" else 2 * d * f
        if self.family in ("dense", "vlm"):
            n += self.n_layers * (attn + mlp_dense + 2 * d)
        elif self.family == "moe":
            moe = self.n_experts * 3 * d * f + d * self.n_experts
            n += self.n_layers * (attn + moe + 2 * d)
        elif self.family == "ssm":
            n += self.n_layers * self._mamba_block_params()
        elif self.family == "hybrid":
            n += self.n_layers * self._mamba_block_params()
            n += attn + mlp_dense + 2 * d  # one shared block
        elif self.family == "encdec":
            enc = self.encoder_layers * (attn + mlp_dense + 2 * d)
            dec = self.n_layers * (2 * attn + mlp_dense + 3 * d)
            n += enc + dec
        n += v * d                      # embed
        if not self.tie_embeddings:
            n += v * d                  # lm head
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_moe = self.n_experts * 3 * d * f
        active_moe = self.top_k * 3 * d * f
        return self.param_count() - self.n_layers * (dense_moe - active_moe)

    def _mamba_block_params(self) -> int:
        d, di = self.d_model, self.d_inner
        g, ns = self.ssm_ngroups, self.ssm_state
        nh = self.ssm_nheads
        in_proj = d * (2 * di + 2 * g * ns + nh)
        conv = self.ssm_conv_kernel * (di + 2 * g * ns)
        out_proj = di * d
        return in_proj + conv + out_proj + 2 * nh + di + 2 * d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

ALL_SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}

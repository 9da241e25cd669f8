"""zamba2-2.7b [hybrid] — Mamba2 blocks + shared attention block
[arXiv:2411.15242; hf].

54 mamba2 layers with ONE weight-shared attention+MLP block applied
every 6 layers (zamba2's concat-with-embedding input to the shared
block is simplified to the running hidden state — DESIGN.md)."""
import dataclasses
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=10240, vocab_size=32000,
        ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
        ssm_chunk=256, hybrid_attn_every=6, rope_theta=1e4,
        attention_impl="chunked",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, ssm_state=16,
        ssm_headdim=16, ssm_chunk=16, hybrid_attn_every=2,
        dtype="float32", attention_impl="naive")

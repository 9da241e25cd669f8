"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only: the vision frontend is a stub — input_specs() provides
precomputed patch embeddings (B, S, D) plus (3, B, S) M-RoPE ids."""
import dataclasses
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
        d_ff=8960, vocab_size=151936,
        qkv_bias=True, mrope=True, rope_theta=1e6, input_embeds=True,
        attention_impl="chunked",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, dtype="float32",
        attention_impl="naive")

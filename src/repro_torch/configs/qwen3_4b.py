"""qwen3-4b [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B; hf]."""
import dataclasses
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=9728, vocab_size=151936,
        qk_norm=True, rope_theta=1e6,
        attention_impl="chunked",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=160, vocab_size=256, dtype="float32",
        attention_impl="naive")

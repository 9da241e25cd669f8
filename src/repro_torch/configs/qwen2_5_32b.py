"""qwen2.5-32b [dense] — GQA kv=8, QKV bias [hf:Qwen/Qwen2.5; hf]."""
import dataclasses
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=27648, vocab_size=152064,
        qkv_bias=True, rope_theta=1e6,
        attention_impl="chunked",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=192, vocab_size=256, dtype="float32",
        attention_impl="naive")

"""granite-moe-1b-a400m [moe] — 32 experts top-8, GQA kv=8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
import dataclasses
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab_size=49155,
        n_experts=32, top_k=8, rope_theta=1e4, tie_embeddings=True,
        attention_impl="chunked",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=256, n_experts=4, top_k=2, capacity_factor=8.0,
        dtype="float32", attention_impl="naive")

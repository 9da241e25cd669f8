"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA [arXiv:2401.16818]."""
import dataclasses
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
        d_ff=10240, vocab_size=32000,
        sliding_window=4096, rope_theta=1e4,
        attention_impl="chunked",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=160, vocab_size=256, sliding_window=32,
        dtype="float32", attention_impl="naive")

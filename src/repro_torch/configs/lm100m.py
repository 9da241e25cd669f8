"""~100M-parameter dense LM for the end-to-end training example
(deliverable b): 12L x d768, llama-style, tied embeddings (~138M with
the 32k embedding table, ~113M non-embedding)."""
import dataclasses
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="lm100m", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=3072, vocab_size=32000, tie_embeddings=True,
        rope_theta=1e4, dtype="float32", attention_impl="naive",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=64,
                               n_heads=4, n_kv_heads=2, head_dim=16,
                               d_ff=128, vocab_size=512)

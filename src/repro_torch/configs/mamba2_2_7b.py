"""mamba2-2.7b [ssm] — SSD, attention-free [arXiv:2405.21060; unverified]."""
import dataclasses
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
        ssm_chunk=256, pos_embedding="none", tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, ssm_state=16, ssm_headdim=16,
        ssm_chunk=16, vocab_size=256, dtype="float32")

"""llama4-scout-17b-a16e [moe] — 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Treated as full attention per the assigned config (the production
model's chunked-attention variant is not part of the assignment —
see DESIGN.md); therefore long_500k is skipped for this arch."""
import dataclasses
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        n_experts=16, top_k=1, rope_theta=5e5,
        attention_impl="chunked",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=256, n_experts=4, top_k=1, capacity_factor=8.0,
        dtype="float32", attention_impl="naive")

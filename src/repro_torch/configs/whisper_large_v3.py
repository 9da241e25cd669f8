"""whisper-large-v3 [audio] — enc-dec, conv frontend stubbed
[arXiv:2212.04356; unverified].

Backbone only: input_specs() provides precomputed 1500-frame encoder
embeddings; the decoder backbone is exercised at the assigned sequence
lengths even though production Whisper caps decoding at 448 tokens
(see DESIGN.md arch notes)."""
import dataclasses
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        n_layers=32, encoder_layers=32, d_model=1280,
        n_heads=20, n_kv_heads=20, head_dim=64,
        d_ff=5120, vocab_size=51866, encoder_seq=1500,
        norm_type="layer", mlp_type="gelu", pos_embedding="learned",
        qkv_bias=True, attention_impl="chunked",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        encoder_seq=16, dtype="float32", attention_impl="naive")

"""Architecture registry: the 10 assigned archs + the paper's CNNs.

``get(name)`` returns the full assigned config; ``get_smoke(name)``
returns the reduced same-family config used by the CPU smoke tests.
"""
from __future__ import annotations

from .base import ModelConfig, ShapeConfig, ALL_SHAPES  # noqa: F401
from . import (qwen2_1_5b, qwen3_4b, qwen2_5_32b, h2o_danube3_4b,
               granite_moe_1b, llama4_scout, qwen2_vl_2b, mamba2_2_7b,
               whisper_large_v3, zamba2_2_7b, lm100m)

_MODULES = {
    "qwen2-1.5b": qwen2_1_5b,
    "qwen3-4b": qwen3_4b,
    "qwen2.5-32b": qwen2_5_32b,
    "h2o-danube-3-4b": h2o_danube3_4b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "llama4-scout-17b-a16e": llama4_scout,
    "qwen2-vl-2b": qwen2_vl_2b,
    "mamba2-2.7b": mamba2_2_7b,
    "whisper-large-v3": whisper_large_v3,
    "zamba2-2.7b": zamba2_2_7b,
}

# extra (non-assigned) configs usable via get()/get_smoke()
_EXTRAS = {"lm100m": lm100m}

ARCH_NAMES = tuple(_MODULES)


def get(name: str) -> ModelConfig:
    return {**_MODULES, **_EXTRAS}[name].config()


def get_smoke(name: str) -> ModelConfig:
    return {**_MODULES, **_EXTRAS}[name].smoke()


def supports_shape(name: str, shape: str) -> bool:
    """Shape-cell applicability (skip table in DESIGN.md)."""
    if shape != "long_500k":
        return True
    # long_500k needs sub-quadratic live state: SWA / SSM / hybrid only.
    return name in ("h2o-danube-3-4b", "mamba2-2.7b", "zamba2-2.7b")

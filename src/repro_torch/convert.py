"""Carry a model and its quantization across from plain data.

The inputs are plain data only — an ONNX-lite model dict (the format of
``onnx_lite.to_model_dict``), its initializers as numpy arrays, and
quantization specs as ``{layer: (m_w, m_x, m_y)}`` with ints or int
tuples — so any exporter that writes that format, the JAX package's
included, hands the port the same weights and the same specs.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import onnx_lite
from repro_torch.core.graph import Graph
from repro_torch.core.quantize import QuantSpec

SpecTuple = Tuple[Union[int, Sequence[int]], int, int]


def graph_from_model_dict(model: Mapping,
                          initializers: Mapping[str, np.ndarray]) -> Graph:
    """A port ``Graph`` from a model dict and its initializers."""
    inits = {k: np.array(v, copy=True) for k, v in initializers.items()}
    return onnx_lite.from_model_dict(dict(model), inits)


def spec(m_w, m_x: int, m_y: int) -> QuantSpec:
    """A port ``QuantSpec``: ``m_w`` an int or a per-Cout int sequence."""
    if isinstance(m_w, (tuple, list, np.ndarray)):
        m_w = tuple(int(v) for v in m_w)
    else:
        m_w = int(m_w)
    return QuantSpec(m_w=m_w, m_x=int(m_x), m_y=int(m_y))


def specs_from_tuples(specs: Mapping[str, SpecTuple]) -> Dict[str, QuantSpec]:
    """Port ``QuantSpec``s from ``{layer: (m_w, m_x, m_y)}``."""
    return {name: spec(*t) for name, t in specs.items()}

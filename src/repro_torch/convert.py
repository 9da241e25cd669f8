"""Carry a model and its quantization across from plain data.

The inputs are plain data only — an ONNX-lite model dict (the format of
``onnx_lite.to_model_dict``), its initializers as numpy arrays, and
quantization specs as ``{layer: (m_w, m_x, m_y)}`` with ints or int
tuples — so any exporter that writes that format, the JAX package's
included, hands the port the same weights and the same specs.  An LM's
parameters come across as the JAX package's parameter tree with numpy
leaves (:func:`lm_params_from_numpy`), for every family.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import device as tdevice
from repro_torch.configs.base import ModelConfig
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


def _fill(module: torch.nn.Module, tree: Mapping, layer=None) -> None:
    """Copy ``tree``'s leaves into the same-named parameters of
    ``module``.  ``layer`` picks one slice of leaves stacked over layers;
    a ``ModuleList`` child takes a stacked subtree, one slice a layer."""
    names = ({n for n, _ in module.named_parameters(recurse=False)}
             | {n for n, _ in module.named_children()})
    if set(tree) != names:
        raise ValueError(f"{type(module).__name__}: parameters "
                         f"{sorted(names)}, tree keys {sorted(tree)}")
    for name, leaf in tree.items():
        child = getattr(module, name)
        if isinstance(child, torch.nn.ModuleList):
            for i, sub in enumerate(child):
                _fill(sub, leaf, i)
        elif isinstance(child, torch.nn.Module):
            _fill(child, leaf, layer)
        else:
            arr = np.asarray(leaf if layer is None else leaf[layer])
            if tuple(arr.shape) != tuple(child.shape):
                raise ValueError(f"{name}: {arr.shape} into "
                                 f"{tuple(child.shape)}")
            with torch.no_grad():
                child.copy_(torch.from_numpy(arr.astype(np.float32)))


def lm_params_from_numpy(cfg: ModelConfig, tree: Mapping,
                         device: tdevice.DeviceLike = None):
    """The port's parameters of an LM from the JAX package's
    ``Model.init`` tree with numpy leaves: ``embed`` (none with input
    embeddings), ``final_norm``, ``lm_head`` when the head is untied, and
    ``stack``, whose leaves are stacked over layers as (L, ...) (dense,
    ``moe`` with its ``moe`` subtree, ``vlm`` and ``ssm``), or for a
    ``hybrid`` model ``stack.mamba_stack`` stacked so and
    ``stack.shared_attn`` unstacked, or for an ``encdec`` model
    ``stack.encoder`` and ``stack.decoder`` stacked so, ``stack.enc_norm``
    and ``dec_pos``.  Each leaf takes its parameter's dtype: an MoE
    router stays float32 in a bf16 model."""
    from repro_torch.models.model import Model
    params = Model(cfg, device).empty_params()
    _fill(params, tree)
    return params

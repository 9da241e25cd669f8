"""Carry a model and its quantization across from plain data.

The inputs are plain data only — an ONNX-lite model dict (the format of
``onnx_lite.to_model_dict``), its initializers as numpy arrays, and
quantization specs as ``{layer: (m_w, m_x, m_y)}`` with ints or int
tuples — so any exporter that writes that format, the JAX package's
included, hands the port the same weights and the same specs.  An LM's
parameters come across as the JAX package's parameter tree with numpy
leaves (:func:`lm_params_from_numpy`), for every family, and go back
the other way (:func:`lm_params_to_numpy`); a train state too
(:func:`train_state_to_numpy`, :func:`train_state_from_numpy`), in the
layout the checkpoints of both packages share.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

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


def _as_torch(leaf: Any) -> torch.Tensor:
    """A tensor of a tree leaf: a tensor as it is, a numpy array (an
    ``ml_dtypes`` bfloat16 one too) without a copy where it is writable
    and contiguous."""
    if torch.is_tensor(leaf):
        return leaf
    arr = np.asarray(leaf)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _fill(module: torch.nn.Module, tree: Mapping, layer=None,
          named: Optional[Dict[str, torch.Tensor]] = None,
          prefix: str = "") -> None:
    """Copy ``tree``'s leaves into the same-named parameters of
    ``module``, or with ``named`` into ``named[<parameter name>]``.
    ``layer`` picks one slice of leaves stacked over layers; a
    ``ModuleList`` child takes a stacked subtree, one slice a layer."""
    names = ({n for n, _ in module.named_parameters(recurse=False)}
             | {n for n, _ in module.named_children()})
    if set(tree) != names:
        raise ValueError(f"{type(module).__name__}: parameters "
                         f"{sorted(names)}, tree keys {sorted(tree)}")
    for name, leaf in tree.items():
        child = getattr(module, name)
        if isinstance(child, torch.nn.ModuleList):
            for i, sub in enumerate(child):
                _fill(sub, leaf, i, named, f"{prefix}{name}.{i}.")
        elif isinstance(child, torch.nn.Module):
            _fill(child, leaf, layer, named, f"{prefix}{name}.")
        else:
            src = _as_torch(leaf if layer is None else leaf[layer])
            dst = child if named is None else named[prefix + name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: {tuple(src.shape)} into "
                                 f"{tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(src)


def _stacked(trees: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    return {k: _stacked([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _tree(module: torch.nn.Module, named: Mapping[str, torch.Tensor],
          device, prefix: str = "") -> Dict[str, Any]:
    """The JAX package's tree of ``module``'s parameters, each leaf taken
    from ``named[<parameter name>]`` on ``device``, a ``ModuleList``'s
    layers stacked as (L, ...)."""
    out: Dict[str, Any] = {}
    for name, _ in module.named_parameters(recurse=False):
        out[name] = named[prefix + name].detach().to(device)
    for name, child in module.named_children():
        if isinstance(child, torch.nn.ModuleList):
            out[name] = _stacked([_tree(sub, named, device,
                                        f"{prefix}{name}.{i}.")
                                  for i, sub in enumerate(child)])
        else:
            out[name] = _tree(child, named, device, f"{prefix}{name}.")
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy; bfloat16 as ``ml_dtypes.bfloat16`` (the
    JAX package's dtype; ``ml_dtypes`` is needed only then)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(fn, tree):
    return ({k: _map(fn, v) for k, v in tree.items()}
            if isinstance(tree, dict) else fn(tree))


def _structure(cfg: ModelConfig) -> torch.nn.Module:
    """The parameter modules of ``cfg``'s model on the ``meta`` device."""
    from repro_torch.models.model import Model
    return Model(cfg, "meta").empty_params()


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


def named_to_numpy(cfg: ModelConfig,
                   named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors keyed by the port's parameter names (parameters,
    gradients, an optimizer's masters or moments) as the JAX package's
    tree of ``cfg``'s model with numpy leaves, layers stacked as (L,
    ...)."""
    return _map(_numpy, _tree(_structure(cfg), named, "cpu"))


def lm_params_to_numpy(cfg: ModelConfig, params) -> Dict[str, Any]:
    """The inverse of :func:`lm_params_from_numpy`: the JAX package's
    ``Model.init`` tree of ``params`` with numpy leaves."""
    return named_to_numpy(cfg, dict(params.named_parameters()))


def train_state_to_tree(cfg: ModelConfig, state: Mapping[str, Any],
                        device="cpu") -> Dict[str, Any]:
    """A train state (``optim.init_train_state``) in the JAX package's
    layout, ``{"params", "opt": {"master", "mu"[, "nu"]}, "step"[,
    "ef"]}``, with tensor leaves on ``device`` (``"meta"`` gives a
    checkpoint skeleton and copies nothing) and ``step`` a 0-d int32."""
    structure = _structure(cfg)
    tree = {"params": _tree(structure, dict(state["params"]
                                            .named_parameters()), device),
            "opt": {k: _tree(structure, v, device)
                    for k, v in state["opt"].items()},
            "step": torch.tensor(int(state["step"]), dtype=torch.int32,
                                 device=device)}
    if "ef" in state:
        tree["ef"] = _tree(structure, state["ef"], device)
    return tree


def train_state_to_numpy(cfg: ModelConfig,
                         state: Mapping[str, Any]) -> Dict[str, Any]:
    """:func:`train_state_to_tree` with numpy leaves: the JAX package's
    train state of the same values."""
    return _map(_numpy, train_state_to_tree(cfg, state))


def train_state_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                           state: Dict[str, Any]) -> Dict[str, Any]:
    """Fill ``state`` in place from a train state in the JAX package's
    layout (numpy or tensor leaves: the JAX package's state, or a
    restored checkpoint of either package).  Returns ``state``."""
    structure = _structure(cfg)
    if set(tree["opt"]) != set(state["opt"]):
        raise ValueError(f"optimizer state {sorted(tree['opt'])} into "
                         f"{sorted(state['opt'])}")
    if ("ef" in tree) != ("ef" in state):
        raise ValueError("error-feedback buffers in only one of the states")
    _fill(state["params"], tree["params"])
    for k, named in state["opt"].items():
        _fill(structure, tree["opt"][k], named=named)
    if "ef" in state:
        _fill(structure, tree["ef"], named=state["ef"])
    state["step"] = int(_as_torch(tree["step"]))
    return state

"""ONNX-compatible transport layer (framework-neutral model exchange).

The paper uses ONNX protobufs as its "model transfer layer" so the
synthesis tool is decoupled from whatever ML framework produced the model
(§4.1).  The ``onnx`` package is not available offline, so this module
implements the same *contract* with a JSON + npz container:

  model.json  — graph topology: nodes with ONNX ``op_type`` names, attrs
  model.npz   — initializers (weights/biases) keyed by tensor name

``from_model_dict``/``to_model_dict`` are the in-memory equivalents, and
exporters are provided for the builder DSL in ``repro_torch.models.cnn`` so any
front end that can emit this dict (Keras/PyTorch exporters emit ONNX with
the same op names) plugs in unchanged.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from .graph import Graph, GraphError, GraphValidationError, Node, TensorInfo

FORMAT_VERSION = 1


def validate_initializers(initializers: Optional[Dict[str, np.ndarray]],
                          ) -> None:
    """Reject non-finite imported weights at the door.

    A NaN/Inf in an initializer silently poisons calibration (max-abs
    over NaN is NaN -> every quantized value is garbage), so ingress is
    the only place it can be caught cheaply and attributed to a tensor.
    """
    for name, arr in (initializers or {}).items():
        arr = np.asarray(arr)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad = int(np.size(arr) - np.isfinite(arr).sum())
            raise GraphValidationError(
                "non-finite initializer", tensor=name,
                detail=f"{bad} NaN/Inf of {arr.size} values")


def to_model_dict(graph: Graph) -> Dict[str, Any]:
    return {
        "format_version": FORMAT_VERSION,
        "name": graph.name,
        "inputs": [
            {"name": t.name, "shape": list(t.shape), "dtype": t.dtype}
            for t in graph.inputs
        ],
        "outputs": list(graph.outputs),
        "nodes": [
            {
                "op_type": n.op_type,
                "name": n.name,
                "inputs": list(n.inputs),
                "outputs": list(n.outputs),
                "attrs": _jsonify_attrs(n.attrs),
            }
            for n in graph.nodes
        ],
    }


def from_model_dict(
    model: Dict[str, Any], initializers: Optional[Dict[str, np.ndarray]] = None
) -> Graph:
    if model.get("format_version", 1) > FORMAT_VERSION:
        raise ValueError("model produced by a newer exporter")
    for key in ("nodes", "inputs", "outputs"):
        if not isinstance(model.get(key), list):
            raise GraphValidationError("malformed model container",
                                       detail=f"missing/non-list {key!r}")
    try:
        nodes = [
            Node(
                op_type=n["op_type"],
                name=n.get("name", f'{n["op_type"]}_{i}'),
                inputs=list(n["inputs"]),
                outputs=list(n["outputs"]),
                attrs=dict(n.get("attrs", {})),
            )
            for i, n in enumerate(model["nodes"])
        ]
        inputs = [
            TensorInfo(t["name"], tuple(t["shape"]), t.get("dtype", "float32"))
            for t in model["inputs"]
        ]
    except (KeyError, TypeError) as e:
        raise GraphValidationError("malformed model container",
                                   detail=repr(e)) from e
    validate_initializers(initializers)
    try:
        return Graph(
            name=model.get("name", "model"),
            nodes=nodes,
            inputs=inputs,
            outputs=list(model["outputs"]),
            initializers=initializers,
        )
    except GraphValidationError:
        raise
    except GraphError as e:
        # structural problems in an *imported* model are ingress failures
        raise GraphValidationError("invalid graph structure",
                                   detail=str(e)) from e


def save(graph: Graph, path: str) -> None:
    """Write ``<path>.json`` + ``<path>.npz``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".json", "w") as f:
        json.dump(to_model_dict(graph), f, indent=1)
    np.savez(path + ".npz", **graph.initializers)


def load(path: str) -> Graph:
    with open(path + ".json") as f:
        model = json.load(f)
    inits: Dict[str, np.ndarray] = {}
    npz_path = path + ".npz"
    if os.path.exists(npz_path):
        with np.load(npz_path) as z:
            inits = {k: z[k] for k in z.files}
    return from_model_dict(model, inits)


def _jsonify_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        elif isinstance(v, tuple):
            out[k] = list(v)
        else:
            out[k] = v
    return out

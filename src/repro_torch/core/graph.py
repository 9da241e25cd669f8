"""Neutral dataflow IR for CNN2Gate-style model analysis.

This is the "extensible acyclic graph" of the paper's §4.1: nodes are
operators with ONNX-compatible ``op_type`` strings, edges are named
tensors.  Shape inference for Conv/MaxPool follows Eq. (3)/(4) of the
paper exactly (floor-division form with pads/dilations/strides).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ONNX operator names the front-end parser understands (§4.1 of the paper).
SUPPORTED_OPS = (
    "Conv",
    "MaxPool",
    "AveragePool",
    "Relu",
    "Clip",  # ReLU-n (Clip with min 0, e.g. ReLU6): fused into a conv
    "Gemm",
    "MatMul",
    "Softmax",
    "Flatten",
    "Reshape",
    "Add",
    "Concat",
    "GlobalAveragePool",
    "Dropout",  # inference no-op; parsed and elided
    "Identity",
)


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """Shape/dtype metadata for a named edge in the graph."""

    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


@dataclasses.dataclass
class Node:
    """A single operator node, ONNX-flavoured."""

    op_type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def attr(self, key: str, default: Any = None) -> Any:
        return self.attrs.get(key, default)


class GraphError(ValueError):
    pass


class GraphValidationError(GraphError):
    """Structured ingress-validation failure.

    Raised when an imported model is rejected *before* any staging work:
    non-finite weights, malformed containers, dangling edges.  Carries
    machine-readable fields so callers (CLI, serving admission) can
    report what was wrong without parsing the message.
    """

    def __init__(self, reason: str, *, node: str = "", tensor: str = "",
                 detail: str = ""):
        self.reason = reason
        self.node = node
        self.tensor = tensor
        self.detail = detail
        where = " ".join(p for p in (
            f"node={node}" if node else "",
            f"tensor={tensor}" if tensor else "") if p)
        msg = reason + (f" [{where}]" if where else "")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def conv_output_hw(
    in_hw: Sequence[int],
    kernel_shape: Sequence[int],
    strides: Sequence[int],
    pads: Sequence[int],
    dilations: Sequence[int],
) -> Tuple[int, int]:
    """Eq. (3) of the paper: floor((x + 2p - d(ks-1) - 1)/st + 1).

    ``pads`` is ONNX-style (pad_top, pad_left, pad_bottom, pad_right); the
    paper's 2p corresponds to pad_begin + pad_end per spatial dim.
    """
    h_in, w_in = int(in_hw[0]), int(in_hw[1])
    ks, st, d = kernel_shape, strides, dilations
    p_sum = (pads[0] + pads[2], pads[1] + pads[3])
    h_out = math.floor((h_in + p_sum[0] - d[0] * (ks[0] - 1) - 1) / st[0] + 1)
    w_out = math.floor((w_in + p_sum[1] - d[1] * (ks[1] - 1) - 1) / st[1] + 1)
    if h_out <= 0 or w_out <= 0:
        raise GraphError(
            f"Eq.(3) produced non-positive output dims {h_out}x{w_out} for "
            f"input {h_in}x{w_in} ks={ks} st={st} p={pads} d={d}"
        )
    return h_out, w_out


def _norm4(pads: Optional[Sequence[int]]) -> Tuple[int, int, int, int]:
    if pads is None:
        return (0, 0, 0, 0)
    if len(pads) == 2:  # symmetric shorthand
        return (pads[0], pads[1], pads[0], pads[1])
    if len(pads) == 4:
        return tuple(int(p) for p in pads)  # type: ignore[return-value]
    raise GraphError(f"bad pads {pads}")


def _norm2(v: Optional[Sequence[int]], default: int = 1) -> Tuple[int, int]:
    if v is None:
        return (default, default)
    if isinstance(v, int):
        return (v, v)
    if len(v) == 1:
        return (int(v[0]), int(v[0]))
    return (int(v[0]), int(v[1]))


class Graph:
    """Acyclic dataflow graph with topological node order.

    ``initializers`` holds weights/biases (numpy arrays) keyed by tensor
    name — the analogue of the ONNX initializer list the paper's parser
    extracts alongside the dataflow.
    """

    def __init__(
        self,
        name: str,
        nodes: Iterable[Node],
        inputs: Sequence[TensorInfo],
        outputs: Sequence[str],
        initializers: Optional[Dict[str, np.ndarray]] = None,
    ) -> None:
        self.name = name
        self.nodes: List[Node] = list(nodes)
        self.inputs: List[TensorInfo] = list(inputs)
        self.outputs: List[str] = list(outputs)
        self.initializers: Dict[str, np.ndarray] = dict(initializers or {})
        self._validate()
        self.nodes = self._toposort()
        self.tensor_shapes: Dict[str, Tuple[int, ...]] = {}
        self._infer_shapes()
        # Producer/consumer adjacency, built once: the parser queries
        # these inside per-node loops, so the O(nodes) scans the naive
        # producer_of/consumers_of would do turn quadratic on deep nets.
        self._producer: Dict[str, Node] = {}
        self._consumers: Dict[str, List[Node]] = {}
        for n in self.nodes:
            for o in n.outputs:
                self._producer[o] = n
            for i in n.inputs:
                self._consumers.setdefault(i, []).append(n)

    # -- structure ----------------------------------------------------
    def _validate(self) -> None:
        producers: Dict[str, str] = {}
        for t in self.inputs:
            producers[t.name] = "<graph-input>"
        for name in self.initializers:
            producers[name] = "<initializer>"
        for n in self.nodes:
            if n.op_type not in SUPPORTED_OPS:
                raise GraphError(f"unsupported op_type {n.op_type!r} in node {n.name}")
            for o in n.outputs:
                if o in producers:
                    raise GraphError(f"tensor {o!r} produced twice")
                producers[o] = n.name
        for n in self.nodes:
            for i in n.inputs:
                if i not in producers:
                    raise GraphError(f"node {n.name} consumes undefined tensor {i!r}")
        for o in self.outputs:
            if o not in producers:
                raise GraphError(f"graph output {o!r} never produced")

    def _toposort(self) -> List[Node]:
        ready = {t.name for t in self.inputs} | set(self.initializers)
        pending = list(self.nodes)
        ordered: List[Node] = []
        while pending:
            progressed = False
            rest: List[Node] = []
            for n in pending:
                if all(i in ready for i in n.inputs):
                    ordered.append(n)
                    ready.update(n.outputs)
                    progressed = True
                else:
                    rest.append(n)
            pending = rest
            if not progressed:
                raise GraphError(
                    "graph has a cycle or disconnected nodes: "
                    + ", ".join(n.name for n in pending)
                )
        return ordered

    # -- shape inference (Eq. 3/4) -------------------------------------
    def _infer_shapes(self) -> None:
        shapes = self.tensor_shapes
        for t in self.inputs:
            shapes[t.name] = tuple(t.shape)
        for name, arr in self.initializers.items():
            shapes[name] = tuple(arr.shape)
        for n in self.nodes:
            fn = getattr(self, f"_shape_{n.op_type.lower()}", None)
            if fn is None:
                raise GraphError(f"no shape rule for {n.op_type}")
            out_shapes = fn(n, [shapes[i] for i in n.inputs])
            for o, s in zip(n.outputs, out_shapes):
                shapes[o] = tuple(int(x) for x in s)

    # All activation tensors are NCHW (ONNX convention).
    def _shape_conv(self, n: Node, ins):
        x, w = ins[0], ins[1]
        if len(x) != 4 or len(w) != 4:
            raise GraphError(f"Conv {n.name} expects 4-D input/weight, got {x}/{w}")
        group = int(n.attr("group", 1))
        if x[1] != w[1] * group:
            raise GraphError(
                f"Conv {n.name}: C_in mismatch x={x} w={w} group={group}"
            )
        ks = _norm2(n.attr("kernel_shape", (w[2], w[3])))
        st = _norm2(n.attr("strides", 1))
        d = _norm2(n.attr("dilations", 1))
        p = _norm4(n.attr("pads"))
        h, wo = conv_output_hw(x[2:], ks, st, p, d)
        return [(x[0], w[0], h, wo)]

    def _shape_maxpool(self, n: Node, ins):
        (x,) = ins[:1]
        ks = _norm2(n.attr("kernel_shape"))
        st = _norm2(n.attr("strides", ks[0]))
        d = _norm2(n.attr("dilations", 1))
        p = _norm4(n.attr("pads"))
        h, w = conv_output_hw(x[2:], ks, st, p, d)
        # Eq. (4): c_out = c_in for pooling.
        return [(x[0], x[1], h, w)]

    _shape_averagepool = _shape_maxpool

    def _shape_globalaveragepool(self, n: Node, ins):
        (x,) = ins[:1]
        return [(x[0], x[1], 1, 1)]

    def _shape_relu(self, n: Node, ins):
        return [ins[0]]

    _shape_softmax = _shape_relu
    _shape_identity = _shape_relu
    _shape_clip = _shape_relu

    def _shape_dropout(self, n: Node, ins):
        return [ins[0]] * max(1, len(n.outputs))

    def _shape_add(self, n: Node, ins):
        a, b = ins
        if tuple(a) != tuple(b):
            raise GraphError(f"Add {n.name}: shape mismatch {a} vs {b}")
        return [a]

    def _shape_concat(self, n: Node, ins):
        axis = int(n.attr("axis", 1))
        base = list(ins[0])
        axis = axis % len(base)
        for s in ins[1:]:
            if len(s) != len(base) or any(
                    a != b for d, (a, b) in enumerate(zip(s, base))
                    if d != axis):
                raise GraphError(f"Concat {n.name}: incompatible {ins}")
        base[axis] = sum(s[axis] for s in ins)
        return [tuple(base)]

    def _shape_flatten(self, n: Node, ins):
        (x,) = ins[:1]
        axis = int(n.attr("axis", 1))
        lead = int(np.prod(x[:axis])) if axis else 1
        return [(lead, int(np.prod(x[axis:])))]

    def _shape_reshape(self, n: Node, ins):
        x = ins[0]
        target = n.attr("shape")
        if target is None and len(n.inputs) > 1:
            target = self.initializers[n.inputs[1]].tolist()
        target = [int(t) for t in target]
        total = int(np.prod(x))
        if -1 in target:
            idx = target.index(-1)
            known = int(np.prod([t for t in target if t != -1]))
            target[idx] = total // known
        if int(np.prod(target)) != total:
            raise GraphError(f"Reshape {n.name}: {x} -> {target} size mismatch")
        return [tuple(target)]

    def _shape_gemm(self, n: Node, ins):
        a, b = ins[0], ins[1]
        trans_a = int(n.attr("transA", 0))
        trans_b = int(n.attr("transB", 0))
        m, k = (a[1], a[0]) if trans_a else (a[0], a[1])
        kb, nn = (b[1], b[0]) if trans_b else (b[0], b[1])
        if k != kb:
            raise GraphError(f"Gemm {n.name}: K mismatch {a}x{b} tA={trans_a} tB={trans_b}")
        return [(m, nn)]

    def _shape_matmul(self, n: Node, ins):
        a, b = ins
        if a[-1] != b[-2 if len(b) > 1 else 0]:
            raise GraphError(f"MatMul {n.name}: {a} @ {b}")
        return [tuple(a[:-1]) + (b[-1],)]

    # -- convenience ----------------------------------------------------
    def producer_of(self, tensor: str) -> Optional[Node]:
        return self._producer.get(tensor)

    def consumers_of(self, tensor: str) -> List[Node]:
        return list(self._consumers.get(tensor, ()))

    def shape(self, tensor: str) -> Tuple[int, ...]:
        return self.tensor_shapes[tensor]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Graph({self.name!r}, {len(self.nodes)} nodes)"

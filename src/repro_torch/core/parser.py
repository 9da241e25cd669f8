"""Front-end parser: ONNX-lite graph -> DAG stage program of LayerInfo.

This is §4.1's parser: it traverses graph nodes in topological order,
extracts per-layer synthesis information (kernel shape, strides, pads,
dilations, weights, biases), detects the Relu/Clip/Softmax activations
that follow compute nodes, and fuses Conv→Relu→MaxPool chains into single
pipeline stages — the paper's "combination of memory read/write,
convolution and pooling kernels" (Fig. 6 caption).

The result is a **topologically-scheduled stage program** over named
tensors (the paper's "extensible acyclic graph"): each stage reads one
or more named input tensors and produces one output tensor, tensors may
have multiple consumers (fan-out), ``Add`` is a first-class
residual-merge stage and ``Concat`` a channel-merge stage — so
ResNet-class skip connections and Inception-style merges schedule
exactly like the linear Conv→Pool→FC chains of the paper's Fig. 6.
Pure data-movement ops (Flatten/Reshape/Dropout/Identity) that are not
fused into a stage are resolved through an alias map, so stage inputs
always name tensors some scheduled stage (or the graph input) produces.
The linked prev/next structure of the paper is preserved over the
schedule order, and the feasible (N_i, N_l) option sets extend the §4.2
divisibility constraints to branch and depthwise layers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .graph import Graph, GraphValidationError, Node, _norm2, _norm4

# Pipeline stage kinds (the paper's five kernel roles; memory read/write
# kernels bracket every stage implicitly).
CONV = "conv"
POOL = "pool"
FC = "fc"  # Gemm — executed on the conv kernel with pool as pass-through
ADD = "add"        # residual merge: elementwise int8 add + requantize
CONCAT = "concat"  # channel merge: int8 concat at a common scale

#: Pure data-movement ops: elided from the stage program (the memory
#: read/write kernels absorb them); unfused occurrences become aliases.
ELIDED_OPS = ("Flatten", "Reshape", "Dropout", "Identity")


@dataclasses.dataclass
class LayerInfo:
    """One pipelined stage: conv/fc (+fused relu) (+fused pool), or a
    residual/channel merge (add/concat) over two or more named tensors."""

    kind: str
    name: str
    # named tensors: every entry of ``inputs`` is produced by an earlier
    # stage in the schedule (or is the graph input); ``output`` is the
    # stage's single product (post-fusion name)
    inputs: List[str]
    output: str
    weight: Optional[str] = None
    bias: Optional[str] = None
    # shapes (NCHW for conv/pool; (M,K)x(K,N) for fc)
    in_shape: Tuple[int, ...] = ()
    out_shape: Tuple[int, ...] = ()
    # conv/pool attrs
    kernel_shape: Tuple[int, int] = (1, 1)
    strides: Tuple[int, int] = (1, 1)
    pads: Tuple[int, int, int, int] = (0, 0, 0, 0)
    dilations: Tuple[int, int] = (1, 1)
    group: int = 1
    axis: int = 1                       # concat axis (NCHW convention)
    # fused ops
    relu: bool = False
    # a fused ReLU-n (ONNX Clip with min 0): its real upper bound n, which
    # pipeline.build_quantized turns into the stage's clamp code
    # (DESIGN.md, "ReLU-n fixed-point rule"); ``relu`` is set with it
    clip_max: Optional[float] = None
    softmax: bool = False
    pool: Optional["LayerInfo"] = None  # fused pooling stage
    pool_type: str = "max"              # max | avg (standalone pools)
    # residual-add epilogue fusion (conv stages only): ``merge`` is the
    # folded Add stage (keeps its name for QuantSpec lookup, its relu
    # flag and its original operand tensors); ``skip_input`` names the
    # second operand — the residual the kernel adds in its epilogue.
    # The conv's own output tensor survives inside ``merge.inputs`` as
    # the *intermediate* the fixed-point threading still scales.
    merge: Optional["LayerInfo"] = dataclasses.field(default=None,
                                                     repr=False)
    skip_input: Optional[str] = None
    # concat-epilogue fusion: a conv whose ``concat`` field references a
    # channel-merge stage writes its output directly into channels
    # ``[concat_offset, concat_offset + c_out)`` of the merge's shared
    # buffer (the concat becomes a strided store, not a copy).  The
    # Concat stage itself STAYS in the schedule, annotated
    # ``concat_fused`` — it keeps its name, operand tensors, relu flag
    # and (possibly absorbed) pool for quantization threading, and the
    # executor turns it into a buffer hand-off instead of a concatenate.
    concat: Optional["LayerInfo"] = dataclasses.field(default=None,
                                                      repr=False)
    concat_offset: int = 0
    concat_fused: bool = False
    # linked structure (paper: "saves layers in a linked structure")
    prev: Optional["LayerInfo"] = dataclasses.field(default=None, repr=False)
    next: Optional["LayerInfo"] = dataclasses.field(default=None, repr=False)

    # -- derived quantities used by synthesis & DSE ---------------------
    @property
    def input(self) -> str:
        """First (primary) input tensor — the only one for conv/pool/fc."""
        return self.inputs[0]

    @property
    def merge_intermediate(self) -> str:
        """For a conv with a folded residual add: the merge operand the
        conv itself produces (the tensor the unfused program would have
        written to memory between the two stages)."""
        a, b = self.merge.inputs
        return b if a == self.skip_input else a

    @property
    def is_depthwise(self) -> bool:
        return self.kind == CONV and self.group > 1 and \
            self.group == self.c_in and self.c_out == self.c_in

    @property
    def is_dw_kernel(self) -> bool:
        """Runs on the depthwise band kernel: group == Cin with an
        integer channel multiplier (Cout = m·Cin, one filter column per
        group).  Multiplier 1 is classic depthwise."""
        return self.kind == CONV and self.group > 1 and \
            self.group == self.c_in and self.c_out % self.c_in == 0

    @property
    def c_in(self) -> int:
        if self.kind == FC:
            return int(self.in_shape[-1])
        return int(self.in_shape[1])

    @property
    def c_out(self) -> int:
        if self.kind == FC:
            return int(self.out_shape[-1])
        return int(self.out_shape[1])

    @property
    def conv_out_shape(self) -> Tuple[int, ...]:
        """Output of the compute stage itself (pre-pool when fused)."""
        return self.pool.in_shape if self.pool is not None else self.out_shape

    @property
    def macs(self) -> int:
        """Multiply-accumulate count of the compute stage."""
        if self.kind in (ADD, CONCAT):
            return 0  # merge stages: pure adders / data movement, no MACs
        if self.kind == FC:
            m, k = self.in_shape[-2], self.in_shape[-1]
            n = self.out_shape[-1]
            return int(m * k * n)
        n, c_out, h, w = self.conv_out_shape
        kh, kw = self.kernel_shape
        return int(n * c_out * h * w * kh * kw * (self.c_in // self.group))

    @property
    def ops(self) -> int:
        """GOp convention of the paper's Tables 3/4: 2 ops per MAC."""
        return 2 * self.macs

    def weight_count(self) -> int:
        if self.weight is None:
            return 0
        if self.kind == FC:
            return int(self.c_in * self.c_out)
        kh, kw = self.kernel_shape
        return int(self.c_out * (self.c_in // self.group) * kh * kw)


@dataclasses.dataclass
class ParsedModel:
    """Topologically-scheduled stage program + option sets; what the
    synthesizer consumes.  ``layers`` is the schedule: every stage's
    input tensors are produced by an earlier stage or are the graph
    input, so an interpreter can execute the list front to back."""

    name: str
    layers: List[LayerInfo]
    graph: Graph
    input_name: str
    input_shape: Tuple[int, ...]
    output_name: str

    def __post_init__(self) -> None:
        self._producer_stage: Dict[str, LayerInfo] = {
            li.output: li for li in self.layers}

    def stage_producing(self, tensor: str) -> Optional[LayerInfo]:
        """The scheduled stage whose (post-fusion) output is ``tensor``."""
        return self._producer_stage.get(tensor)

    def consumer_stages(self, tensor: str) -> List[LayerInfo]:
        return [li for li in self.layers if tensor in li.inputs]

    @property
    def head(self) -> LayerInfo:
        return self.layers[0]

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def total_ops(self) -> int:
        return sum(l.ops for l in self.layers)

    @property
    def total_weights(self) -> int:
        return sum(l.weight_count() for l in self.layers)

    # -- §4.2 divisibility constraints ----------------------------------
    def feasible_ni(self, cap: int = 64) -> List[int]:
        """N_i must divide the input-channel (vector) width of every
        compute layer to avoid padding.  The first conv layer's 3-channel
        RGB input is zero-padded to the vector width by the memory-read
        kernel (as PipeCNN does), so it is exempt.  Depthwise/grouped
        convs stream channel-major vectors (each lane owns a channel, the
        per-group contraction is only ``kh*kw*c_in/g`` deep), so the
        constraint stays on the channel count.  Merge stages (add/concat)
        carry no weights and impose no N_i constraint."""
        cands = []
        widths = [l.c_in for l in self.layers[1:] if l.kind in (CONV, FC)]
        for ni in range(1, cap + 1):
            if _pow2(ni) and all(w % ni == 0 for w in widths):
                cands.append(ni)
        return cands

    def feasible_nl(self, cap: int = 64) -> List[int]:
        """N_l must divide the number of output features of every layer
        to avoid idle lanes.  The final classifier layer is exempt: its
        odd-sized output (e.g. 1000 classes) is zero-padded up to a lane
        multiple by the memory-write kernel, as PipeCNN does — without
        this the paper's own (16, 32) Arria-10 choice would be
        infeasible for AlexNet/VGG.  Add/concat merge stages run on the
        memory/adder path, not the compute lanes, so only conv/fc output
        widths constrain N_l."""
        cands = []
        feats = [l.c_out for l in self.layers[:-1] if l.kind in (CONV, FC)]
        for nl in range(1, cap + 1):
            if _pow2(nl) and all(f % nl == 0 for f in feats):
                cands.append(nl)
        return cands

    def hardware_options(self, cap: int = 64) -> List[Tuple[int, int]]:
        """All feasible (N_i, N_l) pairs — the DSE search space."""
        return [(ni, nl) for ni in self.feasible_ni(cap) for nl in self.feasible_nl(cap)]


def _pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def parse(graph: Graph, fuse_skip: bool = True,
          fuse_concat: bool = True) -> ParsedModel:
    """Traverse the graph (already topologically ordered) and emit the
    scheduled DAG stage program.

    Fusion (relu/softmax/max-pool/data-movement behind a stage) only
    happens across single-consumer tensors, so any tensor fused away has
    no other reader — every multi-consumer tensor (residual fan-out)
    survives as a named stage output.  Unfused data-movement nodes
    become aliases; stage inputs are canonicalised through them so the
    executor's tensor environment only ever holds stage outputs.
    Because canonicalisation runs on *every* stage's inputs, a merge
    whose operand arrives through elided Flatten/Identity/Dropout nodes
    sees the real producer tensor — fusion eligibility is judged on the
    resolved name, not the alias.

    With ``fuse_skip`` (default) a post-pass folds every eligible
    residual ``Add`` into the conv stage producing one of its operands
    (see :func:`_fold_skip_adds`) — the paper's keep-it-on-chip rule
    applied to skip connections.  ``fuse_skip=False`` keeps every merge
    a standalone stage (the bit-exact two-stage fallback program).
    ``fuse_concat`` (default) likewise annotates every eligible channel
    ``Concat`` for producer-epilogue fusion (see :func:`_fold_concats`);
    ``fuse_concat=False`` keeps every concat a standalone copy."""
    validate_ingress(graph)
    layers: List[LayerInfo] = []
    consumed: set = set()
    alias: Dict[str, str] = {}

    def canon(t: str) -> str:
        while t in alias:
            t = alias[t]
        return t

    for node in graph.nodes:
        if node.name in consumed:
            continue
        if node.op_type in ELIDED_OPS:
            # pure data-movement; the memory-read schedule absorbs it
            alias[node.outputs[0]] = node.inputs[0]
            continue
        if node.op_type == "Conv":
            li = _conv_layer(graph, node)
        elif node.op_type in ("Gemm", "MatMul"):
            li = _fc_layer(graph, node)
        elif node.op_type in ("MaxPool", "AveragePool", "GlobalAveragePool"):
            # standalone pool (not fused behind a conv)
            li = _pool_layer(graph, node)
        elif node.op_type == "Add":
            li = _merge_layer(graph, node, ADD)
        elif node.op_type == "Concat":
            li = _merge_layer(graph, node, CONCAT)
        elif node.op_type in ("Relu", "Softmax"):
            raise_if_unfused(graph, node, layers)
            continue
        elif node.op_type == "Clip":
            # every Clip the program keeps was fused by _fuse_chain: one
            # that reaches here has no single conv producer to take it
            raise GraphValidationError(
                "Clip cannot be fused into the conv that produces its "
                "input (it reads the graph input, a tensor with other "
                "readers, or no conv's output)", node=node.name,
                tensor=node.inputs[0])
        else:
            continue
        # fuse activation + pool chains greedily (single-consumer only)
        _fuse_chain(graph, li, consumed)
        li.inputs = [canon(t) for t in li.inputs]
        layers.append(li)

    if not layers:
        raise GraphValidationError(
            f"graph {graph.name!r} contains no compute layers",
            node=graph.name)

    if fuse_skip:
        layers = _fold_skip_adds(layers, canon(graph.outputs[0]))
    if fuse_concat:
        layers = _fold_concats(layers, canon(graph.outputs[0]))

    # link the list in schedule order (the paper's order-preserving
    # structure; with branches this is the topological schedule)
    for a, b in zip(layers, layers[1:]):
        a.next, b.prev = b, a

    produced = {li.output for li in layers}
    inp = graph.inputs[0]
    for li in layers:
        for t in li.inputs:
            if t not in produced and t != inp.name:
                raise GraphValidationError(
                    "dangling stage input: no scheduled stage produces it",
                    node=li.name, tensor=t)

    return ParsedModel(
        name=graph.name,
        layers=layers,
        graph=graph,
        input_name=inp.name,
        input_shape=tuple(inp.shape),
        output_name=canon(graph.outputs[0]),
    )


def validate_ingress(graph: Graph) -> None:
    """Reject models the synthesis flow must not stage (DESIGN.md §9).

    Checked before any scheduling work: every float initializer must be
    finite (a NaN/Inf weight poisons max-abs calibration and every
    downstream quantized value), and every Conv/Gemm weight operand must
    actually be an initializer — a weight coming in as a dynamic tensor
    cannot be staged into on-chip memory."""
    for name, arr in graph.initializers.items():
        arr = np.asarray(arr)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad = int(np.size(arr) - np.isfinite(arr).sum())
            raise GraphValidationError(
                "non-finite initializer", tensor=name,
                detail=f"{bad} NaN/Inf of {arr.size} values")
    for node in graph.nodes:
        if node.op_type in ("Conv", "Gemm") and len(node.inputs) > 1:
            w = node.inputs[1]
            if w not in graph.initializers:
                raise GraphValidationError(
                    "weight operand is not an initializer",
                    node=node.name, tensor=w)


def raise_if_unfused(graph: Graph, node: Node, layers: List[LayerInfo]) -> None:
    """Activations should have been fused into the producing layer; a
    dangling one (e.g. Relu straight on the graph input) is unsupported
    by the pipelined kernel library."""
    for li in layers:
        if li.output == node.inputs[0] or (li.pool and li.pool.output == node.inputs[0]):
            return
        if node.outputs[0] in (li.output,):
            return
    # Softmax on the classifier output is recognised as fused elsewhere.
    raise GraphValidationError(
        f"standalone {node.op_type} node cannot be mapped to the "
        "pipelined kernel library", node=node.name)


def _conv_layer(graph: Graph, node: Node) -> LayerInfo:
    w_name = node.inputs[1]
    b_name = node.inputs[2] if len(node.inputs) > 2 else None
    w_shape = graph.shape(w_name)
    return LayerInfo(
        kind=CONV,
        name=node.name,
        inputs=[node.inputs[0]],
        output=node.outputs[0],
        weight=w_name,
        bias=b_name,
        in_shape=graph.shape(node.inputs[0]),
        out_shape=graph.shape(node.outputs[0]),
        kernel_shape=_norm2(node.attr("kernel_shape", (w_shape[2], w_shape[3]))),
        strides=_norm2(node.attr("strides", 1)),
        pads=_norm4(node.attr("pads")),
        dilations=_norm2(node.attr("dilations", 1)),
        group=int(node.attr("group", 1)),
    )


def _fc_layer(graph: Graph, node: Node) -> LayerInfo:
    w_name = node.inputs[1]
    b_name = node.inputs[2] if len(node.inputs) > 2 else None
    return LayerInfo(
        kind=FC,
        name=node.name,
        inputs=[node.inputs[0]],
        output=node.outputs[0],
        weight=w_name,
        bias=b_name,
        in_shape=graph.shape(node.inputs[0]),
        out_shape=graph.shape(node.outputs[0]),
    )


def _pool_layer(graph: Graph, node: Node) -> LayerInfo:
    if node.op_type == "GlobalAveragePool":
        in_shape = graph.shape(node.inputs[0])
        ks: Tuple[int, int] = (in_shape[2], in_shape[3])
        st: Tuple[int, int] = (1, 1)
    else:
        ks = _norm2(node.attr("kernel_shape"))
        st = _norm2(node.attr("strides", ks[0]))
    return LayerInfo(
        kind=POOL,
        name=node.name,
        inputs=[node.inputs[0]],
        output=node.outputs[0],
        in_shape=graph.shape(node.inputs[0]),
        out_shape=graph.shape(node.outputs[0]),
        kernel_shape=ks,
        strides=st,
        pads=_norm4(node.attr("pads")),
        pool_type="max" if node.op_type == "MaxPool" else "avg",
    )


def _merge_layer(graph: Graph, node: Node, kind: str) -> LayerInfo:
    """Residual (Add) or channel (Concat) merge as a first-class stage:
    all operands are named tensors; the executor aligns their fixed-point
    positions before merging (see pipeline/quantize)."""
    return LayerInfo(
        kind=kind,
        name=node.name,
        inputs=list(node.inputs),
        output=node.outputs[0],
        in_shape=graph.shape(node.inputs[0]),
        out_shape=graph.shape(node.outputs[0]),
        axis=int(node.attr("axis", 1)) if kind == CONCAT else 1,
    )


def _clip_bound(graph: Graph, node: Node) -> float:
    """The upper bound of a ReLU-n ``Clip`` node: its ``max``, from a
    scalar initializer input (what exporters write since opset 11) or the
    ``max`` attribute (opset 6).  Raises GraphValidationError naming the
    node unless ``min`` is 0 and ``max`` finite and at least 0: the int8
    epilogue clamps to [0, hi] and nothing else."""
    bounds = []
    for k, key in ((1, "min"), (2, "max")):
        if len(node.inputs) > k and node.inputs[k]:
            t = node.inputs[k]
            if t not in graph.initializers:
                raise GraphValidationError(
                    f"Clip {key} is not an initializer", node=node.name,
                    tensor=t)
            v = np.asarray(graph.initializers[t], np.float64)
            if v.size != 1:
                raise GraphValidationError(
                    f"Clip {key} is not a scalar", node=node.name, tensor=t)
            bounds.append(float(v.reshape(())))
        else:
            v = node.attr(key)
            bounds.append(None if v is None else float(v))
    lo, hi = bounds
    if lo != 0.0:
        raise GraphValidationError(
            "Clip min must be 0 (a ReLU-n)", node=node.name,
            detail=f"min {lo}")
    if hi is None or not np.isfinite(hi) or hi < 0:
        raise GraphValidationError(
            "Clip max must be finite and at least 0", node=node.name,
            detail=f"max {hi}")
    return hi


def _fuse_chain(graph: Graph, li: LayerInfo, consumed: set) -> None:
    """Fuse Relu / Clip / MaxPool / Softmax that immediately follow
    ``li``.

    Mirrors the paper's hardware view: the conv kernel has a fused ReLU
    stage, the pool kernel sits behind it on the pipe, and fully-connected
    layers run on the conv kernel with pooling configured pass-through.
    A ``Clip`` (ReLU-n) fuses into a conv only, as a ReLU with an upper
    bound (:func:`_clip_bound`; two give the lesser); one behind any other
    stage, or behind a softmax, raises GraphValidationError.
    """
    cur_out = li.output
    while True:
        consumers = [
            n for n in graph.consumers_of(cur_out) if n.name not in consumed
        ]
        # only fuse when the tensor has exactly one consumer (pipe semantics)
        if len(consumers) != 1:
            break
        n = consumers[0]
        if n.op_type == "Relu":
            li.relu = True
            consumed.add(n.name)
            cur_out = n.outputs[0]
            li.output = cur_out
        elif n.op_type == "Clip":
            if li.kind != CONV or li.softmax:
                raise GraphValidationError(
                    f"Clip cannot be fused into the {li.kind} stage "
                    f"{li.name!r}: only a conv's epilogue clamps (and "
                    "none after a softmax)", node=n.name, tensor=cur_out)
            bound = _clip_bound(graph, n)
            li.relu = True
            li.clip_max = (bound if li.clip_max is None
                           else min(li.clip_max, bound))
            consumed.add(n.name)
            cur_out = n.outputs[0]
            li.output = cur_out
        elif n.op_type == "Softmax":
            li.softmax = True
            consumed.add(n.name)
            cur_out = n.outputs[0]
            li.output = cur_out
        elif (n.op_type == "MaxPool" and li.kind == CONV
              and li.pool is None and not any(_norm4(n.attr("pads")))):
            # only max-pool fuses into the conv kernel (its pooling
            # stage computes max); average pools and *padded* max-pools
            # run standalone — the fused band kernel has no pool-pad
            # path, and maxpool2d_nhwc handles pads exactly
            pool = _pool_layer(graph, n)
            li.pool = pool
            consumed.add(n.name)
            cur_out = n.outputs[0]
            li.output = cur_out
            li.out_shape = pool.out_shape
        elif n.op_type in ("Flatten", "Reshape", "Dropout", "Identity"):
            consumed.add(n.name)
            cur_out = n.outputs[0]
            li.output = cur_out
        else:
            break


def _fold_skip_adds(layers: List[LayerInfo],
                    graph_output: Optional[str] = None) -> List[LayerInfo]:
    """Residual-add epilogue fusion pass (the ROADMAP's add-into-conv
    item): fold each two-operand ``Add`` into the conv stage producing
    one of its operands, so the merge runs inside the conv kernel's
    epilogue instead of as a standalone stage (one full int8 feature-map
    HBM write + read saved per skip connection).

    Eligibility — everything else falls back to the standalone merge
    stage, whose numerics the fused epilogue replicates bit-for-bit:

      * the host operand's producer is a dense conv (``group == 1``) or
        a depthwise-kernel conv (group == Cin, any integer channel
        multiplier — both band kernels carry the skip epilogue; ragged
        grouped producers run on the group-axis kernel, which does not);
      * that conv's output has the Add as its **only** consumer (pipe
        semantics — a fan-out tensor must stay addressable);
      * the conv has no fused pool yet and matches the Add's geometry;
      * the skip operand is already available when the host runs (its
        producer is scheduled earlier, or it is the graph input).

    When both producers qualify the later-scheduled one hosts (its
    operand is then the freshest tensor — the ResNet projection case).
    After folding, a single-consumer unpadded MaxPool stage straddling
    the old Add output is absorbed as the merged stage's fused pool
    (graph order Conv→Add→ReLU→MaxPool == epilogue order)."""
    result = list(layers)
    progress = True
    while progress:
        progress = False
        pos = {id(li): i for i, li in enumerate(result)}
        producer = {li.output: li for li in result}
        n_consumers: Dict[str, int] = {}
        for li in result:
            for t in li.inputs:
                n_consumers[t] = n_consumers.get(t, 0) + 1
        for add in result:
            if add.kind != ADD or len(add.inputs) != 2:
                continue
            if add.inputs[0] == add.inputs[1]:
                continue  # x + x consumes one tensor twice: keep merged
            if add.softmax:
                continue  # the epilogue has no softmax: keep standalone
            cands = []
            for k, t in enumerate(add.inputs):
                p = producer.get(t)
                if (p is not None and p.kind == CONV
                        and (p.group == 1 or p.is_dw_kernel)
                        and p.pool is None and p.merge is None
                        and not p.softmax
                        and n_consumers.get(t, 0) == 1
                        and t != graph_output  # the egress still reads it
                        and p.out_shape == add.out_shape):
                    cands.append((pos[id(p)], p, add.inputs[1 - k]))
            host = skip_t = None
            for _i, p, other in sorted(cands, key=lambda c: -c[0]):
                op = producer.get(other)
                if op is None or pos[id(op)] < pos[id(p)]:
                    host, skip_t = p, other
                    break
            if host is None:
                continue
            host.merge = add
            host.skip_input = skip_t
            host.inputs = [host.inputs[0], skip_t]
            host.output = add.output
            host.out_shape = add.out_shape
            result.remove(add)
            # absorb a following single-consumer unpadded MaxPool: the
            # epilogue pools after the merge, matching the graph order
            pools = [l for l in result if host.output in l.inputs]
            if (len(pools) == 1 and pools[0].kind == POOL
                    and pools[0].pool_type == "max"
                    and not any(pools[0].pads)
                    and not pools[0].softmax and not pools[0].relu
                    and host.output != graph_output):
                pstage = pools[0]
                host.pool = pstage
                host.output = pstage.output
                host.out_shape = pstage.out_shape
                result.remove(pstage)
            progress = True
            break  # adjacency changed: recompute the maps
    return result


def _fold_concats(layers: List[LayerInfo],
                  graph_output: Optional[str] = None) -> List[LayerInfo]:
    """Concat-epilogue fusion pass (the ROADMAP's inception item): mark
    each channel ``Concat`` whose operands are ALL produced by eligible
    band-kernel convs so that every producer writes its Cout tiles
    directly into a channel-offset slice of the shared merge buffer —
    the concat becomes a strided store, not a copy (one full merged
    feature-map HBM write + read saved per inception block).

    Unlike ``_fold_skip_adds`` the Concat stage is NOT removed: it stays
    scheduled (annotated ``concat_fused``) as the point where the shared
    buffer becomes the merge tensor, keeping its name, operand tensors
    and relu flag — so ``thread_scales``/``calibrate_quantization``
    treat fused and unfused programs identically and emit byte-identical
    specs.  Producers get ``concat``/``concat_offset`` annotations; the
    offsets accumulate in operand order and exactly partition the merge
    Cout.

    Eligibility — ALL operands must qualify, else the whole concat stays
    a standalone merge (whose numerics the fused epilogue replicates
    bit-for-bit):

      * the merge is a channel concat (axis 1 in NCHW), not the graph
        output's softmax host, with no repeated operand tensors;
      * every operand's producer is a dense conv (``group == 1``) or a
        depthwise-kernel conv (group == Cin, integer channel
        multiplier) with no fused pool, no folded residual merge, no
        prior concat annotation and no softmax;
      * every operand has the concat as its **only** consumer and is not
        the graph output (a fan-out operand must stay addressable);
      * every operand matches the merge's batch and spatial geometry
        (the channel sums are checked to partition the merge Cout).

    After folding, a single-consumer unpadded MaxPool stage straddling
    the concat output is absorbed as the merge's fused pool — each
    producer then runs the pool in its epilogue on its own channel
    slice (disjoint channels, so pooling per-slice == pooling the
    merged tensor) and the shared buffer takes the pooled geometry."""
    result = list(layers)
    producer = {li.output: li for li in result}
    n_consumers: Dict[str, int] = {}
    for li in result:
        for t in li.inputs:
            n_consumers[t] = n_consumers.get(t, 0) + 1
    for cc in [l for l in result if l.kind == CONCAT]:
        if cc.axis != 1 or cc.softmax:
            continue
        if len(set(cc.inputs)) != len(cc.inputs):
            continue  # a repeated operand would need two buffer slices
        prods: List[Tuple[LayerInfo, int]] = []
        off = 0
        ok = True
        for t in cc.inputs:
            p = producer.get(t)
            if (p is None or p.kind != CONV
                    or not (p.group == 1 or p.is_dw_kernel)
                    or p.pool is not None or p.merge is not None
                    or p.concat is not None or p.softmax
                    or n_consumers.get(t, 0) != 1
                    or t == graph_output
                    or p.out_shape[0] != cc.out_shape[0]
                    or p.out_shape[2:] != cc.out_shape[2:]):
                ok = False
                break
            prods.append((p, off))
            off += p.c_out
        if not ok or off != cc.c_out:
            continue
        for p, o in prods:
            p.concat = cc
            p.concat_offset = o
        cc.concat_fused = True
        # absorb a following single-consumer unpadded MaxPool into the
        # merge: producers pool in their epilogues, the shared buffer
        # is allocated in pooled geometry, and the standalone pool
        # stage disappears (graph order Concat→ReLU→MaxPool == epilogue
        # order concat-align→relu→pool)
        pools = [l for l in result if cc.output in l.inputs]
        if (len(pools) == 1 and pools[0].kind == POOL
                and pools[0].pool_type == "max"
                and not any(pools[0].pads)
                and not pools[0].softmax and not pools[0].relu
                and cc.output != graph_output):
            pstage = pools[0]
            cc.pool = pstage
            cc.output = pstage.output
            cc.out_shape = pstage.out_shape
            result.remove(pstage)
    return result


def memory_schedule(model: ParsedModel, n_i: int, n_l: int) -> List[Dict[str, Any]]:
    """The host-program memory access schedule of §4.2: for each pipeline
    stage, how many (N_i)-wide vectors the memory-read kernel fetches and
    how many lanes are active.  Consumed by the pipelined executor and the
    FPGA latency model."""
    sched = []
    for li in model.layers:
        if li.kind == FC:
            vec_per_row = -(-li.c_in // n_i)  # ceil
            rows = int(np.prod(li.in_shape[:-1]))
            sched.append(
                dict(
                    layer=li.name,
                    kind=li.kind,
                    read_vectors=rows * vec_per_row,
                    weight_vectors=li.c_out * vec_per_row,
                    lanes=min(n_l, li.c_out),
                    write_elems=int(np.prod(li.out_shape)),
                )
            )
        elif li.kind in (ADD, CONCAT):
            # merge stages stream every operand once and write the
            # merged tensor — pure memory traffic, no weight vectors.
            # The operand slices of a concat together hold exactly one
            # merged tensor's worth of elements, so the merge buffer is
            # charged ONCE per merge tensor, not once per branch.  A
            # producer-fused concat is a buffer hand-off: the producers
            # already wrote their slices in place, so the stage itself
            # moves nothing.
            if li.concat_fused:
                sched.append(
                    dict(layer=li.name, kind=li.kind, read_vectors=0,
                         weight_vectors=0, lanes=min(n_l, li.c_out),
                         write_elems=0))
                continue
            if li.kind == ADD:
                read_elems = len(li.inputs) * int(np.prod(li.in_shape))
            else:
                read_elems = int(np.prod(li.out_shape))
            sched.append(
                dict(
                    layer=li.name,
                    kind=li.kind,
                    read_vectors=-(-read_elems // n_i),
                    weight_vectors=0,
                    lanes=min(n_l, li.c_out),
                    write_elems=int(np.prod(li.out_shape)),
                )
            )
        else:
            n, c_out, h, w = li.out_shape if li.pool is None else li.pool.in_shape
            kh, kw = li.kernel_shape
            vec_per_patch = -(-(li.c_in * kh * kw) // n_i)
            read_vectors = n * h * w * vec_per_patch
            if li.merge is not None:
                # fused residual merge: the skip operand streams through
                # the same memory-read kernel once (conv-out geometry)
                read_vectors += -(-int(np.prod(li.conv_out_shape)) // n_i)
            write_elems = int(np.prod(li.out_shape))
            if li.concat is not None and li.concat.pool is not None:
                # concat producer running the merge's absorbed pool in
                # its epilogue: it writes its slice in pooled geometry
                cc = li.concat
                write_elems = int(cc.out_shape[0] * li.c_out
                                  * np.prod(cc.out_shape[2:]))
            sched.append(
                dict(
                    layer=li.name,
                    kind=li.kind,
                    read_vectors=read_vectors,
                    weight_vectors=c_out * vec_per_patch,
                    lanes=min(n_l, c_out),
                    write_elems=write_elems,
                )
            )
    return sched

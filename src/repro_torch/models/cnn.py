"""CNN model zoo expressed in the ONNX-lite transport format.

Builders emit exactly the graphs a framework exporter would (ONNX op
names, NCHW, initializers as numpy arrays), so the front-end parser is
exercised the same way it would be on a real ONNX file.  AlexNet and
VGG-16 match the paper's workloads (Tables 1–4).  A float32 PyTorch
executor (``run_float``) serves as the accuracy oracle for the int8
pipeline.  The builders draw their initializers from
``np.random.default_rng(seed)`` exactly as the JAX package's do, so the
two packages build byte-identical weights from one seed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch.core.graph import Graph, Node, TensorInfo


class GraphBuilder:
    """Tiny builder DSL ("the ML framework" whose export we parse).

    The builder threads one *current* tensor; ``tap()`` captures a
    handle to it and ``from_tap`` rewinds, which is how branches
    (residual skips, inception-style splits) are expressed — the emitted
    graph is a plain ONNX-style DAG either way."""

    def __init__(self, name: str, input_shape: Sequence[int], seed: int = 0):
        self.name = name
        self.nodes: List[Node] = []
        self.inits: Dict[str, np.ndarray] = {}
        self.rng = np.random.default_rng(seed)
        self.input = TensorInfo("input", tuple(input_shape))
        self.cur = "input"
        self.cur_shape: Tuple[int, ...] = tuple(input_shape)
        self._n = 0

    def _name(self, op: str) -> str:
        self._n += 1
        return f"{op.lower()}_{self._n}"

    # ------------------------------------------------- branch plumbing
    def tap(self) -> Tuple[str, Tuple[int, ...]]:
        """Handle to the current tensor (for skips/merges)."""
        return self.cur, self.cur_shape

    def from_tap(self, handle: Tuple[str, Tuple[int, ...]]) -> "GraphBuilder":
        """Rewind the builder to a tapped tensor (start a branch)."""
        self.cur, self.cur_shape = handle[0], tuple(handle[1])
        return self

    def conv(self, c_out: int, k: int, stride: int = 1, pad: int = 0,
             relu: bool = True, group: int = 1) -> "GraphBuilder":
        name = self._name("Conv")
        c_in = self.cur_shape[1]
        w = (self.rng.standard_normal((c_out, c_in // group, k, k)) *
             np.sqrt(2.0 / (c_in // group * k * k))).astype(np.float32)
        b = (self.rng.standard_normal(c_out) * 0.01).astype(np.float32)
        self.inits[name + "_w"] = w
        self.inits[name + "_b"] = b
        out = name + "_out"
        self.nodes.append(Node(
            "Conv", name, [self.cur, name + "_w", name + "_b"], [out],
            {"kernel_shape": [k, k], "strides": [stride, stride],
             "pads": [pad, pad, pad, pad], "dilations": [1, 1],
             "group": group}))
        self.cur = out
        h = (self.cur_shape[2] + 2 * pad - k) // stride + 1
        w_ = (self.cur_shape[3] + 2 * pad - k) // stride + 1
        self.cur_shape = (self.cur_shape[0], c_out, h, w_)
        if relu:
            self.relu()
        return self

    def dwconv(self, k: int, stride: int = 1, pad: int = 0,
               relu: bool = True) -> "GraphBuilder":
        """Depthwise conv (group == C, multiplier 1, MobileNet-style)."""
        return self.conv(self.cur_shape[1], k, stride=stride, pad=pad,
                         relu=relu, group=self.cur_shape[1])

    def add_from(self, handle: Tuple[str, Tuple[int, ...]],
                 relu: bool = True) -> "GraphBuilder":
        """Residual merge: current tensor + tapped tensor."""
        name = self._name("Add")
        out = name + "_out"
        self.nodes.append(Node("Add", name, [self.cur, handle[0]], [out]))
        self.cur = out
        if relu:
            self.relu()
        return self

    def concat_from(self, *handles: Tuple[str, Tuple[int, ...]]
                    ) -> "GraphBuilder":
        """Channel merge: concat current tensor with tapped tensors."""
        name = self._name("Concat")
        out = name + "_out"
        self.nodes.append(Node(
            "Concat", name, [self.cur] + [h[0] for h in handles], [out],
            {"axis": 1}))
        c = self.cur_shape[1] + sum(h[1][1] for h in handles)
        self.cur_shape = (self.cur_shape[0], c) + tuple(self.cur_shape[2:])
        self.cur = out
        return self

    def relu(self) -> "GraphBuilder":
        name = self._name("Relu")
        out = name + "_out"
        self.nodes.append(Node("Relu", name, [self.cur], [out]))
        self.cur = out
        return self

    def relu6(self) -> "GraphBuilder":
        """ReLU6 as PyTorch's exporter writes it (opset 11 and later): a
        ``Clip`` whose min 0 and max 6 are scalar initializers."""
        name = self._name("Clip")
        out = name + "_out"
        self.inits[name + "_min"] = np.asarray(0.0, np.float32)
        self.inits[name + "_max"] = np.asarray(6.0, np.float32)
        self.nodes.append(Node("Clip", name,
                               [self.cur, name + "_min", name + "_max"],
                               [out]))
        self.cur = out
        return self

    def maxpool(self, k: int, stride: Optional[int] = None,
                pad: int = 0) -> "GraphBuilder":
        stride = stride or k
        name = self._name("MaxPool")
        out = name + "_out"
        self.nodes.append(Node(
            "MaxPool", name, [self.cur], [out],
            {"kernel_shape": [k, k], "strides": [stride, stride],
             "pads": [pad, pad, pad, pad]}))
        self.cur = out
        n, c, h, w = self.cur_shape
        self.cur_shape = (n, c, (h + 2 * pad - k) // stride + 1,
                          (w + 2 * pad - k) // stride + 1)
        return self

    def avgpool(self, k: int, stride: Optional[int] = None,
                pad: int = 0) -> "GraphBuilder":
        stride = stride or k
        name = self._name("AveragePool")
        out = name + "_out"
        self.nodes.append(Node(
            "AveragePool", name, [self.cur], [out],
            {"kernel_shape": [k, k], "strides": [stride, stride],
             "pads": [pad, pad, pad, pad]}))
        self.cur = out
        n, c, h, w = self.cur_shape
        self.cur_shape = (n, c, (h + 2 * pad - k) // stride + 1,
                          (w + 2 * pad - k) // stride + 1)
        return self

    def global_avgpool(self) -> "GraphBuilder":
        name = self._name("GlobalAveragePool")
        out = name + "_out"
        self.nodes.append(Node("GlobalAveragePool", name, [self.cur], [out]))
        self.cur = out
        n, c, _h, _w = self.cur_shape
        self.cur_shape = (n, c, 1, 1)
        return self

    def flatten(self) -> "GraphBuilder":
        name = self._name("Flatten")
        out = name + "_out"
        self.nodes.append(Node("Flatten", name, [self.cur], [out], {"axis": 1}))
        self.cur = out
        n = self.cur_shape[0]
        self.cur_shape = (n, int(np.prod(self.cur_shape[1:])))
        return self

    def fc(self, n_out: int, relu: bool = True, softmax: bool = False) -> "GraphBuilder":
        if len(self.cur_shape) != 2:
            self.flatten()
        name = self._name("Gemm")
        k = self.cur_shape[1]
        w = (self.rng.standard_normal((k, n_out)) * np.sqrt(2.0 / k)).astype(np.float32)
        b = (self.rng.standard_normal(n_out) * 0.01).astype(np.float32)
        self.inits[name + "_w"] = w
        self.inits[name + "_b"] = b
        out = name + "_out"
        self.nodes.append(Node("Gemm", name, [self.cur, name + "_w", name + "_b"],
                               [out], {"transA": 0, "transB": 0}))
        self.cur = out
        self.cur_shape = (self.cur_shape[0], n_out)
        if relu:
            self.relu()
        if softmax:
            name = self._name("Softmax")
            out = name + "_out"
            self.nodes.append(Node("Softmax", name, [self.cur], [out], {"axis": 1}))
            self.cur = out
        return self

    def build(self) -> Graph:
        return Graph(self.name, self.nodes, [self.input], [self.cur], self.inits)


def alexnet(batch: int = 1, num_classes: int = 1000, seed: int = 0,
            channels_base: int = 64) -> Graph:
    """AlexNet [36] (single-tower variant, as in torchvision / PipeCNN).

    Five conv layers (1,2,5 followed by 3x3/2 max-pool) + three FC —
    the paper's Fig. 6 structure: 5 fused conv/pool stages + 3 FC stages.
    """
    cb = channels_base
    b = GraphBuilder("alexnet", (batch, 3, 224, 224), seed)
    b.conv(cb, 11, stride=4, pad=2).maxpool(3, 2)
    b.conv(cb * 3, 5, pad=2).maxpool(3, 2)
    b.conv(cb * 6, 3, pad=1)
    b.conv(cb * 4, 3, pad=1)
    b.conv(cb * 4, 3, pad=1).maxpool(3, 2)
    b.fc(4096).fc(4096).fc(num_classes, relu=False, softmax=True)
    return b.build()


def vgg16(batch: int = 1, num_classes: int = 1000, seed: int = 0) -> Graph:
    """VGG-16 [37]: 13 conv (5 pool stages) + 3 FC."""
    b = GraphBuilder("vgg16", (batch, 3, 224, 224), seed)
    for c, reps in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        for _ in range(reps):
            b.conv(c, 3, pad=1)
        b.maxpool(2, 2)
    b.fc(4096).fc(4096).fc(num_classes, relu=False, softmax=True)
    return b.build()


def tiny_cnn(batch: int = 1, num_classes: int = 10, seed: int = 0,
             in_hw: int = 32) -> Graph:
    """A small CIFAR-scale CNN for fast tests/examples."""
    b = GraphBuilder("tiny_cnn", (batch, 3, in_hw, in_hw), seed)
    b.conv(16, 3, pad=1).maxpool(2, 2)
    b.conv(32, 3, pad=1).maxpool(2, 2)
    b.fc(64).fc(num_classes, relu=False, softmax=True)
    return b.build()


def tiny_cnn_gap(batch: int = 1, num_classes: int = 10, seed: int = 0,
                 in_hw: int = 32) -> Graph:
    """Variant with average-pool + global-average-pool head (exercises
    the standalone avg-pool pipeline stages)."""
    b = GraphBuilder("tiny_cnn_gap", (batch, 3, in_hw, in_hw), seed)
    b.conv(16, 3, pad=1).avgpool(2, 2)
    b.conv(32, 3, pad=1).global_avgpool()
    b.fc(num_classes, relu=False, softmax=True)
    return b.build()


def _basic_block(b: GraphBuilder, c_out: int, stride: int = 1) -> None:
    """ResNet basic block: two 3x3 convs + identity/projection skip,
    post-add ReLU (the canonical v1 ordering)."""
    skip = b.tap()
    b.conv(c_out, 3, stride=stride, pad=1)
    b.conv(c_out, 3, pad=1, relu=False)
    main = b.tap()
    if stride != 1 or skip[1][1] != c_out:
        # 1x1 strided projection on the skip path (ResNet option B)
        b.from_tap(skip).conv(c_out, 1, stride=stride, relu=False)
        skip = b.tap()
    b.from_tap(main).add_from(skip, relu=True)


def resnet_tiny(batch: int = 1, num_classes: int = 10, seed: int = 0,
                in_hw: int = 32) -> Graph:
    """CIFAR-scale residual net: stem + identity block + downsample
    block (strided projection) — the smallest graph that exercises
    multi-consumer fan-out, residual merge and branch requantization."""
    b = GraphBuilder("resnet_tiny", (batch, 3, in_hw, in_hw), seed)
    b.conv(16, 3, pad=1)
    _basic_block(b, 16)
    _basic_block(b, 32, stride=2)
    b.global_avgpool()
    b.fc(num_classes, relu=False, softmax=True)
    return b.build()


def resnet18(batch: int = 1, num_classes: int = 1000, seed: int = 0,
             in_hw: int = 224) -> Graph:
    """ResNet-18 [He et al.]: 7x7/2 stem + padded 3x3/2 max-pool, four
    basic-block groups (64/128/256/512, two blocks each, strided
    projection at each group boundary), GAP head.  ``in_hw`` shrinks
    the input for interpret-mode tests (the GAP head absorbs any size
    the five stride-2 stages leave >= 1)."""
    b = GraphBuilder("resnet18", (batch, 3, in_hw, in_hw), seed)
    b.conv(64, 7, stride=2, pad=3).maxpool(3, 2, pad=1)
    for c_out, stride in ((64, 1), (64, 1), (128, 2), (128, 1),
                          (256, 2), (256, 1), (512, 2), (512, 1)):
        _basic_block(b, c_out, stride)
    b.global_avgpool()
    b.fc(num_classes, relu=False, softmax=True)
    return b.build()


def _bottleneck(b: GraphBuilder, width: int, c_out: int, stride: int = 1,
                groups: int = 1) -> None:
    """ResNet bottleneck block, ResNeXt's when ``groups`` > 1: a 1x1 conv
    to ``width`` with ReLU, a 3x3 conv of ``groups`` groups carrying the
    block's stride with ReLU, a 1x1 conv to ``c_out`` without one, then
    the add and its ReLU.  Where the stride or width changes, a 1x1
    projection of that stride on the skip (option B), written after the
    third conv as an exporter writes torchvision's block."""
    skip = b.tap()
    b.conv(width, 1)
    b.conv(width, 3, stride=stride, pad=1, group=groups)
    b.conv(c_out, 1, relu=False)
    main = b.tap()
    if stride != 1 or skip[1][1] != c_out:
        b.from_tap(skip).conv(c_out, 1, stride=stride, relu=False)
        skip = b.tap()
    b.from_tap(main).add_from(skip, relu=True)


#: ResNeXt-50 (32x4d)'s stages (bottleneck width, output channels, blocks,
#: first stride): Xie et al., arXiv:1611.05431, Table 1
RESNEXT50_STAGES = ((128, 256, 3, 1), (256, 512, 4, 2), (512, 1024, 6, 2),
                    (1024, 2048, 3, 2))


def resnext50_32x4d(batch: int = 1, num_classes: int = 1000, seed: int = 0,
                    in_hw: int = 224) -> Graph:
    """ResNeXt-50 (32x4d) (arXiv:1611.05431, Table 1; torchvision's
    ``resnext50_32x4d``), BN folded: a 7x7/2 stem of 64 and a padded
    3x3/2 max-pool, 16 bottleneck blocks in stages of 3, 4, 6 and 3 whose
    3x3 convs have 32 groups of 4, 8, 16 and 32 channels, a projection
    on the first block of each stage, GAP and the classifier: 53 convs,
    16 of them grouped, 16 adds.  ``in_hw`` shrinks the input for CPU
    tests (the GAP absorbs what the five stride-2 stages leave)."""
    b = GraphBuilder("resnext50_32x4d", (batch, 3, in_hw, in_hw), seed)
    b.conv(64, 7, stride=2, pad=3).maxpool(3, 2, pad=1)
    for width, c_out, blocks, stride in RESNEXT50_STAGES:
        for i in range(blocks):
            _bottleneck(b, width, c_out, stride if i == 0 else 1, groups=32)
    b.global_avgpool()
    b.fc(num_classes, relu=False, softmax=True)
    return b.build()


def mobilenet_tiny(batch: int = 1, num_classes: int = 10, seed: int = 0,
                   in_hw: int = 32) -> Graph:
    """MobileNet-v1-style separable stack: strided stem + three
    depthwise(3x3)+pointwise(1x1) pairs — exercises the depthwise band
    kernel and the grouped feasibility rules."""
    b = GraphBuilder("mobilenet_tiny", (batch, 3, in_hw, in_hw), seed)
    b.conv(16, 3, stride=2, pad=1)
    for c_out, stride in ((32, 1), (64, 2), (64, 1)):
        b.dwconv(3, stride=stride, pad=1)
        b.conv(c_out, 1)
    b.global_avgpool()
    b.fc(num_classes, relu=False, softmax=True)
    return b.build()


#: MobileNetV2's inverted-residual rows (expansion t, output channels c,
#: blocks n, first stride s): Sandler et al., arXiv:1801.04381, Table 2
MOBILENET_V2_BLOCKS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                       (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                       (6, 320, 1, 1))


def mobilenet_v2(batch: int = 1, num_classes: int = 1000, seed: int = 0,
                 in_hw: int = 224) -> Graph:
    """MobileNetV2 1.0 (arXiv:1801.04381, Table 2), BN folded: a 3x3/2
    stem of 32, 17 inverted-residual blocks (a 1x1 expansion by t but
    where t = 1, a 3x3 depthwise conv of the row's stride, a linear 1x1
    projection; an add without a ReLU where the stride is 1 and the
    width holds), a 1x1 head to 1280, GAP and the classifier.  ReLU6
    (``relu6``) follows the stem, every expansion, every depthwise conv
    and the head: 35 clamps, 10 adds.  ``in_hw`` shrinks the input for
    CPU tests (the GAP absorbs what the five stride-2 stages leave)."""
    b = GraphBuilder("mobilenet_v2", (batch, 3, in_hw, in_hw), seed)
    b.conv(32, 3, stride=2, pad=1, relu=False).relu6()
    for t, c, n, s in MOBILENET_V2_BLOCKS:
        for i in range(n):
            stride = s if i == 0 else 1
            skip = b.tap()
            c_in = skip[1][1]
            if t != 1:
                b.conv(c_in * t, 1, relu=False).relu6()
            b.dwconv(3, stride=stride, pad=1, relu=False).relu6()
            b.conv(c, 1, relu=False)
            if stride == 1 and c_in == c:
                b.add_from(skip, relu=False)
    b.conv(1280, 1, relu=False).relu6()
    b.global_avgpool()
    b.fc(num_classes, relu=False, softmax=True)
    return b.build()


def _inception(b: GraphBuilder, c1: int, c3r: int, c3: int,
               c5r: int, c5: int, cp: int) -> None:
    """GoogLeNet inception module: four parallel branches — 1x1, 1x1→3x3,
    1x1→5x5, 3x3-maxpool→1x1 — channel-concatenated.  Every branch ends
    in a dense conv, so the whole 4-way merge is concat-epilogue
    eligible (each branch writes its channel slice of the shared merge
    buffer in place)."""
    split = b.tap()
    b.conv(c1, 1)
    b1 = b.tap()
    b.from_tap(split).conv(c3r, 1).conv(c3, 3, pad=1)
    b2 = b.tap()
    b.from_tap(split).conv(c5r, 1).conv(c5, 5, pad=2)
    b3 = b.tap()
    b.from_tap(split).maxpool(3, 1, pad=1).conv(cp, 1)
    b4 = b.tap()
    b.from_tap(b1).concat_from(b2, b3, b4)


def googlenet_tiny(batch: int = 1, num_classes: int = 10, seed: int = 0,
                   in_hw: int = 24) -> Graph:
    """CIFAR-scale GoogLeNet: stem + two inception modules (4-way
    channel merges; a post-merge max-pool between them that the concat
    fusion absorbs into the producers' epilogues) + GAP head — the
    inception-class stress test of the toolflow surveys, small enough
    for interpret mode."""
    b = GraphBuilder("googlenet_tiny", (batch, 3, in_hw, in_hw), seed)
    b.conv(16, 3, pad=1).maxpool(2, 2)
    _inception(b, 8, 8, 12, 4, 6, 6)      # merge Cout 8+12+6+6 = 32
    b.maxpool(2, 2)                        # absorbed by the concat
    _inception(b, 10, 8, 12, 4, 6, 4)     # ragged offsets 0/10/22/28
    b.global_avgpool()
    b.fc(num_classes, relu=False, softmax=True)
    return b.build()


def _fire(b: GraphBuilder, s: int, e1: int, e3: int) -> None:
    """SqueezeNet fire module: 1x1 squeeze feeding parallel 1x1 and 3x3
    expands, channel-concatenated (both expands are dense convs, so the
    2-way merge is concat-epilogue eligible)."""
    b.conv(s, 1)
    split = b.tap()
    b.conv(e1, 1)
    left = b.tap()
    b.from_tap(split).conv(e3, 3, pad=1)
    right = b.tap()
    b.from_tap(left).concat_from(right)


def squeezenet_tiny(batch: int = 1, num_classes: int = 10, seed: int = 0,
                    in_hw: int = 24) -> Graph:
    """CIFAR-scale SqueezeNet: strided stem + three fire modules (2-way
    expand concats; a post-merge max-pool after the second that the
    concat fusion absorbs) + GAP head."""
    b = GraphBuilder("squeezenet_tiny", (batch, 3, in_hw, in_hw), seed)
    b.conv(16, 3, stride=2, pad=1)
    _fire(b, 8, 12, 12)
    _fire(b, 8, 12, 12)
    b.maxpool(2, 2)                        # absorbed by fire-2's concat
    _fire(b, 12, 20, 12)                   # ragged offsets 0/20
    b.global_avgpool()
    b.fc(num_classes, relu=False, softmax=True)
    return b.build()


# ---------------------------------------------------------------------
# Float oracle: run the graph directly with torch ops (NCHW, float32).
# ---------------------------------------------------------------------

def _pad_hw(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """ONNX pads (top, left, bottom, right) on an NCHW tensor."""
    if not any(pads):
        return x
    return F.pad(x, (pads[1], pads[3], pads[0], pads[2]), value=value)


def run_float(graph: Graph, x, return_env: bool = False,
              device: _device.DeviceLike = None):
    """Execute the ONNX-lite graph in float32 — the emulation-mode
    accuracy oracle against which the int8 pipeline is validated.

    ``x`` is an NCHW array or tensor; it and the initializers move to
    ``device`` (CUDA by default).  Convolutions and products run in
    full float32: TF32 is switched off for the call (see
    :func:`repro_torch.device.full_float32`)."""
    dev = _device.resolve(device)
    with torch.no_grad(), _device.full_float32():
        env: Dict[str, torch.Tensor] = {
            graph.inputs[0].name: torch.as_tensor(
                np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                dtype=torch.float32, device=dev)}
        for k, v in graph.initializers.items():
            env[k] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        for n in graph.nodes:
            env[n.outputs[0]] = _float_node(n, env)
    if return_env:
        return env
    return env[graph.outputs[0]]


def _float_node(n: Node, env: Dict[str, torch.Tensor]) -> torch.Tensor:
    if n.op_type == "Conv":
        xin, w = env[n.inputs[0]], env[n.inputs[1]]
        out = F.conv2d(_pad_hw(xin, n.attr("pads", [0, 0, 0, 0])), w,
                       stride=tuple(n.attr("strides", [1, 1])),
                       dilation=tuple(n.attr("dilations", [1, 1])),
                       groups=int(n.attr("group", 1)))
        if len(n.inputs) > 2:
            out = out + env[n.inputs[2]][None, :, None, None]
        return out
    if n.op_type == "MaxPool":
        k = n.attr("kernel_shape")
        s = n.attr("strides", k)
        xin = _pad_hw(env[n.inputs[0]], n.attr("pads", [0, 0, 0, 0]),
                      value=float("-inf"))
        return F.max_pool2d(xin, tuple(k), tuple(s))
    if n.op_type == "GlobalAveragePool":
        return env[n.inputs[0]].mean(dim=(2, 3), keepdim=True)
    if n.op_type == "AveragePool":
        k = n.attr("kernel_shape")
        s = n.attr("strides", k)
        p = n.attr("pads", [0, 0, 0, 0])
        xin = env[n.inputs[0]]
        summed = F.avg_pool2d(_pad_hw(xin, p), tuple(k), tuple(s),
                              divisor_override=1)
        if any(p):
            # ONNX count_include_pad=0: divide by the real window
            # population, matching the int8 path
            ones = torch.ones_like(xin[:1, :1])
            counts = F.avg_pool2d(_pad_hw(ones, p), tuple(k), tuple(s),
                                  divisor_override=1)
            return summed / counts
        return summed / (k[0] * k[1])
    if n.op_type == "Relu":
        return F.relu(env[n.inputs[0]])
    if n.op_type == "Clip":
        bounds = [env[n.inputs[k]] if len(n.inputs) > k and n.inputs[k]
                  else n.attr(key) for k, key in ((1, "min"), (2, "max"))]
        return torch.clamp(env[n.inputs[0]], *bounds)
    if n.op_type == "Softmax":
        return torch.softmax(env[n.inputs[0]], dim=int(n.attr("axis", -1)))
    if n.op_type == "Gemm":
        a, w = env[n.inputs[0]], env[n.inputs[1]]
        if int(n.attr("transA", 0)):
            a = a.T
        if int(n.attr("transB", 0)):
            w = w.T
        out = a @ w
        if len(n.inputs) > 2:
            out = out + env[n.inputs[2]]
        return out
    if n.op_type == "MatMul":
        return env[n.inputs[0]] @ env[n.inputs[1]]
    if n.op_type == "Flatten":
        xin = env[n.inputs[0]]
        axis = int(n.attr("axis", 1))
        lead = int(np.prod(xin.shape[:axis])) if axis else 1
        return xin.reshape(lead, -1)
    if n.op_type == "Reshape":
        target = n.attr("shape") or env[n.inputs[1]].tolist()
        return env[n.inputs[0]].reshape([int(t) for t in target])
    if n.op_type == "Add":
        return env[n.inputs[0]] + env[n.inputs[1]]
    if n.op_type == "Concat":
        return torch.cat([env[i] for i in n.inputs],
                         dim=int(n.attr("axis", 1)))
    if n.op_type in ("Dropout", "Identity"):
        return env[n.inputs[0]]
    raise NotImplementedError(n.op_type)


def collect_activations(graph: Graph, x,
                        device: _device.DeviceLike = None
                        ) -> Dict[str, np.ndarray]:
    """Run float and keep every intermediate (for PTQ calibration), as
    host numpy arrays."""
    env = run_float(graph, x, return_env=True, device=device)
    return {k: v.cpu().numpy() for k, v in env.items()}

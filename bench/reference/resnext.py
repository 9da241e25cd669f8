"""The ``resnext`` family: residual CNNs of bottleneck blocks whose 3x3
convs are grouped (ResNeXt), and their plain reference, in plain torch.

A configuration of this family (``"family": "resnext"``) gives a stem
(``{"out", "kernel", "stride", "pad", "pool": [kernel, stride, pad]}``:
a conv with ReLU and a padded max-pool), ``stages`` of bottleneck blocks
as ``[width, out, blocks, stride]``, the ``cardinality`` of their
grouped convs, and the ``classes`` of the FC after a global average
pool.  A bottleneck block is a 1x1 conv to ``width`` with a ReLU, a 3x3
conv of ``cardinality`` groups with pad 1 and a ReLU, which carries the
stage's stride in its first block, a 1x1 conv to ``out`` with no ReLU,
and an ``Add`` of that and the block's input, followed by a ReLU; where
the stride or width changes, the input first goes through a 1x1
projection conv of the block's stride (ResNet option B).  The layer
table (:func:`layers_of`) is a DAG as in ``bench/reference/resnet.py``:
each layer names what it reads, and of the two convs an add reads, the
one later in the table carries the add's other operand as ``skip``.

It imports nothing of the program and takes nothing the program made.
Its arithmetic is the fixed-point semantics of the CNN2Gate flow,
written from the rules (DESIGN.md, "Residual requantization math") and
not from the port: those of ``resnet.py``, with grouped convs (group g
of G reads input channels [g*Cin/G, (g+1)*Cin/G) and writes output
channels [g*Cout/G, (g+1)*Cout/G)).

The scales come from :func:`calibrate`: the residual rule of
``resnet.py`` on this family's float forward.  The integer products run
in float64 on NCHW tensors (``F.conv2d`` with ``groups``): every product
of two int8 values and every partial sum is an integer far below 2**53.
The control of the comparison is this forward at ``bits=4``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from bench import counts, model
from bench.reference.cnn import (INT32_MAX, INT32_MIN, Specs, _quantize,
                                 _requant, full_float32, pow2_exponent)
from bench.reference.resnet import (INPUT, _align, _readers, _window,
                                    bound_s)


@dataclasses.dataclass(frozen=True)
class Layer:
    """One node of the DAG with the shapes of one image through it
    (batch excluded).  ``op`` is ``conv``, ``maxpool``, ``add``, ``gap``
    or ``fc``; ``inputs`` names the layers it reads (or :data:`INPUT`).
    ``group`` is a conv's groups; ``skip`` is set on the conv that takes
    an add in its epilogue: the add's other operand."""

    name: str
    op: str
    inputs: Tuple[str, ...]
    in_shape: Tuple[int, ...]    # (C, H, W); (K,) for the FC
    out_shape: Tuple[int, ...]
    out: int = 0                 # output channels or features
    kernel: int = 1
    stride: int = 1
    pad: int = 0
    relu: bool = False
    group: int = 1
    skip: str = ""

    @property
    def weighted(self) -> bool:
        return self.op in ("conv", "fc")

    @property
    def grouped(self) -> bool:
        return self.op == "conv" and self.group > 1

    @property
    def weight_shape(self) -> Tuple[int, ...]:
        if self.op == "fc":
            return (self.in_shape[0], self.out)           # (in, out)
        return (self.out, self.in_shape[0] // self.group, self.kernel,
                self.kernel)                              # OIHW

    @property
    def fan_in(self) -> int:
        """The contraction depth: K = KH * KW * Cin/G of a conv."""
        if self.op == "fc":
            return self.in_shape[0]
        return self.in_shape[0] // self.group * self.kernel * self.kernel

    @property
    def macs(self) -> int:
        """Multiply-accumulates of one image (0 for what has no weight)."""
        if self.op == "fc":
            return self.in_shape[0] * self.out
        if self.op != "conv":
            return 0
        _c, h, w = self.out_shape
        return h * w * self.out * self.fan_in


def layers_of(config: dict) -> List[Layer]:
    """The DAG of a configuration, in the order an exporter writes the
    graph (in a block: conv1, conv2, conv3, the projection, the add)."""
    out: List[Layer] = []
    groups = config["cardinality"]

    def conv(name, src, in_shape, c_out, k, s, p, relu, group=1):
        c, h, w = in_shape
        o = (c_out, _window(h, k, s, p), _window(w, k, s, p))
        out.append(Layer(name, "conv", (src,), in_shape, o, c_out, k, s, p,
                         relu, group))
        return o

    st = config["stem"]
    shape_c = conv("conv1", INPUT, tuple(config["input"]), st["out"],
                   st["kernel"], st["stride"], st["pad"], True)
    k, s, p = st["pool"]
    c, h, w = shape_c
    shape = (c, _window(h, k, s, p), _window(w, k, s, p))
    out.append(Layer("maxpool", "maxpool", ("conv1",), shape_c, shape,
                     c, k, s, p))
    cur = "maxpool"
    for g, (width, c_out, blocks, first) in enumerate(config["stages"],
                                                      start=1):
        for blk in range(blocks):
            pre = f"layer{g}_{blk}"
            stride = first if blk == 0 else 1
            mid = conv(f"{pre}_conv1", cur, shape, width, 1, 1, 0, True)
            mid = conv(f"{pre}_conv2", f"{pre}_conv1", mid, width, 3, stride,
                       1, True, groups)
            end = conv(f"{pre}_conv3", f"{pre}_conv2", mid, c_out, 1, 1, 0,
                       False)
            skip = cur
            if stride != 1 or shape[0] != c_out:
                conv(f"{pre}_downsample", cur, shape, c_out, 1, stride, 0,
                     False)
                skip = f"{pre}_downsample"
            operands = (f"{pre}_conv3", skip)
            out.append(Layer(f"{pre}_add", "add", operands, end, end, c_out,
                             relu=True))
            # the conv of the two operands that comes later takes the add
            host = max(i for i, l in enumerate(out[:-1])
                       if l.name in operands and l.op == "conv")
            other = [t for t in operands if t != out[host].name][0]
            out[host] = dataclasses.replace(out[host], skip=other)
            cur, shape = f"{pre}_add", end
    c = shape[0]
    out.append(Layer("gap", "gap", (cur,), shape, (c, 1, 1), c))
    out.append(Layer("fc", "fc", ("gap",), (c,), (config["classes"],),
                     config["classes"]))
    return out


def make_weights(layers: List[Layer], seed: int, device
                 ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Every conv's and the FC's float32 (weight, bias) from ``seed``: He
    normal weights N(0, 2/fan_in), a grouped conv's fan-in 9 * Cin/G,
    biases N(0, 0.01^2) (:func:`bench.model.make_weights` over the
    weighted layers)."""
    return model.make_weights([l for l in layers if l.weighted], seed,
                              device)


def model_dict(config: dict, layers: List[Layer], batch: int = 1) -> dict:
    """The configuration as an ONNX-lite model dict: Conv (with
    ``group``), Relu, MaxPool (padded), Add, GlobalAveragePool, Flatten
    and Gemm nodes (the weight as (in, out), ``transB`` 0), each named by
    its layer (the Relu of layer ``l`` is ``l_relu``).  Initializers are
    ``<layer>_w`` and ``<layer>_b``."""
    nodes = []
    tensor = {INPUT: INPUT}

    def node(op, name, inputs, attrs=None):
        out = f"{name}_out"
        nodes.append({"op_type": op, "name": name, "inputs": inputs,
                      "outputs": [out], "attrs": attrs or {}})
        return out

    for l in layers:
        src = [tensor[t] for t in l.inputs]
        k, s, p = l.kernel, l.stride, l.pad
        if l.op == "conv":
            t = node("Conv", l.name, src + [f"{l.name}_w", f"{l.name}_b"],
                     {"kernel_shape": [k, k], "strides": [s, s],
                      "pads": [p, p, p, p], "dilations": [1, 1],
                      "group": l.group})
        elif l.op == "maxpool":
            t = node("MaxPool", l.name, src,
                     {"kernel_shape": [k, k], "strides": [s, s],
                      "pads": [p, p, p, p]})
        elif l.op == "add":
            t = node("Add", l.name, src)
        elif l.op == "gap":
            t = node("GlobalAveragePool", l.name, src)
            t = node("Flatten", f"{l.name}_flatten", [t], {"axis": 1})
        else:
            t = node("Gemm", l.name, src + [f"{l.name}_w", f"{l.name}_b"],
                     {"transA": 0, "transB": 0})
        if l.relu:
            t = node("Relu", f"{l.name}_relu", [t])
        tensor[l.name] = t
    return {"format_version": 1, "name": config["name"],
            "inputs": [{"name": INPUT,
                        "shape": [batch] + list(config["input"]),
                        "dtype": "float32"}],
            "outputs": [tensor[layers[-1].name]], "nodes": nodes}


def forward_counts(layers: List[Layer], batch: int) -> Dict[str, float]:
    """Per forward of ``batch`` images: int8 operations of the convs and
    the FC, and the summed bounds (seconds, ``resnet.bound_s``: a conv
    that takes an add also reads the add's other operand) of the conv
    calls, grouped ones included, of the FC call, and of the grouped
    calls alone (``gconv_bound_s``, each with its K = 9 * Cin/G)."""
    return {
        "ops": sum(counts.ops(l, batch) for l in layers if l.weighted),
        "conv_bound_s": sum(bound_s(l, batch) for l in layers
                            if l.op == "conv"),
        "fc_bound_s": sum(bound_s(l, batch) for l in layers
                          if l.op == "fc"),
        "gconv_bound_s": sum(bound_s(l, batch) for l in layers
                             if l.grouped),
    }


@torch.no_grad()
def float_forward(layers: List[Layer], weights, x: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """Every layer's float32 output (after its ReLU) for NCHW images
    ``x``, by layer name, and ``x`` under :data:`INPUT`."""
    env = {INPUT: x}
    with full_float32():
        for l in layers:
            h = env[l.inputs[0]]
            if l.op == "conv":
                w, b = weights[l.name]
                h = F.conv2d(h, w, b, stride=l.stride, padding=l.pad,
                             groups=l.group)
            elif l.op == "maxpool":
                h = F.max_pool2d(h, l.kernel, l.stride, padding=l.pad)
            elif l.op == "add":
                h = h + env[l.inputs[1]]
            elif l.op == "gap":
                h = h.mean(dim=(2, 3), keepdim=True)
            else:
                w, b = weights[l.name]
                h = h.flatten(1) @ w + b
            if l.relu:
                h = torch.relu(h)
            env[l.name] = h
    return env


def calibrate(layers: List[Layer], weights, x_cal: torch.Tensor,
              bits: int = 8) -> Tuple[int, Specs]:
    """The input's exponent, each conv's and the FC's (m_w, m_x, m_y) and
    each add's (0, m_common, m_y), by DESIGN.md's residual rule
    (``resnet.calibrate``'s three steps) on this family's float
    forward."""
    acts = float_forward(layers, weights, x_cal)
    desired = {t: pow2_exponent(float(a.abs().max()), bits)
               for t, a in acts.items()}
    changed = True
    while changed:
        changed = False
        for l in layers:
            if l.op != "add":
                continue
            m = min(desired[t] for t in l.inputs)
            for t in l.inputs:
                if desired[t] != m:
                    desired[t], changed = m, True
    pos = {INPUT: desired[INPUT]}
    specs: Specs = {}
    for l in layers:
        if l.weighted:
            m_w = pow2_exponent(float(weights[l.name][0].abs().max()), bits)
            m_x = pos[l.inputs[0]]
            m_y = min(desired[l.name], m_w + m_x)
            specs[l.name] = (m_w, m_x, m_y)
        elif l.op == "add":
            m_common = min(pos[t] for t in l.inputs)
            m_y = min(desired[l.name], m_common)
            specs[l.name] = (0, m_common, m_y)
        else:
            m_y = pos[l.inputs[0]]
        pos[l.name] = m_y
    return pos[INPUT], specs


@torch.no_grad()
def int_forward(layers: List[Layer], weights, m_in: int, specs: Specs,
                x: torch.Tensor, bits: int = 8, block: int = 16
                ) -> torch.Tensor:
    """Float32 logits of the fixed-point forward of NCHW float32 images
    ``x`` at ``bits``, ``block`` images at a time; the result is on
    ``x``'s device.  Each tensor is dropped after its last reader."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    staged = {}
    for l in layers:
        if not l.weighted:
            continue
        m_w, m_x, m_y = specs[l.name]
        if m_w + m_x - m_y < 0:
            raise ValueError(f"{l.name}: negative requant shift "
                             f"{specs[l.name]}")
        w, b = weights[l.name]
        staged[l.name] = (_quantize(w.to(x.device), m_w, lo, hi),
                          _quantize(b.to(x.device), m_w + m_x, INT32_MIN,
                                    INT32_MAX))
    last = _readers(layers)
    pos = {INPUT: m_in}
    for l in layers:
        pos[l.name] = specs[l.name][2] if l.name in specs \
            else pos[l.inputs[0]]
    out = []
    for i0 in range(0, x.shape[0], block):
        env = {INPUT: _quantize(x[i0:i0 + block], m_in, lo, hi)}
        for i, l in enumerate(layers):
            h = env[l.inputs[0]]
            if l.weighted:
                m_w, m_x, m_y = specs[l.name]
                wq, bq = staged[l.name]
                if l.op == "conv":
                    acc = F.conv2d(h, wq, stride=l.stride, padding=l.pad,
                                   groups=l.group)
                    acc = torch.round(acc) + bq[:, None, None]
                else:
                    acc = torch.round(h.flatten(1) @ wq) + bq
                h = _requant(acc, m_w + m_x - m_y, l.relu, lo, hi)
            elif l.op == "maxpool":
                h = F.pad(h, (l.pad,) * 4, value=lo)
                h = h.unfold(2, l.kernel, l.stride).unfold(
                    3, l.kernel, l.stride).amax((-2, -1))
            elif l.op == "gap":
                # in int64: a float division by the population may run as
                # a product with its reciprocal (it does on CUDA), which
                # is not exact
                n = h.shape[2] * h.shape[3]
                s = h.sum((2, 3), keepdim=True).long()
                h = torch.div(s + n // 2, n, rounding_mode="floor").double()
            else:  # add
                _m, m_common, m_y = specs[l.name]
                a, b = (_align(env[t], pos[t] - m_common) for t in l.inputs)
                h = _requant(a + b, m_common - m_y, l.relu, lo, hi)
            env[l.name] = h
            for t in l.inputs:
                if last[t] == i:
                    env.pop(t, None)
        logits = env[layers[-1].name]
        out.append(logits.float() * 2.0 ** -pos[layers[-1].name])
    return torch.cat(out)

"""The ``mobilenet`` family: MobileNetV2-style nets of inverted residual
blocks, and their plain reference, in plain torch.

A configuration of this family (``"family": "mobilenet"``) gives a stem
(``{"out", "kernel", "stride", "pad"}``: a conv with a ReLU-n), the
``blocks`` as the paper's rows ``[t, c, n, s]`` (expansion, output
channels, blocks, the first block's stride), the ``head`` width, the
``classes`` of the FC after a global average pool, and ``clip``, the
upper bound n of every ReLU-n (6: ReLU6).  An inverted residual block is
a 1x1 expansion conv to t times its input's channels with a ReLU-n (none
where t is 1), a 3x3 depthwise conv of the block's stride and pad 1 with
a ReLU-n, and a linear 1x1 projection (no activation); where the stride
is 1 and the width holds, an ``Add`` of the projection and the block's
input follows, with no activation either (the linear bottleneck).  The
head is a 1x1 conv with a ReLU-n.  The layer table (:func:`layers_of`)
is a DAG as in ``bench/reference/resnet.py``: each layer names what it
reads, and the projection of a block with an add carries the add's other
operand as ``skip``.

It imports nothing of the program and takes nothing the program made.
Its arithmetic is the fixed-point semantics of the CNN2Gate flow, written
from the rules (DESIGN.md, "Residual requantization math" and "ReLU-n
fixed-point rule") and not from the port: those of ``resnet.py``, with
grouped convs (one group a channel for the depthwise ones) and, for a
layer with a ReLU-n of bound n and output position m_y, the clamp of its
requantized value to ``[0, min(2**(bits-1) - 1, floor(n * 2**m_y))]``
in place of the ReLU and the saturation.  The adds have no ReLU.

The scales come from :func:`calibrate`: the residual rule of
``resnet.py`` on a float forward in which each ReLU-n clamps.  The
integer products run in float64 on NCHW tensors (a depthwise conv as a
grouped conv): every product of two int8 values and every partial sum is
an integer far below 2**53.  The control of the comparison is this
forward at ``bits=4``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

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
    (batch excluded).  ``op`` is ``conv``, ``add``, ``gap`` or ``fc``;
    ``inputs`` names the layers it reads (or :data:`INPUT`).  ``group``
    is the conv's groups (its input channels for a depthwise conv);
    ``clip`` the bound of its ReLU-n, None without one; ``skip`` is set
    on the projection that takes its block's add: the add's other
    operand."""

    name: str
    op: str
    inputs: Tuple[str, ...]
    in_shape: Tuple[int, ...]    # (C, H, W); (K,) for the FC
    out_shape: Tuple[int, ...]
    out: int = 0                 # output channels or features
    kernel: int = 1
    stride: int = 1
    pad: int = 0
    group: int = 1
    clip: Optional[float] = None
    skip: str = ""

    @property
    def weighted(self) -> bool:
        return self.op in ("conv", "fc")

    @property
    def depthwise(self) -> bool:
        return self.op == "conv" and self.group > 1

    @property
    def weight_shape(self) -> Tuple[int, ...]:
        if self.op == "fc":
            return (self.in_shape[0], self.out)           # (in, out)
        return (self.out, self.in_shape[0] // self.group, self.kernel,
                self.kernel)                              # OIHW

    @property
    def fan_in(self) -> int:
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
    graph (in a block: expansion, depthwise, projection, add)."""
    out: List[Layer] = []
    bound = float(config["clip"])

    def conv(name, src, in_shape, c_out, k, s, p, group=1, clip=None):
        c, h, w = in_shape
        o = (c_out, _window(h, k, s, p), _window(w, k, s, p))
        out.append(Layer(name, "conv", (src,), in_shape, o, c_out, k, s, p,
                         group, clip))
        return o

    st = config["stem"]
    shape = conv("stem", INPUT, tuple(config["input"]), st["out"],
                 st["kernel"], st["stride"], st["pad"], clip=bound)
    cur = "stem"
    b = 0
    for t, c_out, n, s in config["blocks"]:
        for i in range(n):
            b += 1
            pre, stride = f"block{b}", s if i == 0 else 1
            block_in, c_in = cur, shape[0]
            if t != 1:
                shape = conv(f"{pre}_expand", cur, shape, c_in * t, 1, 1, 0,
                             clip=bound)
                cur = f"{pre}_expand"
            shape = conv(f"{pre}_dw", cur, shape, shape[0], 3, stride, 1,
                         group=shape[0], clip=bound)
            shape = conv(f"{pre}_project", f"{pre}_dw", shape, c_out, 1, 1,
                         0)
            cur = f"{pre}_project"
            if stride == 1 and c_in == c_out:
                # the projection, the later of the two operands, takes it
                out[-1] = dataclasses.replace(out[-1], skip=block_in)
                out.append(Layer(f"{pre}_add", "add", (cur, block_in), shape,
                                 shape, c_out))
                cur = f"{pre}_add"
    shape = conv("head", cur, shape, config["head"], 1, 1, 0, clip=bound)
    c = shape[0]
    out.append(Layer("gap", "gap", ("head",), shape, (c, 1, 1), c))
    out.append(Layer("fc", "fc", ("gap",), (c,), (config["classes"],),
                     config["classes"]))
    return out


def clip_entry(bound: float) -> str:
    """The name under which :func:`make_weights` holds a ReLU-n's
    (min, max): ``relu6`` for ReLU6."""
    return f"relu{bound:g}"


def make_weights(layers: List[Layer], seed: int, device
                 ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Every conv's and the FC's float32 (weight, bias) from ``seed``: He
    normal weights N(0, 2/fan_in), a depthwise conv's fan-in its window,
    biases N(0, 0.01^2) (:func:`bench.model.make_weights` over the
    weighted layers).  Besides, for each ReLU-n bound, the scalar pair
    (0, n) under :func:`clip_entry`: the harness hands every entry to the
    program as the initializers ``<name>_w`` and ``<name>_b``, which the
    model dict's ``Clip`` nodes read as their min and max."""
    out = model.make_weights([l for l in layers if l.weighted], seed,
                             device)
    for bound in sorted({l.clip for l in layers if l.clip is not None}):
        out[clip_entry(bound)] = (torch.zeros((), device=device),
                                  torch.full((), bound, device=device))
    return out


def model_dict(config: dict, layers: List[Layer], batch: int = 1) -> dict:
    """The configuration as an ONNX-lite model dict: Conv (with ``group``),
    Clip, Add, GlobalAveragePool, Flatten and Gemm nodes (the weight as
    (in, out), ``transB`` 0), each named by its layer.  A ReLU-n is a
    ``Clip`` named ``<layer>_clip`` whose min and max are scalar
    initializers, as PyTorch's exporter writes ReLU6 since opset 11.
    Initializers are ``<layer>_w`` and ``<layer>_b``."""
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
        elif l.op == "add":
            t = node("Add", l.name, src)
        elif l.op == "gap":
            t = node("GlobalAveragePool", l.name, src)
            t = node("Flatten", f"{l.name}_flatten", [t], {"axis": 1})
        else:
            t = node("Gemm", l.name, src + [f"{l.name}_w", f"{l.name}_b"],
                     {"transA": 0, "transB": 0})
        if l.clip is not None:
            e = clip_entry(l.clip)
            t = node("Clip", f"{l.name}_clip", [t, f"{e}_w", f"{e}_b"])
        tensor[l.name] = t
    return {"format_version": 1, "name": config["name"],
            "inputs": [{"name": INPUT,
                        "shape": [batch] + list(config["input"]),
                        "dtype": "float32"}],
            "outputs": [tensor[layers[-1].name]], "nodes": nodes}


def forward_counts(layers: List[Layer], batch: int) -> Dict[str, float]:
    """Per forward of ``batch`` images: int8 operations of the convs and
    the FC, and the summed bounds (seconds, ``resnet.bound_s``: a
    projection that takes an add also reads the add's other operand) of
    the conv calls, dense and depthwise, of the FC call, and of the
    depthwise calls alone (``dwconv_bound_s``)."""
    return {
        "ops": sum(counts.ops(l, batch) for l in layers if l.weighted),
        "conv_bound_s": sum(bound_s(l, batch) for l in layers
                            if l.op == "conv"),
        "fc_bound_s": sum(bound_s(l, batch) for l in layers
                          if l.op == "fc"),
        "dwconv_bound_s": sum(bound_s(l, batch) for l in layers
                              if l.depthwise),
    }


@torch.no_grad()
def float_forward(layers: List[Layer], weights, x: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """Every layer's float32 output (after its ReLU-n) for NCHW images
    ``x``, by layer name, and ``x`` under :data:`INPUT`."""
    env = {INPUT: x}
    with full_float32():
        for l in layers:
            h = env[l.inputs[0]]
            if l.op == "conv":
                w, b = weights[l.name]
                h = F.conv2d(h, w, b, stride=l.stride, padding=l.pad,
                             groups=l.group)
            elif l.op == "add":
                h = h + env[l.inputs[1]]
            elif l.op == "gap":
                h = h.mean(dim=(2, 3), keepdim=True)
            else:
                w, b = weights[l.name]
                h = h.flatten(1) @ w + b
            if l.clip is not None:
                h = h.clamp(0.0, l.clip)
            env[l.name] = h
    return env


def calibrate(layers: List[Layer], weights, x_cal: torch.Tensor,
              bits: int = 8) -> Tuple[int, Specs]:
    """The input's exponent, each conv's and the FC's (m_w, m_x, m_y) and
    each add's (0, m_common, m_y), by DESIGN.md's residual rule
    (``resnet.calibrate``'s three steps) on a float forward in which each
    ReLU-n clamps."""
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


def clamp_code(bound: float, m_y: int, bits: int = 8) -> int:
    """The ReLU-n rule: the largest integer at position ``m_y`` that the
    bound allows, within the ``bits``-wide signed range."""
    return min((1 << (bits - 1)) - 1, math.floor(bound * 2.0 ** m_y))


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
        top = hi if l.clip is None else clamp_code(l.clip, m_y, bits)
        staged[l.name] = (_quantize(w.to(x.device), m_w, lo, hi),
                          _quantize(b.to(x.device), m_w + m_x, INT32_MIN,
                                    INT32_MAX), top)
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
                wq, bq, top = staged[l.name]
                if l.op == "conv":
                    acc = F.conv2d(h, wq, stride=l.stride, padding=l.pad,
                                   groups=l.group)
                    acc = torch.round(acc) + bq[:, None, None]
                else:
                    acc = torch.round(h.flatten(1) @ wq) + bq
                h = _requant(acc, m_w + m_x - m_y, l.clip is not None, lo,
                             top)
            elif l.op == "gap":
                # in int64: a float division by the population may run as
                # a product with its reciprocal (it does on CUDA), which
                # is not exact
                n = h.shape[2] * h.shape[3]
                s = h.sum((2, 3), keepdim=True).long()
                h = torch.div(s + n // 2, n, rounding_mode="floor").double()
            else:  # add, linear
                _m, m_common, m_y = specs[l.name]
                a, b = (_align(env[t], pos[t] - m_common) for t in l.inputs)
                h = _requant(a + b, m_common - m_y, False, lo, hi)
            env[l.name] = h
            for t in l.inputs:
                if last[t] == i:
                    env.pop(t, None)
        logits = env[layers[-1].name]
        out.append(logits.float() * 2.0 ** -pos[layers[-1].name])
    return torch.cat(out)

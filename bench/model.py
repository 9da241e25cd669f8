"""A configuration's layer table: its shapes, its seeded weights and its
ONNX-lite model dict.

A configuration file (``bench/configs/<name>.json``) names its
``family``, the module ``bench/reference/<family>.py`` that reads its
layer table and holds its plain reference (:func:`family`).  This file
is the ``cnn`` family's table: a chain CNN as ``layers``: ``{"op": "conv", "out", "kernel", "stride", "pad",
"relu", "pool": [kernel, stride]}`` and ``{"op": "fc", "out", "relu"}``
entries over an NCHW ``input`` of ``[C, H, W]``.  Everything here is
plain torch: the plain reference and the harness read the same shapes,
and the program receives only the model dict and the weights.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import re
from pathlib import Path
from typing import Dict, List, Tuple

import torch

BENCH = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Layer:
    """One weighted stage with its fused ReLU and max-pool, and the
    shapes of one image through it (batch excluded)."""

    name: str
    op: str                      # "conv" or "fc"
    in_shape: Tuple[int, ...]    # (C, H, W) for a conv, (K,) for an FC
    out: int
    kernel: int = 1
    stride: int = 1
    pad: int = 0
    relu: bool = True
    pool: Tuple[int, int] = ()   # (kernel, stride), no padding
    conv_hw: Tuple[int, int] = ()  # conv output before the pool

    @property
    def out_shape(self) -> Tuple[int, ...]:
        if self.op == "fc":
            return (self.out,)
        h, w = self.conv_hw
        if self.pool:
            k, s = self.pool
            h, w = (h - k) // s + 1, (w - k) // s + 1
        return (self.out, h, w)

    @property
    def weight_shape(self) -> Tuple[int, ...]:
        if self.op == "fc":
            return (self.in_shape[0], self.out)          # (in, out)
        c = self.in_shape[0]
        return (self.out, c, self.kernel, self.kernel)   # OIHW

    @property
    def fan_in(self) -> int:
        if self.op == "fc":
            return self.in_shape[0]
        return self.in_shape[0] * self.kernel * self.kernel

    @property
    def macs(self) -> int:
        """Multiply-accumulates of one image."""
        if self.op == "fc":
            return self.in_shape[0] * self.out
        h, w = self.conv_hw
        return h * w * self.out * self.fan_in


def load_config(name_or_path) -> dict:
    """A configuration by its name (``bench/configs/<name>.json``) or
    its path."""
    p = Path(name_or_path)
    if p.suffix != ".json":
        p = BENCH / "configs" / f"{name_or_path}.json"
    with open(p) as f:
        return json.load(f)


def family(config: dict):
    """The module of the configuration's family,
    ``bench/reference/<family>.py``.  It gives the family's layer table
    (``layers_of``), seeded float weights (``make_weights``), ONNX-lite
    model dict (``model_dict``), op and byte counts
    (``forward_counts``), and its plain reference (``calibrate``,
    ``int_forward``)."""
    name = config["family"]
    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"family {name!r} is no module name")
    return importlib.import_module(f"bench.reference.{name}")


def layers_of(config: dict) -> List[Layer]:
    """The weighted stages of a configuration, with their shapes."""
    shape = tuple(config["input"])
    out: List[Layer] = []
    for i, spec in enumerate(config["layers"]):
        op = spec["op"]
        if op == "conv":
            c, h, w = shape
            k, s, p = spec["kernel"], spec.get("stride", 1), spec.get("pad", 0)
            hw = ((h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1)
            layer = Layer(f"conv{i + 1}", "conv", shape, spec["out"], k, s, p,
                          spec.get("relu", True), tuple(spec.get("pool", ())),
                          hw)
        elif op == "fc":
            k_in = 1
            for d in shape:
                k_in *= d
            layer = Layer(f"fc{i + 1}", "fc", (k_in,), spec["out"],
                          relu=spec.get("relu", True))
        else:
            raise ValueError(f"unknown layer op {op!r}")
        out.append(layer)
        shape = layer.out_shape
    return out


def make_weights(layers: List[Layer], seed: int, device
                 ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Every layer's float32 (weight, bias) from ``seed``: He normal
    weights N(0, 2/fan_in), biases N(0, 0.01^2), drawn on ``device`` by
    one generator in two calls (all weights, all biases) and cut into
    the layers' shapes."""
    gen = generator(seed, 0, device)
    n_w = sum(_numel(l.weight_shape) for l in layers)
    n_b = sum(l.out for l in layers)
    flat_w = torch.randn(n_w, generator=gen, device=device)
    flat_b = torch.randn(n_b, generator=gen, device=device).mul_(0.01)
    out, iw, ib = {}, 0, 0
    for l in layers:
        n = _numel(l.weight_shape)
        w = flat_w[iw:iw + n].view(l.weight_shape).mul_((2.0 / l.fan_in) ** 0.5)
        out[l.name] = (w, flat_b[ib:ib + l.out])
        iw, ib = iw + n, ib + l.out
    return out


def make_images(n: int, shape, seed: int, stream: int, device) -> torch.Tensor:
    """``n`` float32 NCHW images, standard normal per pixel, from
    ``seed``; ``stream`` keeps the calibration image and each pool
    apart (stream 0 is the weights')."""
    return torch.randn((n,) + tuple(shape),
                       generator=generator(seed, stream, device),
                       device=device)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of a run: the
    seed may be any whole number, the driver's exceed 32 bits."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1009 + stream) % (1 << 63))
    return gen


def model_dict(config: dict, layers: List[Layer], batch: int = 1) -> dict:
    """The configuration as an ONNX-lite model dict: Conv, Relu and
    MaxPool nodes, a Flatten before the first Gemm, Gemm nodes with the
    weight as (in, out) (``transB`` 0).  Initializers are named
    ``<layer>_w`` and ``<layer>_b``."""
    nodes = []
    cur = "input"

    def node(op, name, inputs, attrs=None):
        nonlocal cur
        out = f"{name}_out"
        nodes.append({"op_type": op, "name": name, "inputs": inputs,
                      "outputs": [out], "attrs": attrs or {}})
        cur = out

    for l in layers:
        if l.op == "conv":
            k, s, p = l.kernel, l.stride, l.pad
            node("Conv", l.name, [cur, f"{l.name}_w", f"{l.name}_b"],
                 {"kernel_shape": [k, k], "strides": [s, s],
                  "pads": [p, p, p, p], "dilations": [1, 1], "group": 1})
        else:
            if len(_prev_shape(layers, l)) > 1:
                node("Flatten", f"{l.name}_flatten", [cur], {"axis": 1})
            node("Gemm", l.name, [cur, f"{l.name}_w", f"{l.name}_b"],
                 {"transA": 0, "transB": 0})
        if l.relu:
            node("Relu", f"{l.name}_relu", [cur])
        if l.pool:
            k, s = l.pool
            node("MaxPool", f"{l.name}_pool", [cur],
                 {"kernel_shape": [k, k], "strides": [s, s],
                  "pads": [0, 0, 0, 0]})
    return {"format_version": 1, "name": config["name"],
            "inputs": [{"name": "input",
                        "shape": [batch] + list(config["input"]),
                        "dtype": "float32"}],
            "outputs": [cur], "nodes": nodes}


def _prev_shape(layers: List[Layer], l: Layer) -> Tuple[int, ...]:
    i = layers.index(l)
    return layers[i - 1].out_shape if i else ()


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n

"""The ``cnn`` family: chain CNNs of conv and FC layers, and their plain
reference, in plain torch.

A configuration names its family (``"family": "cnn"``); the harness
finds everything that depends on the family here: the layer table, the
weights and the model dict (``bench/model.py``), the op and byte counts
(``bench/counts.py``), and the reference below.

It imports nothing of the program and takes nothing the program made:
from the float weights, the layer table and the images that the
benchmark drew, it works out again every int8 weight, int32 bias and
requantization shift.  Its arithmetic is the fixed-point semantics of
the CNN2Gate flow, written from the rules and not from the port:

* a value is ``N * 2**-m`` with N a signed ``bits``-wide integer; a
  float quantizes by rounding half to even and saturating;
* a conv or FC multiplies the integer operands and adds the bias,
  quantized to int32 at ``2**-(m_w + m_x)``, exactly; the sum is shifted
  right by ``m_w + m_x - m_y`` rounding half up, passed through ReLU and
  saturated to ``bits``; a max-pool follows on the integers;
* the input quantizes at the first layer's ``m_x``, the logits are the
  last layer's integers times ``2**-m_y``.

The integer products run in float64 on NCHW tensors: every product of
two int8 values and every partial sum is an integer far below 2**53, so
float64 holds them exactly on any device.  The scales come from
:func:`calibrate`, the max-abs power-of-two rule on one float forward.
The control of the comparison is this forward at ``bits=4``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from bench.counts import forward_counts  # noqa: F401  (the family's)
from bench.model import layers_of, make_weights, model_dict  # noqa: F401

#: (m_w, m_x, m_y) of each weighted layer, by layer name
Specs = Dict[str, Tuple[int, int, int]]

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Float32 convolutions and products without TF32, restored after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def pow2_exponent(amax: float, bits: int = 8) -> int:
    """The largest m with ``amax * 2**m`` inside a signed ``bits``-wide
    integer, kept within [-(bits - 1), 24]; ``bits - 1`` for zero."""
    if amax == 0.0:
        return bits - 1
    m = math.floor(math.log2((2 ** (bits - 1) - 1) / amax))
    return max(-(bits - 1), min(m, 24))


@torch.no_grad()
def float_forward(layers, weights, x: torch.Tensor) -> List[torch.Tensor]:
    """Each layer's float32 output (after its ReLU and pool) for NCHW
    images ``x``."""
    outs = []
    h = x
    with full_float32():
        for l in layers:
            w, b = weights[l.name]
            if l.op == "conv":
                h = F.conv2d(h, w, b, stride=l.stride, padding=l.pad)
            else:
                h = h.flatten(1) @ w + b
            if l.relu:
                h = torch.relu(h)
            if l.pool:
                h = F.max_pool2d(h, l.pool[0], l.pool[1])
            outs.append(h)
    return outs


def calibrate(layers, weights, x_cal: torch.Tensor, bits: int = 8
              ) -> Tuple[int, Specs]:
    """The input's exponent and each layer's (m_w, m_x, m_y): max-abs
    power-of-two exponents of the weights and of one float forward of
    ``x_cal``; each layer's m_x is the tensor position its producer
    left, and m_y is capped at m_w + m_x so that no shift is negative."""
    acts = float_forward(layers, weights, x_cal)
    m_in = pow2_exponent(float(x_cal.abs().max()), bits)
    specs: Specs = {}
    m_x = m_in
    for l, a in zip(layers, acts):
        m_w = pow2_exponent(float(weights[l.name][0].abs().max()), bits)
        m_y = min(pow2_exponent(float(a.abs().max()), bits), m_w + m_x)
        specs[l.name] = (m_w, m_x, m_y)
        m_x = m_y
    return m_in, specs


def _quantize(x: torch.Tensor, m: int, lo: int, hi: int) -> torch.Tensor:
    return torch.clamp(torch.round(x.double() * 2.0 ** m), lo, hi)


def _requant(acc: torch.Tensor, shift: int, relu: bool, lo: int,
             hi: int) -> torch.Tensor:
    if shift > 0:
        acc = torch.floor((acc + 2.0 ** (shift - 1)) / 2.0 ** shift)
    if relu:
        acc = acc.clamp_min(0)
    return acc.clamp(lo, hi)


@torch.no_grad()
def int_forward(layers, weights, m_in: int, specs: Specs, x: torch.Tensor,
                bits: int = 8, block: int = 16) -> torch.Tensor:
    """Float32 logits of the fixed-point forward of NCHW float32 images
    ``x`` at ``bits``, ``block`` images at a time; the result is on
    ``x``'s device."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    staged = []
    for l in layers:
        m_w, m_x, m_y = specs[l.name]
        if m_w + m_x - m_y < 0:
            raise ValueError(f"{l.name}: negative requant shift {specs[l.name]}")
        w, b = weights[l.name]
        staged.append((_quantize(w.to(x.device), m_w, lo, hi),
                       _quantize(b.to(x.device), m_w + m_x, INT32_MIN,
                                 INT32_MAX)))
    out = []
    for i in range(0, x.shape[0], block):
        h = _quantize(x[i:i + block], m_in, lo, hi)
        for l, (wq, bq) in zip(layers, staged):
            m_w, m_x, m_y = specs[l.name]
            if l.op == "conv":
                acc = F.conv2d(h, wq, stride=l.stride, padding=l.pad)
                acc = torch.round(acc) + bq[:, None, None]
            else:
                acc = torch.round(h.flatten(1) @ wq) + bq
            h = _requant(acc, m_w + m_x - m_y, l.relu, lo, hi)
            if l.pool:
                h = F.max_pool2d(h, l.pool[0], l.pool[1])
        out.append(h.float() * 2.0 ** -specs[layers[-1].name][2])
    return torch.cat(out)

"""Operations, bytes and bounds of every conv and FC call, from the
configuration's shapes, and the H100's published peaks.

A call's bound is the least time the card could take for it: the larger
of its int8 operations over the int8 peak and its bytes over the HBM
bandwidth.  Each input and output byte is counted once, whatever the
kernel reads again: the int8 input activation, the int8 weight, the
int32 bias and the int8 output after the fused pool.
"""
from __future__ import annotations

from typing import Dict, List

#: NVIDIA H100 SXM5 80 GB data sheet, dense rates at the 700 W limit
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def ops(layer, batch: int = 1) -> int:
    """int8 operations of one call: two per multiply-accumulate."""
    return 2 * layer.macs * batch


def weight_bytes(layer) -> int:
    n = 1
    for d in layer.weight_shape:
        n *= d
    return n


def call_bytes(layer, batch: int = 1) -> int:
    """Bytes one call must move at least once: its int8 input, int8
    weight, int32 bias and int8 output."""
    def size(shape):
        n = 1
        for d in shape:
            n *= d
        return n
    return (batch * size(layer.in_shape) + weight_bytes(layer)
            + 4 * layer.out + batch * size(layer.out_shape))


def bound_s(layer, batch: int = 1) -> float:
    """The call's least time on the card, in seconds."""
    return max(ops(layer, batch) / INT8_OPS_PER_S,
               call_bytes(layer, batch) / HBM_BYTES_PER_S)


def forward_counts(layers: List, batch: int) -> Dict[str, float]:
    """Per forward of ``batch`` images: int8 operations, and the summed
    bounds of the conv calls and of the FC calls (seconds)."""
    return {
        "ops": sum(ops(l, batch) for l in layers),
        "conv_bound_s": sum(bound_s(l, batch) for l in layers
                            if l.op == "conv"),
        "fc_bound_s": sum(bound_s(l, batch) for l in layers
                          if l.op == "fc"),
    }

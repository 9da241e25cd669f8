"""The standalone int8 NHWC max-pool kernel.

:func:`maxpool2d` launches ``csrc/pool.cu``'s ``maxpool_nhwc_kernel`` on
a CUDA tensor and runs the plain version :func:`ref.maxpool2d_ref` (a
padded copy at INT8_MIN, then an amax over the windows) on a CPU tensor;
on the card it launches the kernel or raises.  It replaces no Pallas
kernel: the JAX package's standalone pools were plain array ops.  Bound
by bytes on the H100 (the input read once, the output written once;
ResNet-18's padded 3x3/2 pool at batch 512 moves 514 MB, 0.153 ms), the
kernel makes one pass with no padded copy: a thread owns an output pixel
and a chunk of its channels and skips the taps that fall outside the
unpadded input (see the note at the top of the source).  The chunk is as
wide as the input allows (:func:`chunk_width`), the rule-by-shape that
the conv kernel's gathers follow.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, ref

#: Launches of the max-pool kernel (plain-version calls are not counted).
launches = {"maxpool2d": 0}

_SIGNATURES = {"maxpool_s8": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 11
               + [ctypes.c_void_p]}


def chunk_width(c: int, *addresses: int) -> int:
    """Bytes of channels a kernel thread takes: 16 where ``c`` and every
    address are multiples of 16, else 4 where they are multiples of 4,
    else 1."""
    for width in (16, 4):
        if c % width == 0 and all(a % width == 0 for a in addresses):
            return width
    return 1


def maxpool2d(x: torch.Tensor, window: int, stride: int,
              pads: Tuple[int, int, int, int] = (0, 0, 0, 0)
              ) -> torch.Tensor:
    """Int8 NHWC max-pool over ``window`` x ``window`` windows at
    ``stride``; ``pads`` (top, left, bottom, right) take INT8_MIN.
    Returns (N, OH, OW, C) int8.  Raises ``TypeError`` for a tensor that
    is not int8 and ``ValueError`` for one that is not 4-D or a window
    that does not fit, on every device; a CUDA tensor that is not
    contiguous (an NCHW view) is copied contiguous first."""
    if x.dtype != torch.int8:
        raise TypeError(f"maxpool2d takes an int8 tensor, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"maxpool2d takes an NHWC tensor, got shape "
                         f"{tuple(x.shape)}")
    pads = tuple(int(p) for p in pads)
    window, stride = int(window), int(stride)
    n, h, w, c = x.shape
    fits = len(pads) == 4 and min(pads) >= 0 and window >= 1 and stride >= 1
    oh, ow = (ref.out_hw(h, w, window, window, (stride, stride), pads)
              if fits else (0, 0))
    if oh < 1 or ow < 1:
        raise ValueError(f"maxpool2d: window {window} stride {stride} pads "
                         f"{pads} over {h}x{w}")
    if x.device.type == "cpu":
        return ref.maxpool2d_ref(x, window, stride, pads)
    if max(h * w, oh * ow) * c >= 2 ** 31:
        raise ValueError(f"maxpool2d: {h}x{w}x{c} in, {oh}x{ow}x{c} out: an "
                         "image of 2^31 bytes; the kernel indexes one with "
                         "32 bits")
    if x.device.type != "cuda":
        raise ValueError(f"maxpool2d runs on CUDA or the CPU, not {x.device}")
    x = x.contiguous()
    out = torch.empty((n, oh, ow, c), dtype=torch.int8, device=x.device)
    width = chunk_width(c, x.data_ptr(), out.data_ptr())
    lib = _build.load("pool", _SIGNATURES)
    _build.check(lib.maxpool_s8(_build.ptr(x), _build.ptr(out), n, h, w, c,
                                window, stride, pads[0], pads[1], oh, ow,
                                width, _build.stream(x.device)),
                 "maxpool2d")
    launches["maxpool2d"] += 1
    return out

"""int8 GEMM + bias + requantize: the FC stage kernel.

``qgemm`` launches the hand-written CUDA kernel ``csrc/qgemm.cu`` on a
CUDA tensor and runs the plain version :func:`qgemm_plain` on a CPU
tensor.  It replaces the Pallas kernel
``src/repro/kernels/qgemm.py:qgemm``.  On the H100 the kernel is bound
by reading the weights once (small batches reuse each weight byte only
M times); it splits K across blocks so the read spreads over every SM
(see the note at the top of the source).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build, ref

#: K values of one split: the smallest slice a block is given.
MIN_K_CHUNK = 64
#: Blocks per SM the split-K heuristic aims for.
BLOCKS_PER_SM = 4
_BLOCK_N = 1024
#: Launches of the kernel (plain-version calls are not counted).
launches = {"qgemm": 0}

_SIGNATURES = {"qgemm_s8": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
               + [ctypes.c_void_p]}


def qgemm_plain(x, w, b=None, *, shift, relu: bool = False,
                shift_vec: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's semantics in plain PyTorch (any device); the staged
    ``shift_vec`` is not read: ``shift`` says the same."""
    return ref.qgemm_ref(x, w, b, shift, relu)


def shift_args(shift, n: int, device, staged: Optional[torch.Tensor] = None
               ) -> Tuple[int, Optional[torch.Tensor]]:
    """(scalar, per-lane vector or None) shift arguments of a launch.
    ``shift`` is an int or a length-``n`` sequence of ints; every count
    must lie in [0, 31], the range the kernels' round-half-up add
    supports.  ``staged`` is the per-lane vector already on ``device``
    (:func:`stage_shift` of the same ``shift``, made once at build time):
    it is used as it is, and no copy is made for the launch."""
    if staged is not None:
        if not isinstance(shift, (tuple, list)):
            raise ValueError("a staged shift vector needs per-lane shifts")
        if staged.dtype != torch.int32 or tuple(staged.shape) != (n,) \
                or staged.device != torch.device(device) \
                or not staged.is_contiguous():
            raise ValueError(f"staged shifts must be ({n},) int32 on "
                             f"{device}, got {tuple(staged.shape)} "
                             f"{staged.dtype} on {staged.device}")
        if len(shift) != n:
            raise ValueError(f"{len(shift)} per-lane shifts for {n} lanes")
        return 0, staged
    if isinstance(shift, (tuple, list)):
        lanes = [int(s) for s in shift]
        if len(lanes) != n:
            raise ValueError(f"{len(lanes)} per-lane shifts for {n} lanes")
        if min(lanes) < 0 or max(lanes) > 31:
            raise ValueError(f"per-lane shifts must lie in [0, 31], got "
                             f"[{min(lanes)}, {max(lanes)}]")
        return 0, torch.tensor(lanes, dtype=torch.int32, device=device)
    s = int(shift)
    if not 0 <= s <= 31:
        raise ValueError(f"shift must lie in [0, 31], got {s}")
    return s, None


def stage_shift(shift, n: int, device) -> Optional[torch.Tensor]:
    """The int32 per-lane shift vector of ``shift`` on ``device`` (checked
    as :func:`shift_args` checks it), or None for a scalar shift: what a
    layer stages once so that its launches pass ``shift_vec``."""
    return shift_args(shift, n, device)[1]


def _block_m(m: int) -> int:
    """Rows of y one block owns: one of the kernel's instances 1, 2, 4, 8."""
    return 8 if m >= 5 else 4 if m >= 3 else m


def _splits(m: int, n: int, k: int, bm: int, device) -> tuple:
    """(splits, k_chunk): enough K slices that the grid fills the card."""
    tiles = math.ceil(n / _BLOCK_N) * math.ceil(m / bm)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(math.ceil(BLOCKS_PER_SM * sms / tiles),
                        math.ceil(k / MIN_K_CHUNK)))
    chunk = 4 * math.ceil(math.ceil(k / splits) / 4)
    return math.ceil(k / chunk), chunk


def qgemm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          *, shift, relu: bool = False,
          shift_vec: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``requant(x @ w + b)``: x (M, K) int8, w (K, N) int8, b (N,) int32
    or None; ``shift`` an int or a length-N sequence of per-column
    shifts, ``shift_vec`` the latter staged on the card
    (:func:`stage_shift`).  Returns (M, N) int8.  On a CPU tensor this is
    the plain version; on a CUDA tensor it launches the kernel or
    raises."""
    if x.device.type == "cpu":
        return qgemm_plain(x, w, b, shift=shift, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"qgemm runs on CUDA or the CPU, not {x.device}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"qgemm takes int8 operands, got {x.dtype}, {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0] \
            or x.shape[1] == 0:
        raise ValueError(f"qgemm shapes {tuple(x.shape)} x {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    for name, t in (("w", w), ("b", b)):
        if t is not None and t.device != x.device:
            raise ValueError(f"qgemm: {name} on {t.device}, x on {x.device}")
    if b is not None and (b.dtype != torch.int32 or b.shape != (n,)):
        raise ValueError(f"qgemm bias must be ({n},) int32, got "
                         f"{tuple(b.shape)} {b.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()
            and (b is None or b.is_contiguous())):
        raise ValueError("qgemm takes contiguous tensors")
    s, svec = shift_args(shift, n, x.device, shift_vec)
    y = torch.empty((m, n), dtype=torch.int8, device=x.device)
    if m == 0 or n == 0:
        return y
    bm = _block_m(m)
    splits, chunk = _splits(m, n, k, bm, x.device)
    partial = (torch.zeros((m, n), dtype=torch.int32, device=x.device)
               if splits > 1 else None)
    vec = int(n % 4 == 0 and w.data_ptr() % 4 == 0)
    lib = _build.load("qgemm", _SIGNATURES)
    p = _build.ptr
    err = lib.qgemm_s8(p(x), p(w), p(b), p(svec), p(y), p(partial), m, n, k,
                       bm, chunk, splits, s, int(relu), vec,
                       _build.stream(x.device))
    _build.check(err, "qgemm")
    launches["qgemm"] += 1
    return y

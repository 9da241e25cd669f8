"""int8 GEMM + bias + requant: the FC stage kernel.

``qgemm`` launches the hand-written CUDA kernel ``csrc/qgemm.cu`` on a
CUDA tensor and runs the plain version :func:`qgemm_plain` on a CPU
tensor.  It replaces the Pallas kernel
``src/repro/kernels/qgemm.py:qgemm``.  On the H100 the kernel is bound
by reading the weights once (small batches reuse each weight byte only
M times): swap-AB ``wgmma`` s8 with the weight staged K-major
(:func:`stage_kmajor`, once per layer as ``QuantizedLayer.w_k``) and fed
by TMA through a ring of stages, K split over the blocks of a
thread-block cluster so that one wave fills the card (:func:`plan`), and
the split sums reduced through distributed shared memory and
requantized in the same launch: one launch per call (see the note at the
top of the source).

``qgemm_trials`` is the trial form, what the JAX package's ``qgemm``
becomes under ``jax.vmap`` in an SER campaign
(``src/repro/core/ser.py:315``): T trials' rows of x, each against its
own weight image (T, K, N), in one launch of the same kernel (its plan
from :func:`plan` with ``trials``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, ref

#: K bytes of one wgmma step: one 128-byte swizzle row of each operand;
#: K-major weights are zero-padded to a multiple of it.
K_TILE = 128
#: Streaming multiprocessors a plan fills when it cannot ask the card
#: (the H100 SXM's count).
H100_SMS = 132
#: The most K splits of one tile: the splits of a tile run as one
#: thread-block cluster, and 8 is the portable cluster size.
MAX_SPLITS = 8
#: Launches of the kernel (plain-version calls are not counted).
launches = {"qgemm": 0, "qgemm_trials": 0}

_SIGNATURES = {"qgemm_s8": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
               + [ctypes.c_void_p]}


def k_padded(k: int) -> int:
    """K rounded up to the wgmma kernels' K tile."""
    return K_TILE * math.ceil(k / K_TILE)


def stage_kmajor(w: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 -> the kernels' K-major (N, K_pad) int8: row n holds
    column n of ``w``, zero-padded from K to :func:`k_padded` (every row
    a multiple of 16 bytes, as TMA needs; the padding adds 0 to every
    sum).  Made once per layer.  Leading axes stay: a trials' stack
    (T, K, N) becomes (T, N, K_pad)."""
    k, n = w.shape[-2:]
    wk = torch.zeros(tuple(w.shape[:-2]) + (n, k_padded(k)),
                     dtype=torch.int8, device=w.device)
    wk[..., :k] = w.transpose(-1, -2)
    return wk


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one GEMM call runs: its tiles and its K split."""

    bn: int          # output columns a tile (one warpgroup per 64)
    nw: int          # rows of x a tile: the wgmma N, 8, 16 or 32
    m_tiles: int
    n_tiles: int
    k_tiles: int     # K_TILE steps of the padded K
    splits: int      # K splits a tile (one cluster)
    chunk: int       # K tiles a split (the last may hold fewer)

    @property
    def k_pad(self) -> int:
        return self.k_tiles * K_TILE

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def split_ranges(self):
        """The K tiles [start, stop) of each split, in order."""
        return [(s * self.chunk, min((s + 1) * self.chunk, self.k_tiles))
                for s in range(self.splits)]


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, sms: int = H100_SMS,
         trials: int = 1) -> Plan:
    """The tiles and K split of an (M, K) x (K, N) call, from its shapes
    and the card's SM count alone.  NW is the smallest wgmma N of 8, 16
    and 32 that holds M (32 and M tiles past it).  For a tile of 128 and
    of 64 columns, each tile's K tiles are split over
    ``min(sms // tiles, MAX_SPLITS)`` blocks at most (the smallest chunk
    that keeps the grid within one wave, and as few splits as that chunk
    needs); the 64-column tile is taken where it puts more blocks on the
    card within one wave.  With ``trials``, each of that many trials has
    its own M rows and weight image: its own M tiles."""
    nw = 8 if m <= 8 else 16 if m <= 16 else 32
    m_tiles = trials * math.ceil(m / nw)
    k_tiles = k_padded(k) // K_TILE

    def tiled(bn: int) -> Plan:
        n_tiles = math.ceil(n / bn)
        most = max(1, min(MAX_SPLITS, sms // (n_tiles * m_tiles)))
        chunk = math.ceil(k_tiles / most)
        return Plan(bn, nw, m_tiles, n_tiles, k_tiles,
                    math.ceil(k_tiles / chunk), chunk)

    wide, narrow = tiled(128), tiled(64)
    return narrow if wide.blocks < narrow.blocks <= sms else wide


@functools.lru_cache(maxsize=None)
def sms_of(index: Optional[int]) -> int:
    """SMs of CUDA card ``index``; the H100's count for no card."""
    if index is None:
        return H100_SMS
    return torch.cuda.get_device_properties(index).multi_processor_count


def qgemm_plain(x, w, b=None, *, shift, relu: bool = False,
                shift_vec: Optional[torch.Tensor] = None,
                w_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's semantics in plain PyTorch (any device); the staged
    ``shift_vec`` and ``w_k`` are not read: ``shift`` and ``w`` say the
    same."""
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


def qgemm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          *, shift, relu: bool = False,
          shift_vec: Optional[torch.Tensor] = None,
          w_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``requant(x @ w + b)``: x (M, K) int8, w (K, N) int8, b (N,) int32
    or None; ``shift`` an int or a length-N sequence of per-column
    shifts, ``shift_vec`` the latter staged on the card
    (:func:`stage_shift`), ``w_k`` ``w`` staged K-major
    (:func:`stage_kmajor`; made here when none is given).  Returns
    (M, N) int8.  On a CPU tensor this is the plain version (the staged
    copies unused); on a CUDA tensor it launches the kernel or raises."""
    if x.device.type == "cpu":
        return qgemm_plain(x, w, b, shift=shift, relu=relu)
    return _launch(x, w, b, shift, relu, shift_vec, w_k, trial_form=False)


def qgemm_trials(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *, shift,
                 relu: bool = False,
                 shift_vec: Optional[torch.Tensor] = None,
                 w_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The trial form of :func:`qgemm`: x (T*M, K) int8 holds T trials'
    M rows each, w (T, K, N) int8 one weight image a trial (``w_k`` the
    stack staged K-major, (T, N, K_pad)); the bias and shifts are the
    trials' own shared ones.  Returns (T*M, N) int8, trial t's rows
    ``x[t*M:(t+1)*M] @ w[t]``, in one launch.  On a CPU tensor this is
    the plain version :func:`ref.qgemm_trials_ref`; on a CUDA tensor it
    launches the kernel or raises."""
    if x.device.type == "cpu":
        return ref.qgemm_trials_ref(x, w, b, shift=shift, relu=relu)
    return _launch(x, w, b, shift, relu, shift_vec, w_k, trial_form=True)


def _launch(x, w, b, shift, relu, shift_vec, w_k, *,
            trial_form: bool) -> torch.Tensor:
    """Check the operands of a launch of the kernel, single (``w`` of
    (K, N)) or, with ``trial_form``, the trial form (``w`` of (T, K,
    N)), and launch it; count it under ``qgemm`` or ``qgemm_trials``."""
    what = "qgemm_trials" if trial_form else "qgemm"
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {x.device}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{what} takes int8 operands, got {x.dtype}, "
                        f"{w.dtype}")
    trials = w.shape[0] if trial_form and w.ndim == 3 else 1
    if x.ndim != 2 or w.ndim != 2 + trial_form \
            or x.shape[1] != w.shape[-2] or x.shape[1] == 0 or trials < 1 \
            or x.shape[0] % trials:
        raise ValueError(f"{what} shapes {tuple(x.shape)} x {tuple(w.shape)}")
    m, k = x.shape[0] // trials, x.shape[1]
    n = w.shape[-1]
    for name, t in (("w", w), ("b", b), ("w_k", w_k)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
    if b is not None and (b.dtype != torch.int32 or b.shape != (n,)):
        raise ValueError(f"{what} bias must be ({n},) int32, got "
                         f"{tuple(b.shape)} {b.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()
            and (b is None or b.is_contiguous())):
        raise ValueError(f"{what} takes contiguous tensors")
    staged = ((trials,) if trial_form else ()) + (n, k_padded(k))
    if w_k is not None and (w_k.dtype != torch.int8
                            or tuple(w_k.shape) != staged
                            or not w_k.is_contiguous()):
        raise ValueError(f"{what}: staged weight must be contiguous int8 "
                         f"{staged}, got {w_k.dtype} {tuple(w_k.shape)}")
    s, svec = shift_args(shift, n, x.device, shift_vec)
    y = torch.empty((trials * m, n), dtype=torch.int8, device=x.device)
    if m == 0 or n == 0:
        return y
    pl = plan(m, n, k, sms_of(x.device.index), trials)
    if w_k is None:
        w_k = stage_kmajor(w)
    if w_k.data_ptr() % 16:      # TMA reads 16-byte aligned rows
        w_k = w_k.clone()
    kx = 16 * math.ceil(k / 16)
    if kx != k:                  # TMA needs rows of x a multiple of 16 bytes
        x = F.pad(x, (0, kx - k))
    elif x.data_ptr() % 16:
        x = x.clone()
    lib = _build.load("qgemm", _SIGNATURES)
    p = _build.ptr
    err = lib.qgemm_s8(p(x), p(w_k), p(b), p(svec), p(y), m, n, kx,
                       pl.k_pad, pl.bn, pl.nw, pl.splits, pl.chunk, s,
                       int(relu), trials, _build.stream(x.device))
    _build.check(err, what)
    launches[what] += 1
    return y

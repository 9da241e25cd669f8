"""Fused int8 conv + requant + ReLU (+ skip, concat, max-pool) kernels.

Each wrapper launches its hand-written CUDA kernel on a CUDA tensor and
runs the plain version :func:`qconv2d_plain` on a CPU tensor:

* :func:`qconv2d` — dense conv, ``csrc/qconv.cu``; replaces the Pallas
  kernel ``src/repro/kernels/qconv.py:qconv2d`` (``pallas_call`` at
  ``:619``; ``_qconv_band_kernel`` + ``_band_epilogue``).  With
  ``out_buf`` it is :func:`qconv2d_into`, which replaces
  ``_qconv2d_into`` (``:453``).  Bound by operations on the H100: an
  implicit GEMM on the int8 tensor cores (``wgmma`` s8, 128-row tiles of
  (pooled pixel, window tap) pairs so that the fused max-pool sees whole
  windows, weights staged K-major and loaded by TMA, K split across the
  blocks of a thread-block cluster where the tile grid is under one
  wave; see the note at the top of the source).  :func:`plan` chooses
  the tile width and the split.  The im2col rows come in by 16- or
  4-byte ``cp.async`` where Cin/G is a multiple of 16 or 4, and
  otherwise (the Cin-3 stems, Cin 6, Cin/G 9, or an input pointer off a
  word) by the narrow gather: a thread owns a 16-byte chunk of every row
  it walks, works out its offsets once a K step without a division per
  byte, and loads bytes, so it takes any K_pad (no table bounds it).
  The conv's zero padding (``pads``, ONNX's top, left, bottom, right) is
  never stored: each gather reads a tap outside the unpadded input as
  zero, so a padded conv is one launch over the input as it is.  Such a
  stem is bound neither by operations nor by bytes but by its
  many small-K blocks' fixed cost and its byte loads (AlexNet's 11x11/4
  stem at batch 64: 0.227 ms on the H100, against a 0.0045 ms bound).
* :func:`qdwconv2d` — depthwise conv with channel multiplier m,
  ``csrc/qdwconv.cu``; replaces ``qdwconv2d`` and its ``out_buf`` branch.
  Bound by bytes, and at the main path's sizes by latency: a block
  stages its band of input rows (halo included) of a pre-padded input
  (its caller pads it, ``ops.qconv2d_nhwc``) in shared memory and
  computes runs of output pixels in 4-channel lanes; a fused pool
  reduces the band's conv values in shared memory.  :func:`dw_plan`
  chooses the band.
* :func:`qgconv2d` — ragged grouped conv, the dense kernel of
  ``csrc/qconv.cu`` with the group on ``gridDim.z``; replaces
  ``qgconv2d`` (``:945``).

The dense and grouped kernel takes its weight K-major, as
:func:`stage_kmajor` lays it out; a layer stages it once
(``core/pipeline.py:build_quantized``) and passes it as ``w_k``, and a
call without one gets one made for it.  Per-lane shifts may come staged
the same way (``shift_vec``, :func:`qgemm.stage_shift`).  What a launch
derives from its shapes alone (their checks, the plan, the kernel's
integer arguments) is worked out at the first call of each shape
(:func:`_geometry`), so that a layer's later calls only check their
tensors and launch.

All of them share one epilogue (``csrc/requant.cuh``), in the order
:func:`qconv2d_plain` spells out.

Each has a trial form, what the JAX package's kernel becomes under
``jax.vmap`` in an SER campaign (``src/repro/core/ser.py:315``):
:func:`qconv2d_trials` (with ``out_buf`` the into form),
:func:`qdwconv2d_trials` and :func:`qgconv2d_trials` take a weight with
a leading trial axis T and an input of T*N images, trial t's images
``[t*N, (t+1)*N)`` against its own weight image, in one launch of the
same kernel.  Their plain versions are the loops of ``kernels/ref.py``.

The functions at the end of the file, from :func:`band_geometry` to
:func:`gconv_vmem_bytes`, are the design-space exploration's row-band
working-set model (the paper's FPGA line buffers, the JAX package's
Pallas VMEM bands), copied from the JAX package for
``core/resources.py``; they do not describe the CUDA kernels, whose
shared memory :func:`plan`, :func:`dw_plan` and :func:`dw_smem` size.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build, qgemm, ref
from .qgemm import H100_SMS, K_TILE, MAX_SPLITS, k_padded, shift_args

INT8_MIN, INT8_MAX = ref.INT8_MIN, ref.INT8_MAX
#: The most taps of a fused pool window (8x8).
MAX_POOL_TAPS = 64
#: GEMM rows of one block: two warpgroups of 64.
TILE_M = 128
#: Shared memory a depthwise block may take (``csrc/qdwconv.cu``:
#: kMaxSmem).
DW_SMEM = 96 * 1024
#: Depthwise blocks (128 threads, a few KB of shared memory) an SM holds
#: at once, in the plan's count.
DW_BLOCKS_PER_SM = 8
#: Threads of a depthwise block, and output pixels a thread computes
#: along W (``csrc/qdwconv.cu``: kThreads, kRun).
DW_THREADS, DW_RUN = 128, 2

#: Launches of each wrapper's kernel (plain-version calls are not counted).
launches = {"qconv2d": 0, "qconv2d_into": 0, "qdwconv2d": 0,
            "qdwconv2d_into": 0, "qgconv2d": 0, "qconv2d_trials": 0,
            "qconv2d_into_trials": 0, "qdwconv2d_trials": 0,
            "qdwconv2d_into_trials": 0, "qgconv2d_trials": 0}
#: Launches of the dense and grouped kernel (``csrc/qconv.cu``) by the A
#: gather each took: 16- or 4-byte ``cp.async``, or the narrow gather
#: (Cin/G % 4 != 0, or an input pointer that is not 4-byte aligned).
gather_launches = {"16": 0, "4": 0, "narrow": 0}
#: Launches of the dense and grouped kernel that take non-zero pads in their
#: A gathers, by the gather, as :data:`gather_launches`.
padded_launches = {"16": 0, "4": 0, "narrow": 0}
#: Launches of each kernel (``csrc/qconv.cu``, ``csrc/qdwconv.cu``) that
#: carry a skip operand: a residual add in the epilogue.
skip_launches = {"qconv": 0, "qdwconv": 0}

_SIGNATURES = {
    "qconv": {"qconv_s8": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 33
              + [ctypes.c_void_p]},
    "qdwconv": {"qdwconv_s8": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 27
                + [ctypes.c_void_p]},
}


def qconv2d_plain(
    x: torch.Tensor,  # (N, H, W, Cin) int8
    w: torch.Tensor,  # (KH, KW, Cin/groups, Cout) int8
    b: Optional[torch.Tensor],  # (Cout,) int32
    *,
    strides: Tuple[int, int] = (1, 1),
    pads: Tuple[int, int, int, int] = (0, 0, 0, 0),  # top, left, bottom, right
    shift=0,
    relu: bool = True,
    pool: Optional[Tuple[int, int]] = None,
    groups: int = 1,
    skip: Optional[torch.Tensor] = None,
    skip_shifts: Tuple[int, int] = (0, 0),
    merge_shift: int = 0,
    merge_relu: bool = False,
    out_buf: Optional[torch.Tensor] = None,
    out_off: int = 0,
    concat_shift: int = 0,
    concat_relu: bool = False,
    w_k: Optional[torch.Tensor] = None,
    shift_vec: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernels' semantics in plain PyTorch (any device, any
    ``groups``), in the JAX package's ``_band_epilogue`` order: bias →
    requant → ReLU → clip; with a skip, align both operands → add →
    merge requant → merge ReLU → clip; with a concat, the operand's
    alignment and the merge's ReLU; max-pool last.  With ``out_buf`` the
    result is written into its channels ``[out_off, out_off + Cout)``
    in place and the whole buffer is returned.  ``x`` is zero-padded by
    ``pads`` first (``ref.pad_nhwc``).  It takes the wrappers' staged
    copies ``w_k`` and ``shift_vec`` and reads ``w`` and ``shift``
    instead."""
    y = epilogue_plain(ref.int_conv_nhwc(ref.pad_nhwc(x, pads), w, strides,
                                         groups), b,
                       shift=shift, relu=relu, skip=skip,
                       skip_shifts=skip_shifts, merge_shift=merge_shift,
                       merge_relu=merge_relu, concat_shift=concat_shift,
                       concat_relu=concat_relu)
    if pool is not None:
        y = ref.maxpool2d_ref(y, pool[0], pool[1])
    if out_buf is None:
        return y
    out_buf[..., out_off:out_off + y.shape[-1]] = y   # in place
    return out_buf


def epilogue_plain(acc: torch.Tensor, b: Optional[torch.Tensor], *, shift=0,
                   relu: bool = True, skip: Optional[torch.Tensor] = None,
                   skip_shifts: Tuple[int, int] = (0, 0),
                   merge_shift: int = 0, merge_relu: bool = False,
                   concat_shift: int = 0,
                   concat_relu: bool = False) -> torch.Tensor:
    """int32 conv sums (..., Cout) -> the int8 values before the pool, in
    :func:`qconv2d_plain`'s order (``csrc/requant.cuh:epilogue``)."""
    if b is not None:
        acc = acc + b.to(torch.int32)
    acc = ref.round_shift(acc, shift)
    if relu:
        acc = acc.clamp_min(0)
    acc = acc.clamp(INT8_MIN, INT8_MAX)
    if skip is not None:
        a_conv, a_skip = skip_shifts
        acc = (ref.round_shift(acc, a_conv)
               + ref.round_shift(skip.to(torch.int32), a_skip))
        acc = ref.round_shift(acc, merge_shift)
        if merge_relu:
            acc = acc.clamp_min(0)
        acc = acc.clamp(INT8_MIN, INT8_MAX)
    if concat_shift:
        acc = ref.round_shift(acc, concat_shift).clamp(INT8_MIN, INT8_MAX)
    if concat_relu:
        acc = acc.clamp_min(0)
    return acc.to(torch.int8)


def stage_kmajor(w: torch.Tensor) -> torch.Tensor:
    """HWIO (KH, KW, Cin/G, Cout) int8 -> the kernel's K-major
    (Cout, K_pad) int8: row c holds output channel c's weights in the
    contraction order (kh, kw, ci), zero-padded from K = KH*KW*Cin/G to
    :func:`k_padded` (:func:`qgemm.stage_kmajor` of the (K, Cout)
    matrix).  Made once per layer.  A trials' stack (T, KH, KW, Cin/G,
    Cout) becomes (T, Cout, K_pad)."""
    return qgemm.stage_kmajor(w.reshape(tuple(w.shape[:-4])
                                        + (-1, w.shape[-1])))


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one conv call runs: its tiles and its K split."""

    bn: int          # output channels a tile
    k: int           # contraction depth KH*KW*Cin/G
    k_pad: int       # K padded to the K tile
    m_tiles: int     # row tiles of (pooled pixel, tap) pairs
    n_tiles: int     # channel tiles a group
    groups: int
    splits: int      # K splits a tile
    chunk: int       # K tiles a split (the last may hold fewer)

    @property
    def k_tiles(self) -> int:
        return self.k_pad // K_TILE

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles * self.groups

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def split_ranges(self):
        """The K tiles [start, stop) of each split, in order."""
        return [(s * self.chunk, min((s + 1) * self.chunk, self.k_tiles))
                for s in range(self.splits)]


@functools.lru_cache(maxsize=4096)
def plan(n: int, hp: int, wp: int, cin: int, kh: int, kw: int, cout: int,
         strides: Tuple[int, int] = (1, 1),
         pool: Optional[Tuple[int, int]] = None, groups: int = 1,
         sms: int = H100_SMS, trials: int = 1) -> Plan:
    """The tiles and K split of a conv, from its shapes alone: 128-row
    tiles holding ``TILE_M // taps`` whole pool windows, 128 channels a
    tile where Cout/G >= 128, else 64.  Where the tiles do not fill
    ``sms`` blocks, each tile's K tiles are split over
    ``min(sms // tiles, MAX_SPLITS)`` blocks at most: the smallest chunk
    of K tiles a block that keeps the grid within one wave, and as few
    splits as that chunk needs.  With ``trials``, ``n`` is the images of
    one trial, and each trial has its own row tiles (a tile reads one
    trial's weight image)."""
    sh, sw = strides
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    pw, ps = pool if pool is not None else (1, 1)
    oh, ow = (ho - pw) // ps + 1, (wo - pw) // ps + 1
    cin_g, cout_g = cin // groups, cout // groups
    k = kh * kw * cin_g
    n_pooled = n * oh * ow
    bn = 128 if cout_g >= 128 else 64
    per_block = TILE_M // (pw * pw)
    m_tiles = trials * math.ceil(n_pooled / per_block)
    n_tiles = math.ceil(cout_g / bn)
    k_pad = k_padded(k)
    k_tiles = k_pad // K_TILE
    tiles = m_tiles * n_tiles * groups
    chunk = k_tiles
    if tiles < sms:
        chunk = math.ceil(k_tiles / min(sms // tiles, MAX_SPLITS))
    return Plan(bn, k, k_pad, m_tiles, n_tiles, groups,
                math.ceil(k_tiles / chunk), chunk)


def plan_of(x: torch.Tensor, w: torch.Tensor, strides, pool,
            groups: int) -> Plan:
    """:func:`plan` of a call, single or trial form (a weight with a
    leading trial axis), with the SM count of the card it runs on."""
    trials = w.shape[0] if w.ndim == 5 else 1
    kh, kw, _cin_g, cout = w.shape[-4:]
    return plan(x.shape[0] // trials, *x.shape[1:], kh, kw, cout,
                tuple(strides), None if pool is None else tuple(pool),
                groups, qgemm.sms_of(x.device.index
                                     if x.device.type == "cuda" else None),
                trials)


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """How one depthwise call runs: the band of the output a block owns
    (``csrc/qdwconv.cu``)."""

    rp: int          # output (pooled) rows a band
    cp: int          # output columns a band
    cb: int          # output channels a block, a multiple of 4
    row_bands: int
    col_bands: int
    groups: int      # channel groups
    smem: int        # shared-memory bytes a block

    @property
    def blocks_per_image(self) -> int:
        return self.row_bands * self.col_bands * self.groups


def _up16(v: int) -> int:
    return 16 * math.ceil(v / 16)


def dw_smem(rp: int, cp: int, cb: int, kh: int, kw: int,
            strides: Tuple[int, int], pool) -> int:
    """Shared memory of a depthwise block (``csrc/qdwconv.cu:qdwconv_s8``):
    the band's input rows and columns, halo included, at ``cb`` bytes a
    pixel; its filter taps; with a pool, its conv values."""
    sh, sw = strides
    pw, ps = pool if pool is not None else (1, 1)
    rc, wc = (rp - 1) * ps + pw, (cp - 1) * ps + pw
    return (_up16(((rc - 1) * sh + kh) * ((wc - 1) * sw + kw) * cb)
            + _up16(kh * kw * cb)
            + (rc * wc * cb if (pw, ps) != (1, 1) else 0))


@functools.lru_cache(maxsize=4096)
def dw_plan(n: int, hp: int, wp: int, cin: int, kh: int, kw: int, cout: int,
            strides: Tuple[int, int] = (1, 1),
            pool: Optional[Tuple[int, int]] = None, sms: int = H100_SMS,
            smem_cap: int = DW_SMEM) -> DwPlan:
    """The bands of a depthwise conv, from its shapes alone: 32 channels a
    block (fewer where Cout is smaller, in 4-channel lanes); whole output
    rows, as many a band as leave at least ``DW_BLOCKS_PER_SM`` blocks
    on each of ``sms`` SMs (one row until the batch is large: small
    blocks keep every SM busy and each block's path short); where that
    leaves fewer blocks than SMs, narrower column bands, halved until
    there are as many blocks as SMs or a block's work fits its threads
    once; then, while a block's shared memory passes ``smem_cap``, fewer
    rows, then narrower column bands, then fewer channels."""
    sh, sw = strides
    pw, ps = pool if pool is not None else (1, 1)
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    oh, ow = (ho - pw) // ps + 1, (wo - pw) // ps + 1
    cb = min(32, 4 * math.ceil(cout / 4))
    groups = math.ceil(cout / cb)
    rp = min(oh, max(1, n * oh * groups // (DW_BLOCKS_PER_SM * sms)))
    cp = ow

    def blocks(cp):
        return n * math.ceil(oh / rp) * math.ceil(ow / cp) * groups

    def items(cp):   # (conv row, run, 4 channels) work items of a block
        rc, wc = (rp - 1) * ps + pw, (cp - 1) * ps + pw
        return rc * math.ceil(wc / DW_RUN) * (cb // 4)

    while cp > 1 and blocks(cp) < sms and items(cp) > DW_THREADS:
        cp = math.ceil(cp / 2)
    while dw_smem(rp, cp, cb, kh, kw, strides, pool) > smem_cap:
        if rp > 1:
            rp //= 2
        elif cp > 1:
            cp = math.ceil(cp / 2)
        elif cb > 4:
            cb = max(4, 4 * (cb // 8))
        else:
            raise ValueError(f"qdwconv2d: a {kh}x{kw} window with pool "
                             f"{pool} needs more than {smem_cap} bytes of "
                             "shared memory for one output pixel")
    return DwPlan(rp, cp, cb, math.ceil(oh / rp), math.ceil(ow / cp),
                  math.ceil(cout / cb),
                  dw_smem(rp, cp, cb, kh, kw, strides, pool))


def qdwconv2d_plain(x, w, b, **kw) -> torch.Tensor:
    """:func:`qdwconv2d`'s semantics in plain PyTorch: the grouped conv
    with one group per input channel."""
    return qconv2d_plain(x, w, b, groups=x.shape[-1], **kw)


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """What a launch derives from its shapes and integer options alone."""

    head: tuple      # n, h, w, cin, kh, kw, cout, sh, sw, pw, ps
    tail: tuple      # c_tot, out_off
    pads: tuple      # top, left, bottom, right: zeros the gathers take
    trials: int      # weight images (1: the single form)
    plan: object     # Plan, or the depthwise kernel's DwPlan
    width: int       # widest input load the channels allow: 16, 4 or 1
    store: int       # output store width: 16 (dense), 4 (depthwise)
    wide: bool       # c_tot and out_off allow stores of that width


@functools.lru_cache(maxsize=4096)
def _geometry(kernel: str, what: str, xs, ws, outs, groups: int, strides,
              pool, out_off: int, b_shape, skip_shape, options,
              device_index: Optional[int],
              trial_form: bool = False,
              pads: Tuple[int, int, int, int] = (0, 0, 0, 0)) -> _Geometry:
    """Check the shapes and integer ``options`` (a_conv, a_skip,
    merge_shift, concat_shift) of a launch of ``kernel`` and plan it;
    worked out once for each distinct call and kept.  The trial form's
    weight carries a leading trial axis that divides the batch.  ``xs``
    is the unpadded input and ``pads`` the zeros around it (dense and
    grouped kernel only: the depthwise kernel takes a pre-padded input)."""
    trials = 1
    if trial_form:
        if len(ws) != 5 or ws[0] < 1 or len(xs) != 4 or xs[0] % ws[0]:
            raise ValueError(f"{what}: NHWC input of T*N images and a (T, "
                             f"KH, KW, Cin/G, Cout) weight stack, got "
                             f"{tuple(xs)} and {tuple(ws)}")
        trials, ws = ws[0], ws[1:]
    if len(xs) != 4 or len(ws) != 4:
        raise ValueError(f"{what}: NHWC input and HWIO weight, got "
                         f"{tuple(xs)} and {tuple(ws)}")
    n, h, w, cin = xs
    kh, kw, cin_g, cout = ws
    if len(pads) != 4 or min(pads) < 0 \
            or (kernel == "qdwconv" and any(pads)):
        raise ValueError(f"{what}: pads {tuple(pads)}")
    hp, wp = h + pads[0] + pads[2], w + pads[1] + pads[3]
    if kernel == "qdwconv":
        if cin_g != 1 or cin == 0 or cout % cin:
            raise ValueError(f"{what}: depthwise weight must be HWIO "
                             f"(KH, KW, 1, m*{cin}), got {tuple(ws)}")
    elif groups < 1 or cin % groups or cout % groups \
            or cin_g * groups != cin:
        raise ValueError(f"{what}: {groups} groups over input "
                         f"{tuple(xs)} and HWIO {tuple(ws)}")
    sh, sw = strides
    if hp < kh or wp < kw or sh < 1 or sw < 1:
        raise ValueError(f"{what}: window {kh}x{kw} stride {strides} over "
                         f"padded input {hp}x{wp}")
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    if n * ho * wo >= 2 ** 31:
        raise ValueError(f"{what}: {n}x{ho}x{wo} output pixels; the kernels "
                         "index them with 32 bits")
    pw, ps = pool if pool is not None else (1, 1)
    if pw * pw > MAX_POOL_TAPS or ho < pw or wo < pw or ps < 1:
        raise ValueError(f"{what}: pool {pool} over conv output {ho}x{wo}")
    oh, ow = (ho - pw) // ps + 1, (wo - pw) // ps + 1
    c_tot = outs[-1]
    if tuple(outs[:3]) != (n, oh, ow) or out_off < 0 \
            or out_off + cout > c_tot:
        raise ValueError(f"{what}: output {tuple(outs)} cannot hold "
                         f"channels [{out_off}, {out_off + cout}) of "
                         f"({n}, {oh}, {ow}, ...)")
    if b_shape is not None and tuple(b_shape) != (cout,):
        raise ValueError(f"{what}: bias must be ({cout},) int32")
    if skip_shape is not None and tuple(skip_shape) != (n, ho, wo, cout):
        raise ValueError(f"{what}: skip must be int8 {(n, ho, wo, cout)}, "
                         f"got shape {tuple(skip_shape)}")
    for name, v in zip(("skip_shifts", "skip_shifts", "merge_shift",
                        "concat_shift"), options):
        if not 0 <= v <= 31:
            raise ValueError(f"{what}: {name} must lie in [0, 31], got {v}")
    pool = None if pool is None else (pw, ps)
    if kernel == "qconv":
        if ((kh + 1) * w + kw) * cin >= 2 ** 31:
            raise ValueError(f"{what}: {kh + 1} input rows of {w}x{cin} "
                             "bytes pass 2^31; the narrow gather's window "
                             "offsets take 32 bits")
        pl = plan(n // trials, hp, wp, cin, kh, kw, cout, (sh, sw), pool,
                  groups, qgemm.sms_of(device_index), trials)
        # the A gather: 16- or 4-byte cp.async, or 1, the narrow gather
        width = 16 if cin_g % 16 == 0 else 4 if cin_g % 4 == 0 else 1
        store = 16
    else:
        pl = dw_plan(n, hp, wp, cin, kh, kw, cout, (sh, sw), pool,
                     qgemm.sms_of(device_index))
        width = (1 if cout != cin else 16 if cin % 16 == 0
                 and pl.cb % 16 == 0 else 4 if cin % 4 == 0 else 1)
        store = 4
    return _Geometry((n, h, w, cin, kh, kw, cout, sh, sw, pw, ps),
                     (c_tot, out_off), tuple(pads), trials, pl, width, store,
                     c_tot % store == 0 and out_off % store == 0)


def _launch(kernel: str, x, w, b, out, *, groups, strides, shift, relu, pool,
            skip, skip_shifts, merge_shift, merge_relu, out_off, concat_shift,
            concat_relu, what: str, trials: bool, w_k=None,
            shift_vec=None, pads=(0, 0, 0, 0)) -> None:
    """Check the operands of a CUDA launch and run ``kernel`` (``"qconv"``,
    dense or grouped, or ``"qdwconv"``) into ``out`` (NHWC, channel stride
    ``out.shape[-1]``).  ``w_k`` is ``w`` staged K-major
    (:func:`stage_kmajor`; made here when none is given), ``shift_vec``
    the per-lane shifts staged on the card.  Every check comes before
    the device's, so a tensor on any device reports a bad operand
    first.  With ``trials`` (the trial form) ``w`` and ``w_k`` carry a
    leading trial axis.  ``pads`` (top, left, bottom, right) are the
    conv's zeros around the unpadded ``x``, which the gathers take."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{what} takes int8 operands, got {x.dtype}, {w.dtype}")
    dev = x.device
    options = tuple(int(v) for v in skip_shifts) + (int(merge_shift),
                                                    int(concat_shift))
    geo = _geometry(kernel, what, x.shape, w.shape, out.shape, groups,
                    tuple(strides), None if pool is None else tuple(pool),
                    int(out_off), None if b is None else b.shape,
                    None if skip is None else skip.shape, options,
                    dev.index if dev.type == "cuda" else None, trials,
                    tuple(int(p) for p in pads))
    if out.dtype != torch.int8:
        raise TypeError(f"{what}: output must be int8, got {out.dtype}")
    if b is not None and b.dtype != torch.int32:
        raise ValueError(f"{what}: bias must be ({w.shape[-1]},) int32")
    if skip is not None and skip.dtype != torch.int8:
        raise ValueError(f"{what}: skip must be int8, got {skip.dtype}")
    for t in (x, w, b, skip, out):
        if t is not None and t.device != dev:
            raise ValueError(f"{what}: operands on {t.device} and {dev}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
    cout = w.shape[-1]
    s, svec = shift_args(shift, cout, dev, shift_vec)
    pl = geo.plan
    staged = w_k is not None and tuple(w.shape[:-4]) + (cout, pl.k_pad)
    if w_k is not None and (w_k.dtype != torch.int8
                            or tuple(w_k.shape) != staged
                            or w_k.device != dev
                            or not w_k.is_contiguous()):
        raise ValueError(f"{what}: staged weight must be contiguous int8 "
                         f"{staged} on {dev}, got "
                         f"{w_k.dtype} {tuple(w_k.shape)} on {w_k.device}")
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {dev}")
    args = (*geo.head, s, int(relu), *options[:2], options[2],
            int(merge_relu), options[3], int(concat_relu), *geo.tail)
    lib = _build.load(kernel, _SIGNATURES[kernel])
    p = _build.ptr
    stream = _build.stream(dev)
    width, xp = geo.width, x.data_ptr()
    while xp % width:             # 16 -> 4 -> 1
        width //= 4
    wide = int(geo.wide and out.data_ptr() % geo.store == 0)
    if kernel == "qdwconv":
        err = lib.qdwconv_s8(p(x), p(w), p(b), p(svec), p(skip), p(out),
                             *args, pl.rp, pl.cp, pl.cb, width, wide,
                             geo.trials, stream)
    else:
        if w_k is None:
            w_k = stage_kmajor(w)
        if w_k.data_ptr() % 16:   # TMA reads 16-byte aligned rows
            w_k = w_k.clone()
        err = lib.qconv_s8(p(x), p(w_k), p(b), p(svec), p(skip), p(out),
                           *args, int(groups), pl.bn, pl.k_pad, pl.splits,
                           pl.chunk, width, wide, geo.trials, *geo.pads,
                           stream)
    _build.check(err, what)
    if kernel == "qconv":
        gather = "narrow" if width == 1 else str(width)
        gather_launches[gather] += 1
        if any(geo.pads):
            padded_launches[gather] += 1
    if skip is not None:
        skip_launches[kernel] += 1


def _out_hw(x, w, strides, pool, pads):
    """Output (pooled) height and width; 0 where the window does not fit,
    which :func:`_launch` then rejects."""
    ho = (x.shape[1] + pads[0] + pads[2] - w.shape[-4]) // strides[0] + 1
    wo = (x.shape[2] + pads[1] + pads[3] - w.shape[-3]) // strides[1] + 1
    if pool is not None:
        ho, wo = (ho - pool[0]) // pool[1] + 1, (wo - pool[0]) // pool[1] + 1
    return max(ho, 0), max(wo, 0)


def _run(kernel: str, what: str, x, w, b, *, groups: int,
         out_buf: Optional[torch.Tensor] = None, out_off: int = 0,
         trials: bool = False, **kw) -> torch.Tensor:
    """Launch ``kernel`` on a CUDA tensor into a new (N, OH, OW, Cout)
    output, or into channels ``[out_off, out_off + Cout)`` of ``out_buf``
    in place; count the launch under ``what`` (``what + "_trials"`` for
    the trial form)."""
    if trials:
        what += "_trials"
    if out_buf is None:
        oh, ow = _out_hw(x, w, kw["strides"], kw["pool"],
                         kw.get("pads", (0, 0, 0, 0)))
        out = torch.empty((x.shape[0], oh, ow, w.shape[-1]),
                          dtype=torch.int8, device=x.device)
    else:
        out = out_buf
    _launch(kernel, x, w, b, out, groups=groups, out_off=out_off, what=what,
            trials=trials, **kw)
    launches[what] += 1
    return out


def qconv2d(
    x: torch.Tensor,  # (N, H, W, Cin) int8, unpadded
    w: torch.Tensor,  # (KH, KW, Cin, Cout) int8
    b: Optional[torch.Tensor],  # (Cout,) int32
    *,
    strides: Tuple[int, int] = (1, 1),
    pads: Tuple[int, int, int, int] = (0, 0, 0, 0),  # top, left, bottom, right
    shift=0,         # int | length-Cout tuple (per-channel shift vector)
    relu: bool = True,
    pool: Optional[Tuple[int, int]] = None,
    skip: Optional[torch.Tensor] = None,  # (N, Ho, Wo, Cout) int8 residual
    skip_shifts: Tuple[int, int] = (0, 0),
    merge_shift: int = 0,
    merge_relu: bool = False,
    out_buf: Optional[torch.Tensor] = None,  # shared concat merge buffer
    out_off: int = 0,
    concat_shift: int = 0,
    concat_relu: bool = False,
    w_k: Optional[torch.Tensor] = None,  # w staged K-major (stage_kmajor)
    shift_vec: Optional[torch.Tensor] = None,  # per-lane shifts, staged
) -> torch.Tensor:
    """Dense fused int8 conv.  Returns (N, OH, OW, Cout) int8 (post-pool
    when ``pool`` is given); with ``out_buf`` the result lands in that
    buffer's channels ``[out_off, out_off + Cout)`` (see
    :func:`qconv2d_into`) and the buffer is returned.  ``skip`` is a
    residual operand in the *conv output* geometry (pre-pool).  ``pads``
    are the conv's zeros around ``x``: the kernel's gathers take them, and
    no padded copy is made.  On a CPU tensor this is the plain version
    (``w_k`` and ``shift_vec`` unused); on a CUDA tensor it launches the
    kernel or raises."""
    kw_ = dict(strides=strides, shift=shift, relu=relu, pool=pool, skip=skip,
               skip_shifts=skip_shifts, merge_shift=merge_shift,
               merge_relu=merge_relu, concat_shift=concat_shift,
               concat_relu=concat_relu)
    if out_buf is not None:
        return qconv2d_into(x, w, b, out_buf, out_off=out_off, pads=pads,
                            w_k=w_k, shift_vec=shift_vec, **kw_)
    if x.device.type == "cpu":
        return qconv2d_plain(x, w, b, pads=pads, **kw_)
    return _run("qconv", "qconv2d", x, w, b, groups=1, pads=pads, w_k=w_k,
                shift_vec=shift_vec, **kw_)


def qconv2d_into(x, w, b, out_buf: torch.Tensor, *, out_off: int,
                 pads: Tuple[int, int, int, int] = (0, 0, 0, 0),
                 w_k: Optional[torch.Tensor] = None,
                 shift_vec: Optional[torch.Tensor] = None,
                 **kw) -> torch.Tensor:
    """Concat-epilogue variant of :func:`qconv2d`: writes the conv's
    result, after this operand's ``concat_shift`` alignment and the
    merge's ``concat_relu``, into channels ``[out_off, out_off + Cout)``
    of the shared merge buffer ``out_buf`` (N, OH, OW, C_tot) **in
    place** and returns the buffer.  The other channels are never
    touched."""
    if x.device.type == "cpu":
        return qconv2d_plain(x, w, b, pads=pads, out_buf=out_buf,
                             out_off=out_off, **kw)
    return _run("qconv", "qconv2d_into", x, w, b, groups=1, out_buf=out_buf,
                out_off=out_off, pads=pads, w_k=w_k, shift_vec=shift_vec,
                **kw)


def qdwconv2d(
    x: torch.Tensor,  # (N, Hp, Wp, Cin) int8, pre-padded (VALID conv)
    w: torch.Tensor,  # (KH, KW, 1, Cout = m·Cin) int8
    b: Optional[torch.Tensor],  # (Cout,) int32
    *,
    strides: Tuple[int, int] = (1, 1),
    shift=0,         # int | length-Cout tuple (per-channel shift vector)
    relu: bool = True,
    pool: Optional[Tuple[int, int]] = None,
    skip: Optional[torch.Tensor] = None,  # (N, Ho, Wo, Cout) int8 residual
    skip_shifts: Tuple[int, int] = (0, 0),
    merge_shift: int = 0,
    merge_relu: bool = False,
    out_buf: Optional[torch.Tensor] = None,  # shared concat merge buffer
    out_off: int = 0,
    concat_shift: int = 0,
    concat_relu: bool = False,
    shift_vec: Optional[torch.Tensor] = None,  # per-lane shifts, staged
) -> torch.Tensor:
    """Depthwise fused int8 conv (group == Cin, Cout = m·Cin; output
    channel c convolves input channel c // m) with the same epilogues as
    :func:`qconv2d`.  With ``out_buf`` its result lands in that buffer's
    channels ``[out_off, out_off + Cout)`` in place (counted as
    ``qdwconv2d_into``).  On a CPU tensor this is the plain version; on a
    CUDA tensor it launches the kernel or raises."""
    kw_ = dict(strides=strides, shift=shift, relu=relu, pool=pool, skip=skip,
               skip_shifts=skip_shifts, merge_shift=merge_shift,
               merge_relu=merge_relu, out_buf=out_buf, out_off=out_off,
               concat_shift=concat_shift, concat_relu=concat_relu)
    if x.device.type == "cpu":
        return qdwconv2d_plain(x, w, b, **kw_)
    what = "qdwconv2d" if out_buf is None else "qdwconv2d_into"
    return _run("qdwconv", what, x, w, b, groups=x.shape[-1],
                shift_vec=shift_vec, **kw_)


def qgconv2d(x, w, b, *, groups: int, strides=(1, 1), pads=(0, 0, 0, 0),
             shift=0, relu=True, pool=None,
             w_k: Optional[torch.Tensor] = None,
             shift_vec: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ragged grouped int8 conv (1 < groups < Cin; HWIO weight
    (KH, KW, Cin/groups, Cout)) with requant, ReLU and the fused
    max-pool, over ``x`` zero-padded by ``pads`` as :func:`qconv2d`; it
    never takes a skip or a concat buffer.  On a CPU tensor this is the
    plain version; on a CUDA tensor it launches the dense kernel, every
    group at once, or raises."""
    kw_ = dict(strides=strides, shift=shift, relu=relu, pool=pool)
    if x.device.type == "cpu":
        return qconv2d_plain(x, w, b, groups=groups, pads=pads, **kw_)
    return _run("qconv", "qgconv2d", x, w, b, groups=groups, pads=pads,
                skip=None,
                skip_shifts=(0, 0), merge_shift=0, merge_relu=False,
                concat_shift=0, concat_relu=False, w_k=w_k,
                shift_vec=shift_vec, **kw_)


def qconv2d_trials(x, w, b, *, out_buf: Optional[torch.Tensor] = None,
                   out_off: int = 0, pads=(0, 0, 0, 0),
                   w_k: Optional[torch.Tensor] = None,
                   shift_vec: Optional[torch.Tensor] = None,
                   **kw) -> torch.Tensor:
    """The trial form of :func:`qconv2d` (and, with ``out_buf``, of
    :func:`qconv2d_into`): x (T*N, H, W, Cin) holds T trials' N images
    each, zero-padded by ``pads``, w (T, KH, KW, Cin, Cout) one weight
    image a trial (``w_k`` the stack staged K-major, (T, Cout, K_pad));
    bias, shifts and every epilogue option are shared, a skip or
    ``out_buf`` has T*N images.  Trial t's images ``[t*N, (t+1)*N)`` come out as :func:`qconv2d` of
    them with ``w[t]``, from one launch.  On a CPU tensor this is the
    plain version :func:`ref.qconv2d_trials_ref`; on a CUDA tensor it
    launches the kernel or raises."""
    if x.device.type == "cpu":
        return ref.qconv2d_trials_ref(x, w, b, pads=pads, out_buf=out_buf,
                                      out_off=out_off, **kw)
    what = "qconv2d" if out_buf is None else "qconv2d_into"
    return _run("qconv", what, x, w, b, groups=1, out_buf=out_buf,
                out_off=out_off, trials=True, pads=pads, w_k=w_k,
                shift_vec=shift_vec, **_merge(kw))


def qdwconv2d_trials(x, w, b, *, out_buf: Optional[torch.Tensor] = None,
                     out_off: int = 0,
                     shift_vec: Optional[torch.Tensor] = None,
                     **kw) -> torch.Tensor:
    """The trial form of :func:`qdwconv2d` (its ``out_buf`` form counted
    as ``qdwconv2d_into_trials``): w (T, KH, KW, 1, Cout) one filter
    image a trial, x of T*N images, trial t's images against ``w[t]``,
    from one launch.  On a CPU tensor this is the plain version
    :func:`ref.qdwconv2d_trials_ref`; on a CUDA tensor it launches the
    kernel or raises."""
    if x.device.type == "cpu":
        return ref.qdwconv2d_trials_ref(x, w, b, out_buf=out_buf,
                                        out_off=out_off, **kw)
    what = "qdwconv2d" if out_buf is None else "qdwconv2d_into"
    return _run("qdwconv", what, x, w, b, groups=x.shape[-1],
                out_buf=out_buf, out_off=out_off, trials=True,
                shift_vec=shift_vec, **_merge(kw))


def qgconv2d_trials(x, w, b, *, groups: int, strides=(1, 1),
                    pads=(0, 0, 0, 0), shift=0, relu=True, pool=None,
                    w_k: Optional[torch.Tensor] = None,
                    shift_vec: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The trial form of :func:`qgconv2d`: w (T, KH, KW, Cin/groups,
    Cout) one weight image a trial (``w_k`` staged K-major, (T, Cout,
    K_pad)), x of T*N images zero-padded by ``pads``, from one launch.
    On a CPU tensor this is the plain version :func:`ref.qconv2d_trials_ref`
    with ``groups``; on a CUDA tensor it launches the kernel or raises."""
    kw_ = dict(strides=strides, shift=shift, relu=relu, pool=pool)
    if x.device.type == "cpu":
        return ref.qconv2d_trials_ref(x, w, b, groups=groups, pads=pads,
                                      **kw_)
    return _run("qconv", "qgconv2d", x, w, b, groups=groups, trials=True,
                pads=pads, w_k=w_k, shift_vec=shift_vec, **_merge(kw_))


def _merge(kw: dict) -> dict:
    """``kw`` with each epilogue option the caller left out at its
    default (no skip, no concat step), as :func:`_launch` takes them."""
    return dict(dict(strides=(1, 1), shift=0, relu=True, pool=None,
                     skip=None, skip_shifts=(0, 0), merge_shift=0,
                     merge_relu=False, concat_shift=0, concat_relu=False),
                **kw)


# ------------------------------------ the DSE's row-band working-set model
#
# The functions below are the JAX package's FPGA/Pallas row-band model,
# copied verbatim so that the port's design-space exploration
# (core/resources.py:conv_band_working_set) scores the paper's boards to
# the byte as the JAX package does.  They describe the line buffers of
# the paper's FPGA pipeline and the Pallas kernel's VMEM bands, NOT the
# CUDA kernels above: those size their shared memory with :func:`plan`,
# :func:`dw_plan` and :func:`dw_smem`.

def band_geometry(block_h: int, kh: int, sh: int,
                  pool: Optional[Tuple[int, int]]) -> Tuple[int, int, int]:
    """Row-band halo arithmetic of the DSE's resource model (the JAX
    package's Pallas band kernel and the paper's FPGA line buffers; not
    the CUDA kernels of this module).

    For a band of ``block_h`` *final* output rows (post-pool when a pool
    is fused) returns ``(conv_rows, in_rows, in_step)``:

      conv_rows — conv output rows the band must compute
                  (= ``(block_h-1)*ps + pw`` with a fused pool: the last
                  pool window carries ``pw-ps`` rows past the stride);
      in_rows   — input rows the band must read (conv halo ``kh-1``);
      in_step   — input-row distance between consecutive band starts
                  (< in_rows: the difference is the halo overlap).
    """
    if pool is not None:
        pw, ps = pool
        conv_rows = (block_h - 1) * ps + pw
        conv_step = block_h * ps
    else:
        conv_rows = block_h
        conv_step = block_h
    in_rows = (conv_rows - 1) * sh + kh
    in_step = conv_step * sh
    return conv_rows, in_rows, in_step


def default_block_h(oh: int, wo: int) -> int:
    """The JAX package's default row-band height (of the model above,
    not of the CUDA kernels): enough rows that each band's matmul has a
    healthy M dimension (targets >= ~1024 conv pixels per band, the MXU
    sweet spot) without approaching the whole-plane working set."""
    target_rows = max(1, -(-1024 // max(wo, 1)))
    return min(oh, target_rows, 32)


def band_input_bytes(hp: int, wp: int, cin: int, kh: int, ho: int, *,
                     sh: int = 1,
                     block_h: Optional[int] = None,
                     pool: Optional[Tuple[int, int]] = None,
                     block_cin: Optional[int] = None) -> int:
    """int8 bytes of the input halo band one grid step holds in VMEM —
    the term the Cin contraction tile bounds (``block_cin=None`` means
    the whole-Cin contraction: the band carries every input channel)."""
    bh = min(block_h or ho, ho)
    _conv_rows, band_in_rows, _step = band_geometry(bh, kh, sh, pool)
    band_in_rows = min(band_in_rows, hp)
    return band_in_rows * wp * min(block_cin or cin, cin)


def vmem_bytes(hp: int, wp: int, cin: int, kh: int, kw: int, bco: int,
               ho: int, wo: int, *,
               sh: int = 1,
               sw: Optional[int] = None,
               block_h: Optional[int] = None,
               pool: Optional[Tuple[int, int]] = None,
               block_cin: Optional[int] = None,
               skip: bool = False,
               per_channel: bool = False) -> int:
    """Per-grid-step working-set estimate used by the DSE resource
    model: one halo row band (one Cin slice of it when ``block_cin`` is
    set) + weight tile + int32 accumulator scratch + output band, plus
    the residual skip band (``skip_vmem_bytes``) when a residual add is
    fused into the epilogue and the int32 per-lane shift row
    (``shift_vec_bytes``) when the layer is per-channel quantized.
    ``ho``/``wo`` are *final* output rows/cols (post-pool when ``pool``
    is fused); ``block_h=None`` means untiled (the whole plane in one
    band — the old kernel's working set)."""
    bh = min(block_h or ho, ho)
    conv_rows, _band_in_rows, _step = band_geometry(bh, kh, sh, pool)
    bci = min(block_cin or cin, cin)
    conv_wo = (wp - kw) // (sw or sh) + 1 if pool is not None else wo
    return (band_input_bytes(hp, wp, cin, kh, ho, sh=sh, block_h=block_h,
                             pool=pool, block_cin=block_cin)  # x band int8
            + kh * kw * bci * bco            # w tile int8
            + 4 * conv_rows * conv_wo * bco  # acc scratch int32
            + bh * wo * bco                  # y band int8
            + skip_vmem_bytes(conv_rows, conv_wo, bco, skip)
            + shift_vec_bytes(bco, per_channel))


def skip_vmem_bytes(conv_rows: int, conv_wo: int, bco: int,
                    skip: bool = True) -> int:
    """int8 bytes of the residual skip band a fused-merge grid step
    holds alongside the conv working set (conv-output geometry,
    pre-pool)."""
    return conv_rows * conv_wo * bco if skip else 0


def shift_vec_bytes(lanes: int, per_channel: bool = True) -> int:
    """int32 bytes of the per-lane requant-shift row a per-channel
    quantized grid step holds next to the bias row (the epilogue's
    shift-vector operand; zero in per-tensor mode, where the shift is
    a compile-time constant)."""
    return 4 * lanes if per_channel else 0


def dw_vmem_bytes(wp: int, c: int, kh: int, kw: int, bc: int,
                  ho: int, wo: int, *,
                  sh: int = 1,
                  sw: Optional[int] = None,
                  block_h: Optional[int] = None,
                  pool: Optional[Tuple[int, int]] = None,
                  per_channel: bool = False,
                  multiplier: int = 1,
                  skip: bool = False) -> int:
    """Per-grid-step working set of the depthwise row-band kernel.  The
    input band is channel-tiled (unlike the dense kernel, which must see
    every Cin for the contraction), so ``bc`` bounds every term
    (including the per-channel shift row in per-channel mode).  ``c`` is
    the *output* channel count; with a channel ``multiplier`` m > 1 the
    input band carries only ``bc / m`` channels (each feeds m output
    lanes in-register), and ``skip`` adds the fused residual band in
    conv-output geometry, as in :func:`vmem_bytes`."""
    bh = min(block_h or ho, ho)
    conv_rows, band_in_rows, _step = band_geometry(bh, kh, sh, pool)
    conv_wo = (wp - kw) // (sw or sh) + 1 if pool is not None else wo
    bc = min(bc, c)
    bc_in = -(-bc // multiplier)
    return (band_in_rows * wp * bc_in        # x band int8 (channel tile)
            + kh * kw * bc                   # per-channel taps int8
            + 4 * conv_rows * conv_wo * bc   # acc scratch int32
            + bh * wo * bc                   # y band int8
            + skip_vmem_bytes(conv_rows, conv_wo, bc, skip)
            + shift_vec_bytes(bc, per_channel))


def gconv_vmem_bytes(wp: int, cin_g: int, cout_g: int, kh: int, kw: int,
                     ho: int, wo: int, *,
                     sh: int = 1,
                     sw: Optional[int] = None,
                     block_h: Optional[int] = None,
                     pool: Optional[Tuple[int, int]] = None,
                     per_channel: bool = False) -> int:
    """Per-grid-step working set of the ragged grouped-conv band kernel
    (:func:`qgconv2d`): one group's input-channel slice of the halo
    band, its filter tile, the int32 accumulator, and the group's
    output band — the group axis is a grid axis, so per-step VMEM never
    scales with the group count."""
    bh = min(block_h or ho, ho)
    conv_rows, band_in_rows, _step = band_geometry(bh, kh, sh, pool)
    conv_wo = (wp - kw) // (sw or sh) + 1 if pool is not None else wo
    return (band_in_rows * wp * cin_g        # x band int8 (group slice)
            + kh * kw * cin_g * cout_g       # w tile int8
            + 4 * conv_rows * conv_wo * cout_g  # acc scratch int32
            + bh * wo * cout_g               # y band int8
            + shift_vec_bytes(cout_g, per_channel))


def _rup(x: int, mult: int) -> int:
    return -(-x // mult) * mult

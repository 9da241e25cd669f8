"""Fused int8 conv + requant + ReLU (+ skip, concat, max-pool) kernels.

``qconv2d`` launches the hand-written CUDA kernel ``csrc/qconv.cu`` on a
CUDA tensor and runs the plain version :func:`qconv2d_plain` on a CPU
tensor.  It replaces the Pallas kernel
``src/repro/kernels/qconv.py:qconv2d`` (``_qconv_band_kernel`` +
``_band_epilogue``); with ``out_buf`` it is :func:`qconv2d_into`, which
replaces ``_qconv2d_into``.  On the H100 the dense convs of the main path
are bound by operations: the kernel is an implicit GEMM on ``__dp4a``,
with the fused max-pool computed on whole windows per block (see the
note at the top of the source).

The depthwise and ragged-grouped convs (``qdwconv2d``/``qgconv2d`` in
the JAX package) run their plain version on the CPU; on CUDA they raise
until their kernels are ported.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, ref
from .qgemm import shift_args

INT8_MIN, INT8_MAX = ref.INT8_MIN, ref.INT8_MAX
#: GEMM rows of one block: the widest fused pool window it holds.
MAX_POOL_TAPS = 64

#: Launches of each wrapper's kernel (plain-version calls are not counted).
launches = {"qconv2d": 0, "qconv2d_into": 0}

_SIGNATURES = {"qconv_s8": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 22
               + [ctypes.c_void_p]}


def qconv2d_plain(
    x: torch.Tensor,  # (N, Hp, Wp, Cin) int8, pre-padded
    w: torch.Tensor,  # (KH, KW, Cin/groups, Cout) int8
    b: Optional[torch.Tensor],  # (Cout,) int32
    *,
    strides: Tuple[int, int] = (1, 1),
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
) -> torch.Tensor:
    """The kernels' semantics in plain PyTorch (any device, any
    ``groups``), in the JAX package's ``_band_epilogue`` order: bias →
    requant → ReLU → clip; with a skip, align both operands → add →
    merge requant → merge ReLU → clip; with a concat, the operand's
    alignment and the merge's ReLU; max-pool last.  With ``out_buf`` the
    result is written into its channels ``[out_off, out_off + Cout)``
    in place and the whole buffer is returned."""
    acc = ref.int_conv_nhwc(x, w, strides, groups)
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
    y = acc.to(torch.int8)
    if pool is not None:
        y = ref.maxpool2d_ref(y, pool[0], pool[1])
    if out_buf is None:
        return y
    out_buf[..., out_off:out_off + y.shape[-1]] = y   # in place
    return out_buf


def _launch(x, w, b, out, *, strides, shift, relu, pool, skip, skip_shifts,
            merge_shift, merge_relu, out_off, concat_shift, concat_relu,
            what: str) -> None:
    """Check the operands of a CUDA launch and run the kernel into
    ``out`` (NHWC, channel stride ``out.shape[-1]``)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {x.device}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{what} takes int8 operands, got {x.dtype}, {w.dtype}")
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"{what}: dense conv shapes {tuple(x.shape)} and "
                         f"HWIO {tuple(w.shape)}")
    n, hp, wp, cin = x.shape
    kh, kw, _, cout = w.shape
    sh, sw = strides
    if hp < kh or wp < kw or sh < 1 or sw < 1:
        raise ValueError(f"{what}: window {kh}x{kw} stride {strides} over "
                         f"input {hp}x{wp}")
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    pw, ps = pool if pool is not None else (1, 1)
    if pw * pw > MAX_POOL_TAPS or ho < pw or wo < pw or ps < 1:
        raise ValueError(f"{what}: pool {pool} over conv output {ho}x{wo}")
    oh, ow = (ho - pw) // ps + 1, (wo - pw) // ps + 1
    c_tot = out.shape[-1]
    if tuple(out.shape[:3]) != (n, oh, ow) or out_off < 0 \
            or out_off + cout > c_tot:
        raise ValueError(f"{what}: output {tuple(out.shape)} cannot hold "
                         f"channels [{out_off}, {out_off + cout}) of "
                         f"({n}, {oh}, {ow}, ...)")
    if out.dtype != torch.int8:
        raise TypeError(f"{what}: output must be int8, got {out.dtype}")
    if b is not None and (b.dtype != torch.int32 or b.shape != (cout,)):
        raise ValueError(f"{what}: bias must be ({cout},) int32")
    if skip is not None and (skip.dtype != torch.int8
                             or tuple(skip.shape) != (n, ho, wo, cout)):
        raise ValueError(f"{what}: skip must be int8 {(n, ho, wo, cout)}, "
                         f"got {skip.dtype} {tuple(skip.shape)}")
    for t in (w, b, skip, out):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: operands on {t.device} and {x.device}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes contiguous tensors")
    s, svec = shift_args(shift, cout, x.device)
    a_conv, a_skip = (int(v) for v in skip_shifts)
    for name, v in (("skip_shifts", a_conv), ("skip_shifts", a_skip),
                    ("merge_shift", merge_shift),
                    ("concat_shift", concat_shift)):
        if not 0 <= int(v) <= 31:
            raise ValueError(f"{what}: {name} must lie in [0, 31], got {v}")
    vec = int(cin % 4 == 0 and x.data_ptr() % 4 == 0)
    lib = _build.load("qconv", _SIGNATURES)
    p = _build.ptr
    err = lib.qconv_s8(
        p(x), p(w), p(b), p(svec), p(skip), p(out),
        n, hp, wp, cin, kh, kw, cout, sh, sw, pw, ps, s, int(relu),
        a_conv, a_skip, int(merge_shift), int(merge_relu),
        int(concat_shift), int(concat_relu), c_tot, int(out_off), vec,
        _build.stream(x.device))
    _build.check(err, what)


def _out_hw(x, w, strides, pool):
    ho = (x.shape[1] - w.shape[0]) // strides[0] + 1
    wo = (x.shape[2] - w.shape[1]) // strides[1] + 1
    if pool is None:
        return ho, wo
    return (ho - pool[0]) // pool[1] + 1, (wo - pool[0]) // pool[1] + 1


def qconv2d(
    x: torch.Tensor,  # (N, Hp, Wp, Cin) int8, pre-padded (VALID conv)
    w: torch.Tensor,  # (KH, KW, Cin, Cout) int8
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
) -> torch.Tensor:
    """Dense fused int8 conv.  Returns (N, OH, OW, Cout) int8 (post-pool
    when ``pool`` is given); with ``out_buf`` the result lands in that
    buffer's channels ``[out_off, out_off + Cout)`` (see
    :func:`qconv2d_into`) and the buffer is returned.  ``skip`` is a
    residual operand in the *conv output* geometry (pre-pool).  On a CPU
    tensor this is the plain version; on a CUDA tensor it launches the
    kernel or raises."""
    kw_ = dict(strides=strides, shift=shift, relu=relu, pool=pool, skip=skip,
               skip_shifts=skip_shifts, merge_shift=merge_shift,
               merge_relu=merge_relu, concat_shift=concat_shift,
               concat_relu=concat_relu)
    if out_buf is not None:
        return qconv2d_into(x, w, b, out_buf, out_off=out_off, **kw_)
    if x.device.type == "cpu":
        return qconv2d_plain(x, w, b, **kw_)
    oh, ow = _out_hw(x, w, strides, pool)
    y = torch.empty((x.shape[0], oh, ow, w.shape[-1]), dtype=torch.int8,
                    device=x.device)
    _launch(x, w, b, y, out_off=0, what="qconv2d", **kw_)
    launches["qconv2d"] += 1
    return y


def qconv2d_into(x, w, b, out_buf: torch.Tensor, *, out_off: int,
                 **kw) -> torch.Tensor:
    """Concat-epilogue variant of :func:`qconv2d`: writes the conv's
    result, after this operand's ``concat_shift`` alignment and the
    merge's ``concat_relu``, into channels ``[out_off, out_off + Cout)``
    of the shared merge buffer ``out_buf`` (N, OH, OW, C_tot) **in
    place** and returns the buffer.  The other channels are never
    touched."""
    if x.device.type == "cpu":
        return qconv2d_plain(x, w, b, out_buf=out_buf, out_off=out_off, **kw)
    _launch(x, w, b, out_buf, out_off=out_off, what="qconv2d_into", **kw)
    launches["qconv2d_into"] += 1
    return out_buf


def qdwconv2d(x, w, b, *, strides=(1, 1), shift=0, relu=True, pool=None,
              **kw) -> torch.Tensor:
    """Depthwise conv (groups == Cin, Cout = m·Cin; ``w`` is HWIO with
    one input channel per group).  CPU: the plain version.  CUDA: its
    kernel is not ported yet, so it raises."""
    if x.device.type == "cpu":
        return qconv2d_plain(x, w, b, strides=strides, shift=shift,
                             relu=relu, pool=pool, groups=x.shape[-1], **kw)
    raise NotImplementedError(
        "depthwise conv on CUDA: its kernel (qdwconv2d) comes with port "
        "slice 2")


def qgconv2d(x, w, b, *, groups: int, strides=(1, 1), shift=0, relu=True,
             pool=None) -> torch.Tensor:
    """Ragged grouped conv (1 < groups < Cin).  CPU: the plain version.
    CUDA: its kernel is not ported yet, so it raises."""
    if x.device.type == "cpu":
        return qconv2d_plain(x, w, b, strides=strides, shift=shift,
                             relu=relu, pool=pool, groups=groups)
    raise NotImplementedError(
        "grouped conv on CUDA: its kernel (qgconv2d) comes with port slice 2")

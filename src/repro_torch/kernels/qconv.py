"""Fused int8 conv + requant + ReLU (+ skip, concat, max-pool) kernels.

Each wrapper launches its hand-written CUDA kernel on a CUDA tensor and
runs the plain version :func:`qconv2d_plain` on a CPU tensor:

* :func:`qconv2d` — dense conv, ``csrc/qconv.cu``; replaces the Pallas
  kernel ``src/repro/kernels/qconv.py:qconv2d`` (``_qconv_band_kernel`` +
  ``_band_epilogue``).  With ``out_buf`` it is :func:`qconv2d_into`,
  which replaces ``_qconv2d_into``.  Bound by operations on the H100: an
  implicit GEMM on ``__dp4a`` with the fused max-pool computed on whole
  windows per block (see the note at the top of the source).
* :func:`qdwconv2d` — depthwise conv with channel multiplier m,
  ``csrc/qdwconv.cu``; replaces ``qdwconv2d`` and its ``out_buf`` branch.
  Bound by bytes, and at the main path's sizes by launch overhead: a
  direct conv, one thread per (output pixel, output channel).
* :func:`qgconv2d` — ragged grouped conv, the dense kernel of
  ``csrc/qconv.cu`` with the group on ``gridDim.z``; replaces
  ``qgconv2d``.

All of them share one epilogue (``csrc/requant.cuh``), in the order
:func:`qconv2d_plain` spells out.
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
launches = {"qconv2d": 0, "qconv2d_into": 0, "qdwconv2d": 0,
            "qdwconv2d_into": 0, "qgconv2d": 0}

_SIGNATURES = {
    "qconv": {"qconv_s8": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 23
              + [ctypes.c_void_p]},
    "qdwconv": {"qdwconv_s8": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 21
                + [ctypes.c_void_p]},
}


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


def qdwconv2d_plain(x, w, b, **kw) -> torch.Tensor:
    """:func:`qdwconv2d`'s semantics in plain PyTorch: the grouped conv
    with one group per input channel."""
    return qconv2d_plain(x, w, b, groups=x.shape[-1], **kw)


def _launch(kernel: str, x, w, b, out, *, groups, strides, shift, relu, pool,
            skip, skip_shifts, merge_shift, merge_relu, out_off, concat_shift,
            concat_relu, what: str) -> None:
    """Check the operands of a CUDA launch and run ``kernel`` (``"qconv"``,
    dense or grouped, or ``"qdwconv"``) into ``out`` (NHWC, channel stride
    ``out.shape[-1]``).  Every check comes before the device's, so a
    tensor on any device reports a bad operand first."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{what} takes int8 operands, got {x.dtype}, {w.dtype}")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"{what}: NHWC input and HWIO weight, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, hp, wp, cin = x.shape
    kh, kw, cin_g, cout = w.shape
    if kernel == "qdwconv":
        if cin_g != 1 or cin == 0 or cout % cin:
            raise ValueError(f"{what}: depthwise weight must be HWIO "
                             f"(KH, KW, 1, m*{cin}), got {tuple(w.shape)}")
    elif groups < 1 or cin % groups or cout % groups \
            or cin_g * groups != cin:
        raise ValueError(f"{what}: {groups} groups over input "
                         f"{tuple(x.shape)} and HWIO {tuple(w.shape)}")
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
    for t in (x, w, b, skip, out):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: operands on {t.device} and {x.device}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
    a_conv, a_skip = (int(v) for v in skip_shifts)
    for name, v in (("skip_shifts", a_conv), ("skip_shifts", a_skip),
                    ("merge_shift", merge_shift),
                    ("concat_shift", concat_shift)):
        if not 0 <= int(v) <= 31:
            raise ValueError(f"{what}: {name} must lie in [0, 31], got {v}")
    s, svec = shift_args(shift, cout, x.device)
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {x.device}")
    args = [n, hp, wp, cin, kh, kw, cout, sh, sw, pw, ps, s, int(relu),
            a_conv, a_skip, int(merge_shift), int(merge_relu),
            int(concat_shift), int(concat_relu), c_tot, int(out_off)]
    lib = _build.load(kernel, _SIGNATURES[kernel])
    p = _build.ptr
    ptrs = (p(x), p(w), p(b), p(svec), p(skip), p(out))
    if kernel == "qdwconv":
        err = lib.qdwconv_s8(*ptrs, *args, _build.stream(x.device))
    else:
        # 4-byte input loads need whole words inside each group's slice
        vec = int(cin_g % 4 == 0 and x.data_ptr() % 4 == 0)
        err = lib.qconv_s8(*ptrs, *args, vec, int(groups),
                           _build.stream(x.device))
    _build.check(err, what)


def _out_hw(x, w, strides, pool):
    """Output (pooled) height and width; 0 where the window does not fit,
    which :func:`_launch` then rejects."""
    ho = (x.shape[1] - w.shape[0]) // strides[0] + 1
    wo = (x.shape[2] - w.shape[1]) // strides[1] + 1
    if pool is not None:
        ho, wo = (ho - pool[0]) // pool[1] + 1, (wo - pool[0]) // pool[1] + 1
    return max(ho, 0), max(wo, 0)


def _run(kernel: str, what: str, x, w, b, *, groups: int,
         out_buf: Optional[torch.Tensor] = None, out_off: int = 0,
         **kw) -> torch.Tensor:
    """Launch ``kernel`` on a CUDA tensor into a new (N, OH, OW, Cout)
    output, or into channels ``[out_off, out_off + Cout)`` of ``out_buf``
    in place; count the launch under ``what``."""
    if out_buf is None:
        oh, ow = _out_hw(x, w, kw["strides"], kw["pool"])
        out = torch.empty((x.shape[0], oh, ow, w.shape[-1]),
                          dtype=torch.int8, device=x.device)
    else:
        out = out_buf
    _launch(kernel, x, w, b, out, groups=groups, out_off=out_off, what=what,
            **kw)
    launches[what] += 1
    return out


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
    return _run("qconv", "qconv2d", x, w, b, groups=1, **kw_)


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
    return _run("qconv", "qconv2d_into", x, w, b, groups=1, out_buf=out_buf,
                out_off=out_off, **kw)


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
    return _run("qdwconv", what, x, w, b, groups=x.shape[-1], **kw_)


def qgconv2d(x, w, b, *, groups: int, strides=(1, 1), shift=0, relu=True,
             pool=None) -> torch.Tensor:
    """Ragged grouped int8 conv (1 < groups < Cin; HWIO weight
    (KH, KW, Cin/groups, Cout)) with requant, ReLU and the fused
    max-pool; it never takes a skip or a concat buffer.  On a CPU tensor
    this is the plain version; on a CUDA tensor it launches the dense
    kernel once per group or raises."""
    kw_ = dict(strides=strides, shift=shift, relu=relu, pool=pool)
    if x.device.type == "cpu":
        return qconv2d_plain(x, w, b, groups=groups, **kw_)
    return _run("qconv", "qgconv2d", x, w, b, groups=groups, skip=None,
                skip_shifts=(0, 0), merge_shift=0, merge_relu=False,
                concat_shift=0, concat_relu=False, **kw_)

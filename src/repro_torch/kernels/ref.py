"""Plain PyTorch versions of the kernels' semantics, and the oracles.

These define the *exact* integer semantics the CUDA kernels must
reproduce, and they are what every op runs on a CPU tensor.  All
integer arithmetic follows the paper's fixed-point rules: int8
operands, int32 accumulation, round-half-up arithmetic right-shift
requantization (shift = m_w + m_x - m_y), fused ReLU.

Activations are NHWC and conv weights HWIO, as in the JAX package.
The conv and GEMM cores are exact on both devices: on the CPU they run
in int32 (``torch.mm`` and ``F.conv2d`` take int32 there); on CUDA,
which has no integer conv or matrix product in PyTorch, they run in
float64 and are rounded back to int32 — exact because every product of
two int8 values and every partial sum is an integer far below 2**53
(|acc| <= 128 * 128 * K + |bias|).  The pools reduce a view of all their
windows in one integer reduction.  int32 additions wrap two's
complement on both devices, as the JAX reference's do.

:func:`attention_ref` is the float grouped-query attention oracle that
the LM layers' ``naive`` attention calls; :func:`ssd_ref` is the
sequential oracle of the Mamba-2 SSD scan.

The ``*_trials_ref`` functions are the plain versions of the kernels'
trial forms, what the JAX package's kernels become under ``jax.vmap`` in
an SER campaign: the weight carries a leading trial axis T, the batch
holds T trials of N rows (images) each, and trial t's rows
``[t*N, (t+1)*N)`` go through the single-trial plain version with its
own weight ``w[t]`` (:func:`over_trials`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

INT8_MIN, INT8_MAX = -128, 127


def _is_scalar_shift(shift) -> bool:
    if torch.is_tensor(shift):
        return shift.ndim == 0
    return not isinstance(shift, (tuple, list))


def round_shift(v: torch.Tensor, shift) -> torch.Tensor:
    """Round-half-up arithmetic right shift (no clip/relu).  ``shift``
    is an int (per-tensor) or an int32 vector (tuple or tensor)
    broadcast against the **last axis** of ``v`` (per-output-channel
    lanes) — the shared requant primitive of every plain version and
    both epilogue modes."""
    if _is_scalar_shift(shift):
        s = int(shift)
        if s > 0:
            v = (v + (1 << (s - 1))) >> s
        return v
    s = torch.as_tensor(shift, dtype=torch.int32, device=v.device)
    one = torch.ones_like(s)
    half = torch.where(s > 0, one << (s - 1).clamp_min(0),
                       torch.zeros_like(s))
    return (v + half) >> s


def requant(acc: torch.Tensor, shift, relu: bool) -> torch.Tensor:
    """int32 accumulator -> int8: round-half-up shift, relu, clip.
    ``shift`` may be a per-lane int32 vector (per-channel quantization);
    lanes ride the last axis of ``acc``."""
    acc = round_shift(acc, shift)
    if relu:
        acc = acc.clamp_min(0)
    return acc.clamp(INT8_MIN, INT8_MAX).to(torch.int8)


def align_shift(v: torch.Tensor, shift: int) -> torch.Tensor:
    """Round-half-up arithmetic right shift (no clip) — the operand
    alignment step of a residual merge: an int8 operand at fixed-point
    position m is moved to position m - shift."""
    if shift > 0:
        v = (v + (1 << (shift - 1))) >> shift
    return v


def _exact_int32(f64: torch.Tensor) -> torch.Tensor:
    # the float64 core holds integers exactly; rounding first guards
    # against any convolution algorithm whose transforms leave a
    # residue far below 0.5
    return torch.round(f64).to(torch.int32)


def int_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 (M, K) x (K, N) product of int8 operands."""
    if x.device.type == "cpu":
        return torch.mm(x.to(torch.int32), w.to(torch.int32))
    return _exact_int32(torch.mm(x.to(torch.float64), w.to(torch.float64)))


def int_conv_nhwc(x: torch.Tensor, w: torch.Tensor,
                  strides: Tuple[int, int], groups: int = 1
                  ) -> torch.Tensor:
    """Exact int32 VALID conv: NHWC int8 input, HWIO int8 weight,
    NHWC int32 result."""
    xc = x.permute(0, 3, 1, 2)          # NCHW
    wc = w.permute(3, 2, 0, 1)          # OIHW
    if x.device.type == "cpu":
        acc = F.conv2d(xc.to(torch.int32), wc.to(torch.int32),
                       stride=tuple(strides), groups=groups)
    else:
        acc = _exact_int32(F.conv2d(xc.to(torch.float64),
                                    wc.to(torch.float64),
                                    stride=tuple(strides), groups=groups))
    return acc.permute(0, 2, 3, 1).contiguous()


def qgemm_ref(
    x: torch.Tensor,  # (M, K) int8
    w: torch.Tensor,  # (K, N) int8
    b: Optional[torch.Tensor],  # (N,) int32
    shift,
    relu: bool = False,
) -> torch.Tensor:
    acc = int_matmul(x, w)
    if b is not None:
        acc = acc + b.to(torch.int32)[None, :]
    return requant(acc, shift, relu)


def over_trials(fn, x: torch.Tensor, w: torch.Tensor, *operands,
                skip: Optional[torch.Tensor] = None,
                out_buf: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
    """The plain version of a trial form: ``fn`` (a single-trial plain
    version) on each trial's rows of ``x``, and of ``skip`` and
    ``out_buf`` where given, with that trial's weight ``w[t]``; the
    trials' results stacked back along the batch (or ``out_buf``,
    written in place)."""
    trials = w.shape[0]
    if trials < 1 or x.shape[0] % trials:
        raise ValueError(f"{trials} weight images over a batch of "
                         f"{x.shape[0]}")
    n = x.shape[0] // trials
    ys = []
    for t in range(trials):
        rows = slice(t * n, (t + 1) * n)
        part = {}
        if skip is not None:
            part["skip"] = skip[rows]
        if out_buf is not None:
            part["out_buf"] = out_buf[rows]
        ys.append(fn(x[rows], w[t], *operands, **part, **kw))
    return out_buf if out_buf is not None else torch.cat(ys)


def qgemm_trials_ref(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *, shift,
                     relu: bool = False, shift_vec=None,
                     w_k=None) -> torch.Tensor:
    """``qgemm``'s trial form: (T*M, K) x (T, K, N) -> (T*M, N), trial t's
    rows times ``w[t]``.  The staged copies are not read."""
    return over_trials(lambda xt, wt: qgemm_ref(xt, wt, b, shift, relu),
                       x, w)


def qconv2d_trials_ref(x, w, b, **kw) -> torch.Tensor:
    """The dense conv's trial form (``kernels/qconv.py:qconv2d_plain`` a
    trial): with ``out_buf`` the concat-buffer conv's, each trial's
    result written into its images of ``out_buf`` in place; with
    ``groups`` the ragged grouped conv's."""
    from .qconv import qconv2d_plain
    return over_trials(qconv2d_plain, x, w, b, **kw)


def qdwconv2d_trials_ref(x, w, b, **kw) -> torch.Tensor:
    """The depthwise conv's trial form (with ``out_buf``, its
    concat-buffer form)."""
    from .qconv import qdwconv2d_plain
    return over_trials(qdwconv2d_plain, x, w, b, **kw)


def qconv2d_ref(
    x: torch.Tensor,  # (N, H, W, Cin) int8, already zero-padded
    w: torch.Tensor,  # (KH, KW, Cin/groups, Cout) int8
    b: Optional[torch.Tensor],  # (Cout,) int32
    strides: Tuple[int, int],
    shift,
    relu: bool = True,
    pool: Optional[Tuple[int, int]] = None,  # (window, stride)
    groups: int = 1,
) -> torch.Tensor:
    """Fused conv+ReLU+maxpool, NHWC/HWIO, VALID padding (pad upstream).
    ``groups`` follows ONNX Conv semantics (groups == Cin == Cout is
    depthwise)."""
    acc = int_conv_nhwc(x, w, strides, groups)
    if b is not None:
        acc = acc + b.to(torch.int32)[None, None, None, :]
    y = requant(acc, shift, relu)
    if pool is not None:
        y = maxpool2d_ref(y, pool[0], pool[1])
    return y


def qadd_ref(xs: Sequence[torch.Tensor], align_shifts, shift,
             relu: bool = False) -> torch.Tensor:
    """Residual-merge semantics: align each int8 operand to the common
    fixed-point position (round-half-up right shift in int32), add, then
    requantize to the output scale."""
    acc = None
    for x, s in zip(xs, align_shifts):
        v = align_shift(x.to(torch.int32), s)
        acc = v if acc is None else acc + v
    return requant(acc, shift, relu)


def qconcat_ref(xs: Sequence[torch.Tensor], align_shifts, axis: int = -1,
                relu: bool = False) -> torch.Tensor:
    """Channel-merge semantics: align each int8 operand to the common
    fixed-point position (round-half-up shift in int32, clipped back to
    int8 — a zero shift is the identity), concatenate, then apply the
    optional fused post-merge ReLU."""
    aligned = [
        align_shift(x.to(torch.int32), s).clamp(INT8_MIN, INT8_MAX)
        .to(torch.int8) if s else x
        for x, s in zip(xs, align_shifts)
    ]
    y = torch.cat(aligned, dim=axis)
    if relu:
        y = y.clamp_min(0)
    return y


def pad_nhwc(x: torch.Tensor, pads, value: int = 0) -> torch.Tensor:
    """ONNX pads (top, left, bottom, right) on an NHWC tensor."""
    if not any(pads):
        return x
    return F.pad(x, (0, 0, pads[1], pads[3], pads[0], pads[2]), value=value)


def out_hw(h: int, w: int, kh: int, kw: int, strides,
           pads) -> Tuple[int, int]:
    """Output height and width of a ``kh`` x ``kw`` window at ``strides``
    over an (h, w) input with ONNX pads (top, left, bottom, right):
    ONNX's floor rule over the padded input."""
    return ((h + pads[0] + pads[2] - kh) // strides[0] + 1,
            (w + pads[1] + pads[3] - kw) // strides[1] + 1)


def _windows(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """The (N, OH, OW, C, window, window) view of every VALID pooling
    window of an NHWC tensor; one reduction over its last two axes is
    the pool."""
    return x.unfold(1, window, stride).unfold(2, window, stride)


def maxpool2d_ref(x: torch.Tensor, window: int, stride: int,
                  pads: Tuple[int, int, int, int] = (0, 0, 0, 0)
                  ) -> torch.Tensor:
    """Standalone int8 NHWC max-pool; pads take INT8_MIN, the identity
    of max."""
    return _windows(pad_nhwc(x, pads, INT8_MIN), window,
                    stride).amax((-2, -1))


def avgpool2d_ref(x: torch.Tensor, window: int, stride: int,
                  pads: Tuple[int, int, int, int] = (0, 0, 0, 0)
                  ) -> torch.Tensor:
    """Standalone int8 NHWC average-pool: int32 sum, round-half-up
    divide (fixed-point semantics — the scale is unchanged).  Padded
    windows divide by the real window population (the ONNX
    ``count_include_pad=0`` default), counted by pooling an all-ones
    plane with zero padding."""
    def window_sums(v):
        return _windows(pad_nhwc(v.to(torch.int32), pads, 0), window,
                        stride).sum((-2, -1), dtype=torch.int32)
    summed = window_sums(x)
    if any(pads):
        counts = window_sums(torch.ones((1,) + tuple(x.shape[1:3]) + (1,),
                                        dtype=torch.int32, device=x.device))
    else:
        counts = window * window
    q = torch.div(summed + counts // 2, counts, rounding_mode="floor")
    return q.clamp(INT8_MIN, INT8_MAX).to(torch.int8)


def attention_ref(q: torch.Tensor,  # (B, H, Sq, D)
                  k: torch.Tensor,  # (B, HKV, Skv, D)
                  v: torch.Tensor,  # (B, HKV, Skv, D)
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention oracle.  ``q_offset`` is the absolute
    position of q[0] (for decode/prefill continuation).  ``window`` is a
    sliding-attention span: key j visible to query i iff
    i - window < j <= i.  Scores and softmax in float32; a row that sees
    no key gets the mean of v (every score is the same ``-1e30``)."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"{h} query heads over {hkv} KV heads")
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    kr = torch.repeat_interleave(k, g, dim=1).float()
    vr = torch.repeat_interleave(v, g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def ssd_ref(x: torch.Tensor,    # (B, L, H, P)
            dt: torch.Tensor,   # (B, L, H), positive (post-softplus)
            a: torch.Tensor,    # (H,), negative
            b: torch.Tensor,    # (B, L, G, N)
            c: torch.Tensor,    # (B, L, G, N)
            d: Optional[torch.Tensor] = None,           # (H,) skip
            init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential state-space-duality oracle (Mamba-2 SSD), one step a
    position, in float32:
        S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T ;  y_t = S_t C_t + D x_t
    Returns (y (B, L, H, P) in x's dtype, final state (B, H, P, N) in
    float32)."""
    bsz, length, h, p = x.shape
    g = h // b.shape[2]
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf = torch.repeat_interleave(b.float(), g, dim=2)   # (B, L, H, N)
    cf = torch.repeat_interleave(c.float(), g, dim=2)
    s = (init_state.float().clone() if init_state is not None else
         torch.zeros((bsz, h, p, b.shape[3]), dtype=torch.float32,
                     device=x.device))
    ys = []
    for t in range(length):
        decay = torch.exp(dtf[:, t] * af[None, :])       # (B, H)
        contrib = torch.einsum("bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t],
                               bf[:, t])
        s = decay[..., None, None] * s + contrib
        ys.append(torch.einsum("bhpn,bhn->bhp", s, cf[:, t]))
    y = torch.stack(ys, dim=1)
    if d is not None:
        y = y + d.float()[None, None, :, None] * xf
    return y.to(x.dtype), s

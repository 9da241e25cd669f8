"""(N, m) fixed-point post-training quantization application (§4.2).

The paper's "Physical domain" step: CNN2Gate *does not invent* a
quantization — it applies a user-given per-layer ``(N, m)`` pair where a
fixed-point value is represented as ``N × 2^-m`` with 8-bit arithmetic
units.  This module implements:

  * ``QuantSpec`` — the per-layer (m_w, m_x, m_y) exponents (weights,
    input activations, output activations).  All scales are powers of
    two, matching the paper's shift-based arithmetic.  ``m_w`` may be a
    **per-output-channel vector** (a tuple, one exponent per Cout lane)
    — the standard accuracy-recovery move of the FPGA-inference
    literature the paper builds on (per-channel weight scaling keeps
    the shift-only datapath: the requant shift simply becomes a
    per-lane shift vector).  Activations stay per-tensor either way,
    so merge (Add/Concat) alignment is untouched.
  * ``quantize_weights`` — float weights/biases → int8 N with the given
    m (biases are int32 at scale 2^-(m_w+m_x) so they add directly into
    the int32 accumulator; with per-channel m_w each bias lane uses its
    own channel's accumulator scale).
  * ``best_pow2_exponent`` / ``best_pow2_exponents_per_channel`` — the
    max-abs power-of-two PTQ rule the DAG-aware calibrator
    (synthesis.calibrate_quantization) applies per named tensor (and,
    in per-channel mode, per output channel of each weight), standing
    in for the external tool the paper assumes the user ran.
  * ``requant_shift`` — the right-shift that maps int32 accumulators back
    to int8 outputs: shift = m_w + m_x - m_y (per-lane when m_w is a
    vector).
  * ``clamp_code`` — the int8 code at which a fused ReLU-n (ONNX Clip
    with min 0, e.g. ReLU6) clamps a stage's output at position m_y.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import numpy as np

INT8_MIN, INT8_MAX = -128, 127

#: Widest per-lane requant shift the int32 datapath supports: the
#: round-half-up bias ``1 << (s-1)`` must stay an int32 constant.
MAX_SHIFT = 30


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Per-layer fixed-point format: value = N * 2^-m.

    ``m_w`` is an int (per-tensor weight scale) or a tuple of ints
    (per-output-channel scales, one per Cout lane).  ``m_x``/``m_y``
    are always per-tensor: activations keep one position so the
    shift-only merge alignment of residual/concat stages is unchanged.
    """

    m_w: Union[int, Tuple[int, ...]]  # weight fraction bits (scalar | per-Cout)
    m_x: int  # input-activation fraction bits
    m_y: int  # output-activation fraction bits

    @property
    def per_channel(self) -> bool:
        return isinstance(self.m_w, tuple)

    @property
    def m_w_min(self) -> int:
        """Smallest weight exponent across lanes (the lane that caps
        ``m_y``: every per-lane shift must stay non-negative)."""
        return min(self.m_w) if self.per_channel else self.m_w

    @functools.cached_property
    def requant_shift(self) -> Union[int, Tuple[int, ...]]:
        """int32 accumulator (scale 2^-(m_w+m_x)) -> int8 out (scale
        2^-m_y).  A per-channel spec yields a per-lane shift vector.
        Worked out once per spec: the executor reads it at every stage
        of every forward, and a per-lane vector costs a pass over its
        lanes."""
        shifts = shift_lanes(self)
        if self.per_channel:
            if any(s < 0 for s in shifts):
                raise ValueError(f"negative per-lane requant shift for {self}")
            if any(s > MAX_SHIFT for s in shifts):
                raise ValueError(
                    f"per-lane requant shift exceeds {MAX_SHIFT} for {self}")
            return shifts
        (s,) = shifts
        if s < 0:
            raise ValueError(f"negative requant shift for {self}")
        return s


def shift_lanes(spec: "QuantSpec") -> Tuple[int, ...]:
    """Per-lane requant shifts of a spec with NO range enforcement —
    the static verifier's view (it *reports* out-of-range shifts as
    diagnostics instead of raising mid-analysis).  Always a tuple; a
    per-tensor spec yields one lane."""
    if spec.per_channel:
        return tuple(mw + spec.m_x - spec.m_y for mw in spec.m_w)
    return (spec.m_w + spec.m_x - spec.m_y,)


@dataclasses.dataclass
class QuantizedTensor:
    """int8 payload + its fixed-point exponent m (value = q * 2^-m)."""

    q: np.ndarray
    m: int

    def dequantize(self) -> np.ndarray:
        return self.q.astype(np.float32) * (2.0 ** -self.m)


def quantize_array(x: np.ndarray, m, bits: int = 8) -> np.ndarray:
    """Round-to-nearest fixed-point quantization to ``bits`` at scale
    2^-m.  ``m`` may be an int or an array broadcastable against ``x``
    (per-channel quantization pre-shapes it along the channel axis)."""
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    scale = np.power(2.0, np.asarray(m, np.float64))
    q = np.clip(np.rint(np.asarray(x, np.float64) * scale), lo, hi)
    dtype = np.int8 if bits <= 8 else np.int32
    return q.astype(dtype)


def dequantize_array(q: np.ndarray, m: int) -> np.ndarray:
    return q.astype(np.float32) * (2.0 ** -m)


def _mw_broadcast(w: np.ndarray, m_w: Tuple[int, ...]) -> np.ndarray:
    """Shape a per-Cout exponent vector for broadcasting against ``w``:
    OIHW conv weights carry Cout on axis 0, (K, N) FC weights on the
    last axis."""
    mv = np.asarray(m_w, np.int64)
    if w.ndim == 4:  # OIHW (exporter layout — staging to HWIO happens later)
        if mv.shape[0] != w.shape[0]:
            raise ValueError(
                f"per-channel m_w has {mv.shape[0]} lanes for OIHW weight "
                f"with Cout={w.shape[0]}")
        return mv.reshape(-1, 1, 1, 1)
    if mv.shape[0] != w.shape[-1]:
        raise ValueError(
            f"per-channel m_w has {mv.shape[0]} lanes for weight with "
            f"{w.shape[-1]} output features")
    return mv.reshape((1,) * (w.ndim - 1) + (-1,))


def quantize_weights(
    w: np.ndarray, b: Optional[np.ndarray], spec: QuantSpec
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Apply the given (N, m) format: int8 weights, int32 biases at the
    accumulator scale (so bias adds need no extra shift).  With a
    per-channel spec every output channel quantizes at its own
    ``m_w[c]`` and its bias at ``m_w[c] + m_x``."""
    if spec.per_channel:
        mw = _mw_broadcast(w, spec.m_w)
        wq = quantize_array(w, mw, bits=8)
        bq = None
        if b is not None:
            bq = quantize_array(
                b, np.asarray(spec.m_w, np.int64) + spec.m_x, bits=32)
        return wq, bq
    wq = quantize_array(w, spec.m_w, bits=8)
    bq = None
    if b is not None:
        bq = quantize_array(b, spec.m_w + spec.m_x, bits=32)
    return wq, bq


def requantize(acc: np.ndarray, spec: QuantSpec, relu: bool = False) -> np.ndarray:
    """int32 accumulator -> int8 output via arithmetic right shift with
    round-to-nearest (add half before shifting), optional fused ReLU.
    A per-channel spec shifts each output-channel lane (the last axis
    of ``acc``) by its own count."""
    s = spec.requant_shift
    acc = np.asarray(acc, np.int64)
    if isinstance(s, tuple):
        sv = np.asarray(s, np.int64)
        half = np.where(sv > 0, np.left_shift(1, np.maximum(sv - 1, 0)), 0)
        acc = np.right_shift(acc + half, sv)
    elif s > 0:
        acc = (acc + (1 << (s - 1))) >> s
    if relu:
        acc = np.maximum(acc, 0)
    return np.clip(acc, INT8_MIN, INT8_MAX).astype(np.int8)


def clamp_code(bound: float, m_y: int, bits: int = 8) -> int:
    """The ReLU-n fixed-point rule (DESIGN.md): the largest code of a
    stage's output at position ``m_y`` that a real upper bound ``bound``
    allows, ``min(2^(bits-1) - 1, floor(bound * 2^m_y))``; the epilogue
    clamps its requantized value to [0, that code]."""
    return min((1 << (bits - 1)) - 1, int(np.floor(bound * 2.0 ** m_y)))


def best_pow2_exponent(x: np.ndarray, bits: int = 8) -> int:
    """Largest m such that max|x| * 2^m still fits in ``bits`` signed —
    the standard max-abs power-of-two PTQ rule."""
    amax = float(np.max(np.abs(x))) if x.size else 0.0
    if amax == 0.0:
        return bits - 1
    hi = 2 ** (bits - 1) - 1
    m = int(np.floor(np.log2(hi / amax)))
    return max(-(bits - 1), min(m, 24))


def best_pow2_exponents_per_channel(w: np.ndarray,
                                    bits: int = 8) -> Tuple[int, ...]:
    """Per-output-channel max-abs exponents for a weight tensor (OIHW
    conv: Cout on axis 0; (K, N) FC: output features on the last axis).

    The spread over the per-tensor exponent is clamped to keep every
    per-lane requant shift (``m_w[c] + m_x - m_y``) inside the int32
    round-half-up datapath (``MAX_SHIFT``): a near-dead channel would
    otherwise push its exponent to the PTQ cap and its shift past the
    representable range — those lanes gain nothing past the clamp (the
    shifted-away bits are already below one output LSB)."""
    caxis = 0 if w.ndim == 4 else w.ndim - 1
    per = [best_pow2_exponent(np.take(w, c, axis=caxis), bits)
           for c in range(w.shape[caxis])]
    lo = min(per)
    return tuple(min(m, lo + 15) for m in per)


def quantization_error(x: np.ndarray, m: int, bits: int = 8) -> float:
    """RMS relative error of round-tripping x through (N, m)."""
    q = quantize_array(x, m, bits)
    xd = dequantize_array(q, m)
    denom = float(np.sqrt(np.mean(x.astype(np.float64) ** 2))) or 1.0
    return float(np.sqrt(np.mean((xd - x) ** 2))) / denom

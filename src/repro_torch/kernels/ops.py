"""Public entry points of the kernels.

Two families, as in the JAX package:

  * ``*_nhwc`` — the kernels' layouts (NHWC activations, HWIO weights).
    These are what the whole-network executor calls: activations stay
    NHWC int8 from network ingress to egress.
  * ``*_nchw`` — ONNX-layout wrappers (NCHW / OIHW) that permute around
    the NHWC paths, for direct callers and layout-parity tests.

Every op runs where its tensors lie.  On a CUDA tensor the convs
(dense, depthwise, ragged grouped) and the GEMM launch their
hand-written kernels (``qconv.qconv2d``, ``qconv.qdwconv2d``,
``qconv.qgconv2d``, ``qgemm.qgemm``), and so does the standalone
max-pool (``pool.maxpool2d``), though the JAX package's pools were plain
array ops; nothing falls back to a plain version.  On a CPU tensor every
op runs its plain PyTorch version.  Merges and the standalone average
pools are plain torch ops on either device, as they were plain array
ops in the JAX package.  :func:`flash_attention`,
the LM layers' ``flash`` attention, launches ``csrc/flash_attention.cu``
on a CUDA tensor the same way, and :func:`ssd_scan`, every Mamba-2
layer's scan, launches ``csrc/ssd_scan.cu``.  Neither has a backward, as
the JAX package's Pallas kernels have none (``jax.grad`` through them
fails): both refuse, on every device, inputs that require grad while
grad mode is on, so that no training step silently drops the gradient
of what lies upstream of them.

A conv or GEMM weight with one more leading axis than the layer's own
(a stack of T trials' weight images: (T, KH, KW, Cin/G, Cout) or
(T, K, N)) takes the kernel's trial form (``qconv.qconv2d_trials``,
``qdwconv2d_trials``, ``qgconv2d_trials``, ``qgemm.qgemm_trials``): the
batch holds T trials of N rows each, trial t's rows against ``w[t]``,
one launch for all of them; what the JAX package's kernels become under
``jax.vmap`` in an SER campaign (``core/pipeline.py:vmap_trials``).

Conv pads are zero (the symmetric quantization zero-point) and go to
every route's wrapper with the unpadded input: the dense and grouped
kernels take them in their gathers, the depthwise kernel in its band
staging, so no conv input is padded on the card; max-pool pads take
INT8_MIN.

Inside :func:`recording`, every entry point of this module notes its
name and its number of tensor operands: what the static verifier's
executor probes (``core/verify.py:executor_trace``) read.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from . import flash_attention as _flash
from . import pool as _pool
from . import qconv as _qconv
from . import qgemm as _qgemm
from . import ref as ref
from . import ssd_scan as _ssd

_COUNTERS = (_qgemm.launches, _qconv.launches, _pool.launches,
             _flash.launches, _ssd.launches)


def launch_counts() -> Dict[str, int]:
    """Kernel launches of each wrapper since the last reset: each
    wrapper adds one where it launches its CUDA kernel, and nowhere
    else."""
    return {name: n for c in _COUNTERS for name, n in c.items()}


def reset_launch_counts() -> None:
    """Zero :func:`launch_counts`, ``qconv.gather_launches``,
    ``qconv.padded_launches`` and ``qconv.skip_launches``, and empty
    ``qconv.group_pack``."""
    for c in _COUNTERS + (_qconv.gather_launches, _qconv.padded_launches,
                          _qconv.skip_launches):
        for name in c:
            c[name] = 0
    _qconv.group_pack.clear()


#: The call lists of the :func:`recording` blocks now open.
_RECORDERS: List[List[Tuple[str, int]]] = []


@contextlib.contextmanager
def recording() -> Iterator[List[Tuple[str, int]]]:
    """Inside the block, every entry point of this module called appends
    ``(its name, its number of tensor operands)`` to the list the block
    yields (a list of tensors counts each).  Nothing is recorded outside
    such a block."""
    calls: List[Tuple[str, int]] = []
    _RECORDERS.append(calls)
    try:
        yield calls
    finally:
        _RECORDERS.remove(calls)


def _record(name: str, *operands) -> None:
    if not _RECORDERS:
        return
    n = sum(sum(torch.is_tensor(t) for t in v)
            if isinstance(v, (list, tuple)) else torch.is_tensor(v)
            for v in operands)
    for calls in _RECORDERS:
        calls.append((name, n))


def qgemm(x, w, b=None, *, shift, relu: bool = False,
          shift_vec: Optional[torch.Tensor] = None,
          w_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``shift`` is an int (per-tensor) or a length-N tuple (per-output-
    channel weight scales — the per-lane shift vector path), which
    ``shift_vec`` may carry staged on the card; ``w_k`` is ``w`` staged
    K-major (:func:`qgemm.stage_kmajor`).  A (T, K, N) weight stack takes
    the trial form (:func:`qgemm.qgemm_trials`)."""
    _record("qgemm", x, w, b, shift_vec, w_k)
    fn = _qgemm.qgemm_trials if w.ndim == 3 else _qgemm.qgemm
    return fn(x, w, b, shift=shift, relu=relu, shift_vec=shift_vec, w_k=w_k)


def _no_backward(name: str, *operands) -> None:
    """Raise when autograd would record through kernel ``name``."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in operands):
        raise RuntimeError(
            f"{name} has no backward (nor has the JAX package's Pallas "
            f"kernel): its inputs require grad.  Train with "
            f"attention_impl='chunked' or 'naive'; Model.loss runs the "
            f"SSD scan's plain version itself")


def _no_dtensor(name: str, *operands) -> None:
    """Raise ``TypeError`` for a DTensor operand: the kernels read raw
    data pointers of one device's tensor, so a sharded model hands them
    its local shards (``ShardingPolicy.local_attention``/``local_ssd``)."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in operands):
        raise TypeError(
            f"{name} takes plain tensors, not DTensors: run it on each "
            f"rank's local shards (ShardingPolicy.local_attention / "
            f"local_ssd)")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA flash attention: q (B, H, Sq, D), k/v (B, HKV, Skv, D); the
    scores are scaled by ``scale`` (default D ** -0.5).  A CUDA tensor
    launches the kernel, a CPU tensor runs the plain version
    (:mod:`.flash_attention`).  Raises ``RuntimeError`` for inputs that
    require grad while grad mode is on: there is no backward, and
    ``TypeError`` for a DTensor."""
    _no_dtensor("flash_attention", q, k, v)
    _no_backward("flash_attention", q, k, v)
    _record("flash_attention", q, k, v)
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, scale=scale)


def ssd_scan(x, dt, a, b, c, d=None, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """Mamba-2 chunked SSD scan: x (B, L, H, P), dt (B, L, H), a (H,),
    b/c (B, L, G, N); y, and the final state with ``return_state``.  A
    CUDA tensor launches the kernel, a CPU tensor runs the plain version
    (:mod:`.ssd_scan`).  Raises ``RuntimeError`` for inputs that require
    grad while grad mode is on: there is no backward, and ``TypeError``
    for a DTensor."""
    _no_dtensor("ssd_scan", x, dt, a, b, c, d, init_state)
    _no_backward("ssd_scan", x, dt, a, b, c, d, init_state)
    _record("ssd_scan", x, dt, a, b, c, d, init_state)
    return _ssd.ssd_scan(x, dt, a, b, c, d, chunk=chunk,
                         init_state=init_state, return_state=return_state)


# ------------------------------------------------------ NHWC-native paths

def conv_route(groups: int, cin: int, w_shape) -> str:
    """Which kernel a conv of ``groups`` over ``cin`` channels with an
    HWIO weight of ``w_shape`` takes: ``"dense"``, ``"depthwise"`` or
    ``"grouped"`` (see :func:`qconv2d_nhwc`)."""
    if groups == 1:
        return "dense"
    if groups == cin and w_shape[-1] % cin == 0 and w_shape[-2] == 1:
        return "depthwise"
    return "grouped"


def qconv2d_nhwc(
    x: torch.Tensor,  # (N, H, W, Cin) int8, unpadded
    w: torch.Tensor,  # (KH, KW, Cin/groups, Cout) int8 (HWIO)
    b: Optional[torch.Tensor],
    *,
    strides: Tuple[int, int] = (1, 1),
    pads: Tuple[int, int, int, int] = (0, 0, 0, 0),
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
    hi: int = ref.INT8_MAX,
) -> torch.Tensor:
    """Fused conv+requant+ReLU(+skip/concat)+pool.  Returns NHWC int8
    (post-pool when ``pool`` is given), or ``out_buf`` with this conv's
    channel slice written in place.

    Dispatch on ``groups`` (ONNX Conv semantics), as in the JAX package:
      * 1 — the dense kernel (:func:`qconv.qconv2d`);
      * Cin with an integer channel multiplier (Cout = m·Cin, 1×1
        filter slice) — depthwise (:func:`qconv.qdwconv2d`);
      * anything else (ragged groups) — :func:`qconv.qgconv2d`.

    ``shift`` is an int (per-tensor requant) or a length-Cout tuple
    (per-output-channel weight scales).  ``w_k`` (``w`` staged K-major,
    :func:`qconv.stage_kmajor`) and ``shift_vec`` (the per-lane shifts
    staged on the card) are what a built layer made once; without them
    a CUDA launch stages its own.  ``hi`` is the upper end of the
    requant's clamp: a fused ReLU-n's clamp code (DESIGN.md, "ReLU-n
    fixed-point rule"), 127 without one.  A (T, KH, KW, Cin/G, Cout)
    weight stack (``w_k`` (T, Cout, K_pad)) takes the route's trial form
    over an input of T*N images."""
    _record("qconv2d_nhwc", x, w, b, skip, out_buf, w_k, shift_vec)
    route = conv_route(groups, x.shape[-1], w.shape)
    trials = w.ndim == 5
    x = x.contiguous()
    kw = dict(strides=strides, pads=pads, shift=shift, relu=relu, pool=pool,
              shift_vec=shift_vec, hi=hi)
    if route == "grouped":
        if skip is not None or out_buf is not None:
            raise ValueError("merge fusion requires the dense or depthwise "
                             "conv")
        fn = _qconv.qgconv2d_trials if trials else _qconv.qgconv2d
        return fn(x, w, b, groups=groups, w_k=w_k, **kw)
    kw.update(skip=skip, skip_shifts=skip_shifts, merge_shift=merge_shift,
              merge_relu=merge_relu, out_buf=out_buf, out_off=out_off,
              concat_shift=concat_shift, concat_relu=concat_relu)
    if route == "depthwise":
        fn = _qconv.qdwconv2d_trials if trials else _qconv.qdwconv2d
        return fn(x, w, b, **kw)
    fn = _qconv.qconv2d_trials if trials else _qconv.qconv2d
    return fn(x, w, b, w_k=w_k, **kw)


def qadd_nhwc(xs, align_shifts, *, shift=0,
              relu: bool = False) -> torch.Tensor:
    """Residual-merge stage: align int8 operands to a common fixed-point
    position, add in int32, requantize back to int8."""
    _record("qadd_nhwc", xs)
    return ref.qadd_ref(xs, align_shifts, shift, relu)


def qconcat_nhwc(xs, align_shifts, *, axis: int = -1,
                 relu: bool = False) -> torch.Tensor:
    """Channel-merge stage: align each int8 operand to the common scale,
    then concatenate; ``relu`` is the merge's fused ReLU.  One definition
    of the merge semantics, shared with the conv's concat epilogue."""
    _record("qconcat_nhwc", xs)
    return ref.qconcat_ref(xs, align_shifts, axis=axis, relu=relu)


def maxpool2d_nhwc(x: torch.Tensor, window: int, stride: int,
                   pads: Tuple[int, int, int, int] = (0, 0, 0, 0)
                   ) -> torch.Tensor:
    """Standalone int8 NHWC max-pool; pads take INT8_MIN.  A CUDA tensor
    launches the kernel (:func:`pool.maxpool2d`), a CPU tensor runs the
    plain version."""
    _record("maxpool2d_nhwc", x)
    return _pool.maxpool2d(x, window, stride, pads)


def avgpool2d_nhwc(x: torch.Tensor, window: int, stride: int,
                   pads: Tuple[int, int, int, int] = (0, 0, 0, 0)
                   ) -> torch.Tensor:
    """Standalone int8 NHWC average-pool (AveragePool /
    GlobalAveragePool): int32 window sum, round-half-up divide by the
    real window population."""
    _record("avgpool2d_nhwc", x)
    return ref.avgpool2d_ref(x, window, stride, pads)


# -------------------------------------- ONNX-layout (NCHW) compatibility

def qconv2d_nchw(
    x: torch.Tensor,  # (N, Cin, H, W) int8
    w: torch.Tensor,  # (Cout, Cin, KH, KW) int8 (OIHW, ONNX layout)
    b: Optional[torch.Tensor],
    *,
    strides: Tuple[int, int] = (1, 1),
    pads: Tuple[int, int, int, int] = (0, 0, 0, 0),
    shift=0,
    relu: bool = True,
    pool: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """ONNX-layout wrapper around :func:`qconv2d_nhwc`.  Returns NCHW
    int8 (post-pool when ``pool`` is given)."""
    xh = x.permute(0, 2, 3, 1).contiguous()
    wh = w.permute(2, 3, 1, 0).contiguous()
    y = qconv2d_nhwc(xh, wh, b, strides=strides, pads=pads, shift=shift,
                     relu=relu, pool=pool)
    return y.permute(0, 3, 1, 2)


def maxpool2d_nchw(x: torch.Tensor, window: int, stride: int,
                   pads: Tuple[int, int, int, int] = (0, 0, 0, 0)
                   ) -> torch.Tensor:
    """ONNX-layout wrapper around :func:`maxpool2d_nhwc`."""
    return maxpool2d_nhwc(x.permute(0, 2, 3, 1), window, stride,
                          pads).permute(0, 3, 1, 2)


def avgpool2d_nchw(x: torch.Tensor, window: int, stride: int,
                   pads: Tuple[int, int, int, int] = (0, 0, 0, 0)
                   ) -> torch.Tensor:
    """ONNX-layout wrapper around :func:`avgpool2d_nhwc`."""
    return avgpool2d_nhwc(x.permute(0, 2, 3, 1), window, stride,
                          pads).permute(0, 3, 1, 2)

"""Mamba-2 SSD (state-space duality) chunked scan.

:func:`ssd_scan` launches the hand-written CUDA kernel
``csrc/ssd_scan.cu`` on a CUDA tensor and runs the plain version
:func:`ssd_scan_plain` on a CPU tensor.  It replaces the Pallas kernel
``src/repro/kernels/ssd_scan.py:ssd_scan`` and computes what the JAX
package's ``models/mamba2.py:ssd_chunked`` computes; the two differ only
in their interface, and this one takes both: an optional skip ``d``
(added before the cast, as the TPU kernel does), an optional initial
state and, on request, the final state (as ``ssd_chunked`` does).

The recurrence, per (batch, head), over a float32 (P, N) state:
``S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T``, ``y_t = S_t C_t + D x_t``,
taken in chunks whose decomposition is exact for any chunk length.  On
the card, bf16 inputs of at least :data:`CHUNKED_MIN_LEN` positions take
the chunk-parallel tensor-core path (three launches over a workspace this
wrapper allocates, at the caller's chunk where it is a multiple of 64 up
to 256); float32 inputs and shorter sequences (the decode step) take the
single-launch CUDA-core kernel, which walks 64-position tiles whatever
``chunk`` is.  See the note at the top of the source.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

#: Widest state (N) the kernel's shared-memory tiles hold.
MAX_STATE = 128
#: Shortest bf16 sequence that takes the chunk-parallel path; shorter
#: ones (the decode step, L = 1) keep the single launch and no workspace.
#: At mamba2-2.7b's widths the single launch is as fast up to L = 64 and
#: slower from 128 on (chip_smoke's ``ssd_scan_path_times``).
CHUNKED_MIN_LEN = 128
#: Launches of the kernel (plain-version calls are not counted).
launches = {"ssd_scan": 0}

_SIGNATURES = {
    "ssd_scan_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
    + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
    "ssd_scan_workspace_bytes": ([ctypes.c_int] * 6, ctypes.c_longlong),
}


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor,
                   d: Optional[torch.Tensor] = None, *, chunk: int = 128,
                   init_state: Optional[torch.Tensor] = None,
                   return_state: bool = False,
                   state_out: Optional[torch.Tensor] = None):
    """The kernel's semantics in plain PyTorch (any device), replaying
    the chunked arithmetic of the JAX package's ``ssd_chunked``: pad to a
    chunk multiple, float32 throughout, the exponent masked before the
    ``exp``, the intra-chunk ``(C B^T * exp(L_t - L_s) dt_s) x`` product,
    then the carried state chunk by chunk.  ``d`` adds ``d x`` before the
    single cast to x's dtype.  Returns y, or (y, final float32 state)
    with ``return_state`` (written into ``state_out`` when it is given).
    Float64 inputs are computed in float64 (the yardstick
    ``chip_smoke.py`` holds the float32 versions to)."""
    bsz, length, h, p = x.shape
    n = b.shape[3]
    grp = h // b.shape[2]
    q = min(chunk, length)
    pad = (-length) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    nc = (length + pad) // q
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(f).reshape(bsz, nc, q, h, p)
    dtf = dt.to(f).reshape(bsz, nc, q, h)
    bf = torch.repeat_interleave(b.to(f), grp, dim=2).reshape(
        bsz, nc, q, h, n)
    cf = torch.repeat_interleave(c.to(f), grp, dim=2).reshape(
        bsz, nc, q, h, n)

    logdec = torch.cumsum(dtf * a.to(f)[None, None, None, :], dim=2)
    idx = torch.arange(q, device=x.device)
    tri = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    diff = logdec[:, :, :, None, :] - logdec[:, :, None, :, :]  # (B,c,t,s,H)
    # mask BEFORE exp: masked entries have diff > 0 (logdec decreasing)
    diff = torch.where(tri, diff, 0.0)
    gmat = torch.where(tri, torch.exp(diff) * dtf[:, :, None, :, :], 0.0)
    del diff
    scores = torch.einsum("bcthn,bcshn->bctsh", cf, bf) * gmat
    del gmat
    y_intra = torch.einsum("bctsh,bcshp->bcthp", scores, xf)
    del scores

    # per-chunk boundary state and the carried recurrence
    tail = torch.exp(logdec[:, :, -1:, :] - logdec) * dtf       # (B,c,q,H)
    s_chunk = torch.einsum("bcqhp,bcqhn->bchpn", tail[..., None] * xf, bf)
    decay_chunk = torch.exp(logdec[:, :, -1, :])                # (B,c,H)
    s = (init_state.to(f) if init_state is not None else
         torch.zeros((bsz, h, p, n), dtype=f, device=x.device))
    s_prevs = []
    for ci in range(nc):
        s_prevs.append(s)
        s = decay_chunk[:, ci, :, None, None] * s + s_chunk[:, ci]
    y_inter = torch.exp(logdec)[..., None] * torch.einsum(
        "bcqhn,bchpn->bcqhp", cf, torch.stack(s_prevs, dim=1))

    y = (y_intra + y_inter).reshape(bsz, length + pad, h, p)[:, :length]
    if d is not None:
        y = y + d.to(f)[None, None, :, None] * xf.reshape(
            bsz, length + pad, h, p)[:, :length]
    y = y.to(x.dtype)
    if state_out is not None:
        s = state_out.copy_(s)
    return (y, s) if return_state or state_out is not None else y


def _launch(x, dt, a, b, c, d, chunk, init_state, return_state,
            state_out):
    """Check the operands of a CUDA launch and run the kernel into new
    outputs.  Every check comes before the device's, so a tensor on any
    device reports a bad operand first."""
    if x.ndim != 4 or dt.ndim != 3 or a.ndim != 1 or b.ndim != 4 \
            or c.shape != b.shape:
        raise ValueError(f"ssd_scan: x (B, L, H, P), dt (B, L, H), a (H,), "
                         f"b, c (B, L, G, N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bsz, length, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if tuple(dt.shape) != (bsz, length, h) or tuple(a.shape) != (h,) \
            or tuple(b.shape[:2]) != (bsz, length):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"ssd_scan: {h} heads over {g} B/C groups")
    if d is not None and tuple(d.shape) != (h,):
        raise ValueError(f"ssd_scan: d {tuple(d.shape)}, want ({h},)")
    if init_state is not None and tuple(init_state.shape) != (bsz, h, p, n):
        raise ValueError(f"ssd_scan: init_state {tuple(init_state.shape)}, "
                         f"want {(bsz, h, p, n)}")
    if state_out is not None and (
            tuple(state_out.shape) != (bsz, h, p, n)
            or state_out.dtype != torch.float32):
        raise ValueError(f"ssd_scan: state_out {tuple(state_out.shape)} "
                         f"{state_out.dtype}, want float32 {(bsz, h, p, n)}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan: state size {n} outside "
                         f"[1, {MAX_STATE}]")
    if length == 0 or p == 0:
        raise ValueError(f"ssd_scan: empty x {tuple(x.shape)}")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk}, want >= 1")
    if bsz > 65535 or h > 65535:
        raise ValueError(f"ssd_scan: batch {bsz} or {h} heads, more than "
                         f"a grid axis holds")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, b, c of one "
                        f"dtype, got {x.dtype}, {b.dtype}, {c.dtype}")
    f32 = [t for t in (dt, a, d, init_state, state_out) if t is not None]
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError(f"ssd_scan takes float32 dt, a, d, init_state, got "
                        f"{[t.dtype for t in f32]}")
    operands = [x, b, c] + f32
    if any(t.device != x.device for t in operands):
        raise ValueError(f"ssd_scan: operands on "
                         f"{sorted({str(t.device) for t in operands})}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("ssd_scan takes contiguous tensors")
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or the CPU, not {x.device}")
    y = torch.empty_like(x)
    state = state_out
    if state is None and return_state:
        state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                            device=x.device)
    lib = _build.load("ssd_scan", _SIGNATURES)
    bf16 = x.dtype == torch.bfloat16
    work = None
    if bf16 and length >= CHUNKED_MIN_LEN:
        work = torch.empty(
            lib.ssd_scan_workspace_bytes(bsz, length, h, p, n, chunk),
            dtype=torch.uint8, device=x.device)
    ptr = _build.ptr
    err = lib.ssd_scan_fwd(
        ptr(x), ptr(dt), ptr(a), ptr(b), ptr(c), ptr(d), ptr(init_state),
        ptr(y), ptr(state), int(bf16), bsz, length, h, p, g, n, chunk,
        ptr(work), 0 if work is None else work.numel(),
        _build.stream(x.device))
    _build.check(err, "ssd_scan")
    return (y, state) if state is not None else y


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             d: Optional[torch.Tensor] = None, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None,
             return_state: bool = False,
             state_out: Optional[torch.Tensor] = None):
    """Chunked SSD forward: x (B, L, H, P), dt (B, L, H) positive, a (H,)
    negative, b, c (B, L, G, N) with H a multiple of G, d (H,) optional.
    Returns y (B, L, H, P) in x's dtype, and the final float32 state
    (B, H, P, N) with ``return_state``; ``init_state`` (B, H, P, N) starts
    the recurrence (zeros without it); ``state_out`` (B, H, P, N), which
    may be ``init_state`` itself, receives the final state in place of a
    new tensor and implies ``return_state``.  On a CPU tensor this is the
    plain version; on a CUDA tensor it launches the kernel or raises."""
    kw = dict(init_state=init_state, return_state=return_state,
              state_out=state_out)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, d, chunk=chunk, **kw)
    out = _launch(x, dt, a, b, c, d, chunk, **kw)
    launches["ssd_scan"] += 1
    return out

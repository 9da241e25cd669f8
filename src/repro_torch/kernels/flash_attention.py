"""Blocked online-softmax (flash) attention over grouped-query heads.

:func:`flash_attention` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` on a CUDA tensor and runs the plain version
:func:`flash_attention_plain` on a CPU tensor.  It replaces the Pallas
kernel ``src/repro/kernels/flash_attention.py:flash_attention``.  On the
H100 causal prefill is bound by operations (about 0.1 TFLOP a layer at
qwen2-1.5b's shapes against 59 MB of operands).  A bfloat16 call runs on
the tensor cores: a producer warp feeds 128-key K/V tiles through a
two-stage ring of TMA copies, and two warpgroups take 64 query rows each
with ``wgmma`` for Q·Kᵀ and for P·V, P split into two bf16 halves so that
it keeps the plain version's float32 weights within one bf16 ulp.  A
float32 call runs the first kernel of the port, on the CUDA cores.  The
note at the top of the source gives both designs.

Both versions compute what the TPU kernel computes, including its value
for a row that sees no key: the finite ``-1e30`` sentinel makes every
entry of such a row weigh 1, padding included, so the row comes out as
``sum(v[:Skv]) / Skv_padded`` (``Skv_padded`` is Skv rounded up to the
KV block ``min(block_k, rup(Skv, 128))``), not 0 and not the mean.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
#: Widest head the kernels' tiles hold.
MAX_HEAD_DIM = 128
#: Launches of the kernel (plain-version calls are not counted).
launches = {"flash_attention": 0}

_SIGNATURES = {"flash_attention_fwd": [ctypes.c_void_p] * 4
               + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 4
               + [ctypes.c_float, ctypes.c_void_p]}


def _rup(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def masked_row_divisor(skv: int, block_k: int = 128) -> int:
    """What the TPU kernel divides a row that sees no key by: its KV
    length padded to its KV block."""
    return _rup(skv, min(block_k, _rup(skv, 128)))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          scale: Optional[float] = None,
                          block_k: int = 128) -> torch.Tensor:
    """The kernel's semantics in plain PyTorch (any device), replaying
    the TPU kernel's blocked arithmetic: K/V zero-padded to the KV block,
    float32 scores, the ``-1e30`` sentinel for masked entries, one
    online-softmax update per KV block, then ``acc / l`` in q's dtype.
    Query rows are independent, so the TPU kernel's query blocking has
    no effect on the result and is not replayed."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d ** -0.5 if scale is None else scale
    bk = min(block_k, _rup(skv, 128))
    pad = _rup(skv, bk) - skv
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    # query head h reads KV head h // g: group the query heads per KV head
    qf = q.float().reshape(b, hkv, g, sq, d)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, g, sq, 1), NEG_INF, device=q.device)
    l_ = torch.zeros((b, hkv, g, sq, 1), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    for k0 in range(0, skv + pad, bk):
        kb = kp[:, :, None, k0:k0 + bk]                  # (b, hkv, 1, bk, d)
        vb = vp[:, :, None, k0:k0 + bk]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        kpos = k0 + torch.arange(bk, device=q.device)[None, :]
        mask = kpos < skv
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_ = l_ * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb)
        m = m_new
    l_ = torch.where(l_ == 0.0, torch.ones_like(l_), l_)
    return (acc / l_).reshape(b, h, sq, d).to(q.dtype)


def _launch(q, k, v, *, causal, window, q_offset, scale,
            block_k) -> torch.Tensor:
    """Check the operands of a CUDA launch and run the kernel into a new
    output.  Every check comes before the device's, so a tensor on any
    device reports a bad operand first."""
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B, H, Sq, D) and k, v "
                         f"(B, HKV, Skv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"group over k, v {tuple(k.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if skv == 0:
        raise ValueError("flash_attention: no keys (Skv == 0)")
    if b * h > 65535:
        raise ValueError(f"flash_attention: {b * h} (batch, head) pairs, "
                         f"more than a grid axis holds")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if q_offset < 0 or block_k < 1:
        raise ValueError(f"flash_attention: q_offset {q_offset}, block_k "
                         f"{block_k}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention: operands on {t.device} and "
                             f"{q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    o = torch.empty_like(q)
    lib = _build.load("flash_attention", _SIGNATURES)
    p = _build.ptr
    err = lib.flash_attention_fwd(
        p(q), p(k), p(v), p(o), int(q.dtype == torch.bfloat16), b, h, hkv,
        sq, skv, d, float(d ** -0.5 if scale is None else scale),
        int(causal), int(window is not None),
        int(window) if window is not None else 0, int(q_offset),
        float(masked_row_divisor(skv, block_k)), _build.stream(q.device))
    _build.check(err, "flash_attention")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, scale: Optional[float] = None,
                    block_k: int = 128) -> torch.Tensor:
    """Attention of q (B, H, Sq, D) over k, v (B, HKV, Skv, D), H a
    multiple of HKV; returns (B, H, Sq, D) in q's dtype.  ``q_offset`` is
    the absolute position of q's first row; key j is visible to row i iff
    j < Skv, j <= q_offset + i when ``causal``, and j > q_offset + i -
    window with a ``window``.  ``block_k`` matters only to rows that see
    no key (see the module docstring).  On a CPU tensor this is the plain
    version; on a CUDA tensor it launches the kernel or raises."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale,
              block_k=block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    o = _launch(q, k, v, **kw)
    launches["flash_attention"] += 1
    return o

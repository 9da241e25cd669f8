"""Mamba-2 block (state-space duality), in PyTorch.

The counterpart of ``repro.models.mamba2``.  Prefill and decode both go
through :func:`ssd_chunked`, which calls ``ops.ssd_scan``: the
hand-written CUDA kernel on a CUDA tensor, its plain version on a CPU
tensor.  The kernel has no backward (nor has the JAX package's), so the
training loss passes ``train=True`` and the scan runs the plain version,
the JAX package's jnp ``ssd_chunked`` arithmetic, under autograd.  Decode (L = 1) keeps the (H, P, N) float32 SSM state and the
(K-1)-deep causal conv states: constant memory per sequence.

Weights are stored per component (z / x / B / C / dt) under the JAX
package's parameter names, so a parameter tree converts key for key.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from . import layers as L

State = Dict[str, torch.Tensor]


class Mamba2(nn.Module):
    """A Mamba-2 block's parameters: projections ``w_z``, ``w_x`` (d,
    d_inner), ``w_b``, ``w_c`` (d, G N), ``w_dt`` (d, H), ``w_out``
    (d_inner, d); depthwise conv taps ``conv_x``/``conv_b``/``conv_c``
    (K, C) and biases ``conv_bias_*``; float32 ``a_log``, ``dt_bias``,
    ``d_skip`` (H,) and ``gate_norm`` (d_inner,)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        gns, nh = cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_nheads
        ck = cfg.ssm_conv_kernel
        dt = L.dtype_of(cfg)
        f32 = torch.float32
        self.w_z = L._param((d, di), dt, device)
        self.w_x = L._param((d, di), dt, device)
        self.w_b = L._param((d, gns), dt, device)
        self.w_c = L._param((d, gns), dt, device)
        self.w_dt = L._param((d, nh), dt, device)
        self.conv_x = L._param((ck, di), dt, device)
        self.conv_b = L._param((ck, gns), dt, device)
        self.conv_c = L._param((ck, gns), dt, device)
        self.conv_bias_x = L._param((di,), dt, device)
        self.conv_bias_b = L._param((gns,), dt, device)
        self.conv_bias_c = L._param((gns,), dt, device)
        self.a_log = L._param((nh,), f32, device)
        self.dt_bias = L._param((nh,), f32, device)
        self.d_skip = L._param((nh,), f32, device)
        self.gate_norm = L._param((di,), f32, device)
        self.w_out = L._param((di, d), dt, device)


def init_mamba2(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> Mamba2:
    """The JAX package's distributions: normal projections * d ** -0.5
    (``w_out`` * d_inner ** -0.5), ``conv_x`` normal * 0.1, and zeros for
    ``conv_b``, ``conv_c`` and every conv bias, so that B and C, and with
    them the SSD term, are 0 until those weights are set."""
    p = Mamba2(cfg, device)
    s = cfg.d_model ** -0.5
    for w in (p.w_z, p.w_x, p.w_b, p.w_c, p.w_dt):
        L.fill_normal_(w, s, gen)
    L.fill_normal_(p.conv_x, 0.1, gen)
    for w in (p.conv_b, p.conv_c, p.conv_bias_x, p.conv_bias_b,
              p.conv_bias_c, p.dt_bias):
        w.zero_()
    p.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, cfg.ssm_nheads,
                                           device=p.a_log.device)))
    p.d_skip.fill_(1.0)
    p.gate_norm.fill_(1.0)
    L.fill_normal_(p.w_out, cfg.d_inner ** -0.5, gen)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B, L, C); w: (K, C).  ``state`` is
    the trailing K-1 inputs of the previous call (decode).  Taps are
    summed in the JAX package's order, one product at a time."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xx = torch.cat([state, x], dim=1)                 # (B, L+K-1, C)
    length = x.shape[1]
    out = xx[:, 0:length] * w[0]
    for i in range(1, k):
        out = out + xx[:, i:i + length] * w[i]
    new_state = xx[:, -(k - 1):] if k > 1 else state
    return out + b, new_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: x (B,L,H,P) dt (B,L,H) a (H,) b/c (B,L,G,N) ->
    (y in x's dtype, final float32 state), through ``ops.ssd_scan``; with
    ``train``, through its plain version on any device, which autograd
    differentiates."""
    if train:
        return ssd_scan_plain(x, dt, a, b, c, chunk=chunk,
                              init_state=init_state, return_state=True)
    return ops.ssd_scan(x.contiguous(), dt.contiguous(), a, b.contiguous(),
                        c.contiguous(), None, chunk=chunk,
                        init_state=init_state, return_state=True)


def mamba2_forward(cfg: ModelConfig, p: Mamba2, u: torch.Tensor,
                   init_state: Optional[State] = None,
                   return_state: bool = False, train: bool = False,
                   policy=None):
    """Full block: proj -> causal conv -> SSD -> gated norm -> out_proj.
    u: (B, L, D).  Returns y, and the new state when requested.
    ``train`` picks the SSD scan's differentiable plain version.  Under
    a sharding ``policy`` x and z take ``policy.mamba_inner`` (d_inner on
    the model axis) and the scan runs on each rank's heads
    (``policy.local_ssd``)."""
    bsz, length, _ = u.shape
    nh, hp = cfg.ssm_nheads, cfg.ssm_headdim
    g, ns = cfg.ssm_ngroups, cfg.ssm_state
    z = u @ p.w_z
    x = u @ p.w_x
    bmat = u @ p.w_b
    cmat = u @ p.w_c
    dtr = u @ p.w_dt
    if policy is not None:
        x, z = policy.mamba_inner(x), policy.mamba_inner(z)

    st = init_state or {}
    x, new_cx = _causal_conv(x, p.conv_x, p.conv_bias_x, st.get("conv_x"))
    bmat, new_cb = _causal_conv(bmat, p.conv_b, p.conv_bias_b,
                                st.get("conv_b"))
    cmat, new_cc = _causal_conv(cmat, p.conv_c, p.conv_bias_c,
                                st.get("conv_c"))
    x, bmat, cmat = F.silu(x), F.silu(bmat), F.silu(cmat)

    dt = F.softplus(dtr.float() + p.dt_bias)                     # (B,L,H)
    a = -torch.exp(p.a_log)                                      # (H,)
    if policy is not None:
        x = policy.heads_ready(x, nh)
    xh = x.reshape(bsz, length, nh, hp)
    bh = bmat.reshape(bsz, length, g, ns)
    ch = cmat.reshape(bsz, length, g, ns)
    if policy is None:
        y, s_fin = ssd_chunked(xh, dt, a, bh, ch, cfg.ssm_chunk,
                               st.get("ssm"), train)
    else:
        y, s_fin = policy.local_ssd(
            lambda *args: ssd_chunked(*args[:5], cfg.ssm_chunk, args[5],
                                      train), xh, dt, a, bh, ch,
            st.get("ssm"))
    y = y + p.d_skip[None, None, :, None] * xh.float()
    y = y.reshape(bsz, length, cfg.d_inner).to(u.dtype)

    # gated RMSNorm (mamba2's norm_before_gate=False style)
    yf = y.float() * F.silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + cfg.norm_eps) * p.gate_norm
    out = yf.to(u.dtype) @ p.w_out
    if return_state:
        return out, {"conv_x": new_cx, "conv_b": new_cb, "conv_c": new_cc,
                     "ssm": s_fin}
    return out


def mamba2_decode_step(cfg: ModelConfig, p: Mamba2, u: torch.Tensor,
                       state: State, policy=None) -> Tuple[torch.Tensor, State]:
    """One-token recurrent step.  u: (B, 1, D).  Writes the new conv and
    SSM states into ``state``'s tensors in place and returns ``state``
    (the JAX package returns a new state): a layer's cache slices are
    views of the stacked cache, so the cache needs no copy a step.
    Under a policy each new state is laid out as its cache first."""
    out, new = mamba2_forward(cfg, p, u, init_state=state, return_state=True,
                              policy=policy)
    for key, v in new.items():
        if policy is not None:
            v = v.redistribute(state[key].device_mesh, state[key].placements)
        state[key].copy_(v)
    return out, state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> State:
    """Zero decode state: conv states (B, K-1, C) in ``dtype``, the SSM
    state (B, H, P, N) in float32."""
    k = cfg.ssm_conv_kernel - 1
    gns = cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv_x": torch.zeros((batch, k, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_b": torch.zeros((batch, k, gns), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, k, gns), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }

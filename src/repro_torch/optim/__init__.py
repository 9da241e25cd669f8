"""Optimizers, in PyTorch: AdamW with float32 master weights and
global-norm clipping, SGD-momentum, and the train-state plumbing the
launcher uses.

The counterpart of ``repro.optim``, with its arithmetic: the warm-up
``lr * min((step + 1) / warmup, 1)``; every gradient cast to float32 and
clipped by the global norm; AdamW's ``mhat / (sqrt(vhat) + eps) + wd *
p`` on every leaf, norms and biases included; the masters float32 and
never the parameters themselves; the new parameters ``master`` cast to
each parameter's dtype.  The JAX package's step returns a new state into
donated buffers; here the state's tensors are updated in place
(``torch._foreach_*`` over groups of leaves).  ``torch.optim.AdamW`` is
not used: its decay and its parameter groups differ.

A train state is ``{"params": LMParams (requires grad), "opt":
{"master", "mu"[, "nu"]}, "step": int}``, each optimizer entry a dict of
float32 tensors keyed by the parameter's name in
``params.named_parameters()``; the launcher adds ``"ef"`` for int8
gradient compression.  ``convert.train_state_to_numpy`` gives it the
JAX package's layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

Named = Dict[str, torch.Tensor]

#: Elements of float32 state updated per group of leaves: bounds the
#: temporaries of one group (two float32 copies) to 2 GiB.
GROUP_ELEMENTS = 1 << 28


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def schedule(cfg: OptimizerConfig, step) -> float:
    """The learning rate of ``step``, in float32 as the JAX package
    computes it: ``(step + 1) / warmup`` so that step 0 trains at
    lr / warmup, not at zero."""
    f32 = np.float32
    warm = np.minimum((f32(int(step)) + f32(1.0))
                      / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    return float(f32(cfg.lr) * warm)


def init_opt_state(params: torch.nn.Module, cfg: OptimizerConfig) -> Dict:
    """Float32 masters (copies, even of float32 parameters) and zero
    moments, keyed by parameter name."""
    master = {n: p.detach().to(torch.float32, copy=True)
              for n, p in params.named_parameters()}
    state = {"master": master,
             "mu": {n: torch.zeros_like(m) for n, m in master.items()}}
    if cfg.name != "sgd":
        state["nu"] = {n: torch.zeros_like(m) for n, m in master.items()}
    return state


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of all the tensors together, each taken in float32."""
    if not tensors:
        return torch.zeros(())
    return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32)
                        for t in tensors]).square().sum().sqrt()


def clip_factor(grads: List[torch.Tensor], max_norm: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``min(1, max_norm / norm)``, the grads' global norm): the factor
    that clips them to ``max_norm``."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0), norm


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The grads scaled by ``min(1, max_norm / norm)``, and the norm."""
    factor, norm = clip_factor(grads, max_norm)
    return torch._foreach_mul(grads, factor), norm


def _groups(names: List[str], sizes: Dict[str, int]):
    """``names`` in consecutive groups of at most GROUP_ELEMENTS (a leaf
    larger than that is a group of its own)."""
    group, total = [], 0
    for n in names:
        if group and total + sizes[n] > GROUP_ELEMENTS:
            yield group
            group, total = [], 0
        group.append(n)
        total += sizes[n]
    if group:
        yield group


@torch.no_grad()
def apply_update(params: torch.nn.Module, grads: Named, opt_state: Dict,
                 step, cfg: OptimizerConfig
                 ) -> Tuple[torch.nn.Module, Dict, Dict[str, Any]]:
    """One optimizer step, in place: ``params`` (the compute-dtype
    copies) take the new masters' values.  ``grads`` maps parameter names
    to gradients of any float dtype; they are cast to float32 and clipped
    a group at a time, and left unchanged.  Returns (params, opt_state,
    metrics) with ``grad_norm`` (a 0-d float32 tensor) and ``lr``."""
    named = dict(params.named_parameters())
    names = list(named)
    factor, gnorm = clip_factor([grads[n] for n in names], cfg.clip_norm)
    lr = schedule(cfg, step)
    f32 = np.float32
    t = f32(int(step) + 1)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(f32(1) - f32(b1) ** t)
    bc2 = float(f32(1) - f32(b2) ** t)
    master, mu = opt_state["master"], opt_state["mu"]
    sizes = {n: master[n].numel() for n in names}
    for group in _groups(names, sizes):
        p = [master[n] for n in group]
        m = [mu[n] for n in group]
        g = torch._foreach_mul([grads[n].float() for n in group], factor)
        if cfg.name == "sgd":
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g)
            upd = torch._foreach_mul(p, cfg.weight_decay)
            torch._foreach_add_(upd, m)
        else:
            v = [opt_state["nu"][n] for n in group]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(
                torch._foreach_mul(g, 1 - b2), g))
            del g
            upd = torch._foreach_div(m, bc1)
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, cfg.eps)
            torch._foreach_div_(upd, den)
            del den
            torch._foreach_add_(upd, torch._foreach_mul(p, cfg.weight_decay))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(p, upd)
        del upd
        torch._foreach_copy_([named[n] for n in group], p)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def value_and_grad(loss_fn: Callable, params: torch.nn.Module,
                   batch: Dict[str, Any]) -> Tuple[torch.Tensor, Named]:
    """``loss_fn(params, batch)`` and its gradient by parameter name (a
    parameter the loss does not reach gets zeros, as ``jax.grad`` gives).
    The parameters' ``.grad`` are left empty."""
    for p in params.parameters():
        p.grad = None
    loss = loss_fn(params, batch)
    loss.backward()
    grads = {}
    for n, p in params.named_parameters():
        grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    return loss.detach(), grads


def make_train_step(model, opt_cfg: OptimizerConfig, compression=None,
                    n_micro: int = 1) -> Callable:
    """The train step: loss -> grads (accumulated over ``n_micro``
    microbatches) -> optional ``compression(grads)`` -> clip -> update.
    ``train_step(state, batch)`` updates ``state`` in place and returns
    (state, metrics) with ``loss``, ``grad_norm`` and ``lr``."""
    if n_micro > 1:
        from repro_torch.distributed import make_accumulating_step
        grad_fn = make_accumulating_step(model.loss, n_micro)
    else:
        def grad_fn(params, batch):
            return value_and_grad(model.loss, params, batch)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        loss, grads = grad_fn(state["params"], batch)
        if compression is not None:
            grads = compression(grads)
        _, _, metrics = apply_update(state["params"], grads, state["opt"],
                                     state["step"], opt_cfg)
        del grads
        state["step"] += 1
        return state, dict(metrics, loss=loss)

    return train_step


def init_train_state(model, gen: torch.Generator,
                     opt_cfg: OptimizerConfig) -> Dict[str, Any]:
    """Random parameters from ``gen`` made trainable, their optimizer
    state, and step 0."""
    params = model.init(gen).requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params, opt_cfg),
            "step": 0}

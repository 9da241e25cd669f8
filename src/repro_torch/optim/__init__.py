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

Under a sharding policy (``model.policy``) the parameters are DTensors
and the optimizer state is laid out by ``policy.optimizer_spec`` (ZeRO-1:
each float32 leaf also sharded on the data axis); the update runs the
same arithmetic on each rank's shards (:func:`apply_update_sharded`) and
gathers the new values into the parameters' own layout.

A train state is ``{"params": LMParams (requires grad), "opt":
{"master", "mu"[, "nu"]}, "step": int}``, each optimizer entry a dict of
float32 tensors keyed by the parameter's name in
``params.named_parameters()``; the launcher adds ``"ef"`` for int8
gradient compression.  ``convert.train_state_to_numpy`` gives it the
JAX package's layout.
"""
from __future__ import annotations

import dataclasses
import math
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


def _bias_corrections(cfg: OptimizerConfig, step) -> Tuple[float, float]:
    f32 = np.float32
    t = f32(int(step) + 1)
    return (float(f32(1) - f32(cfg.beta1) ** t),
            float(f32(1) - f32(cfg.beta2) ** t))


def _step_group(cfg: OptimizerConfig, p: List[torch.Tensor],
                m: List[torch.Tensor], v, g: List[torch.Tensor], lr: float,
                bc1: float, bc2: float) -> None:
    """One step of the float32 masters ``p`` and moments ``m``/``v``, in
    place, from the clipped float32 gradients ``g`` (consumed)."""
    b1, b2 = cfg.beta1, cfg.beta2
    if cfg.name == "sgd":
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g)
        upd = torch._foreach_mul(p, cfg.weight_decay)
        torch._foreach_add_(upd, m)
    else:
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
    bc1, bc2 = _bias_corrections(cfg, step)
    master, mu = opt_state["master"], opt_state["mu"]
    sizes = {n: master[n].numel() for n in names}
    for group in _groups(names, sizes):
        p = [master[n] for n in group]
        m = [mu[n] for n in group]
        v = [opt_state["nu"][n] for n in group] if "nu" in opt_state else None
        _step_group(cfg, p, m, v, torch._foreach_mul(
            [grads[n].float() for n in group], factor), lr, bc1, bc2)
        torch._foreach_copy_([named[n] for n in group], p)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


# ------------------------------------------------------------ sharded step

def optimizer_specs(params: torch.nn.Module, policy) -> Dict[str, Any]:
    """{name: spec} of the optimizer state of each parameter under
    ``policy``: its parameter spec, ZeRO-1 sharded on the data axis."""
    pspecs = policy.param_specs(params)
    return {n: policy.optimizer_spec(pspecs[n], tuple(p.shape))
            for n, p in params.named_parameters()}


def init_opt_state_sharded(params: torch.nn.Module, cfg: OptimizerConfig,
                           policy) -> Dict:
    """:func:`init_opt_state` of DTensor parameters, every leaf laid out
    by :func:`optimizer_specs` (no data moves: each rank keeps its
    shard)."""
    specs = optimizer_specs(params, policy)
    master = {n: policy.distribute(p.detach().to(torch.float32, copy=True),
                                   specs[n])
              for n, p in params.named_parameters()}
    state = {"master": master,
             "mu": {n: torch.zeros_like(m) for n, m in master.items()}}
    if cfg.name != "sgd":
        state["nu"] = {n: torch.zeros_like(m) for n, m in master.items()}
    return state


def _sharded_norm(local: List[torch.Tensor], specs: List[Any],
                  policy) -> torch.Tensor:
    """The global 2-norm of tensors given as this rank's shards (laid
    out by ``specs``): :func:`global_norm` of the shards on a mesh of one
    rank; else each tensor's sum of squares summed over the ranks that
    hold its distinct shards."""
    if math.prod(policy.axis_sizes.values()) == 1:
        return global_norm(local)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.sharding import placements
    norms = []
    for t, spec in zip(local, specs):
        sq = torch.linalg.vector_norm(t, dtype=torch.float32).square()
        pls = [Partial() if isinstance(p, Shard) else Replicate()
               for p in placements(spec, policy.mesh)]
        norms.append(DTensor.from_local(sq, policy.mesh, pls,
                                        run_check=False).full_tensor().sqrt())
    return torch.stack(norms).square().sum().sqrt()


@torch.no_grad()
def apply_update_sharded(params: torch.nn.Module, grads: Named,
                         opt_state: Dict, step, cfg: OptimizerConfig, policy
                         ) -> Tuple[torch.nn.Module, Dict, Dict[str, Any]]:
    """:func:`apply_update` of DTensor parameters, in place: each
    gradient is laid out as its optimizer state (a reduce-scatter where
    it is a pending sum), clipped by the global norm of all of them, the
    masters and moments of each rank's shards step, and every parameter
    takes its new master gathered into its own layout."""
    from repro_torch.sharding import from_local, to_local
    named = dict(params.named_parameters())
    names = list(named)
    specs = optimizer_specs(params, policy)
    mesh = policy.mesh
    g_loc = {n: to_local(grads[n], mesh, specs[n]) for n in names}
    gnorm = _sharded_norm([g_loc[n] for n in names],
                          [specs[n] for n in names], policy)
    factor = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                         max=1.0)
    lr = schedule(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step)
    local = {k: {n: t.to_local() for n, t in opt_state[k].items()}
             for k in opt_state}
    sizes = {n: local["master"][n].numel() for n in names}
    for group in _groups(names, sizes):
        p = [local["master"][n] for n in group]
        m = [local["mu"][n] for n in group]
        v = [local["nu"][n] for n in group] if "nu" in local else None
        _step_group(cfg, p, m, v, torch._foreach_mul(
            [g_loc[n].float() for n in group], factor), lr, bc1, bc2)
        for n, pn in zip(group, p):
            new = from_local(pn, mesh, specs[n]).redistribute(
                mesh, named[n].placements).to_local()
            named[n].to_local().copy_(new)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def value_and_grad(loss_fn: Callable, params: torch.nn.Module,
                   batch: Dict[str, Any]) -> Tuple[torch.Tensor, Named]:
    """``loss_fn(params, batch)`` and its gradient by parameter name (a
    parameter the loss does not reach gets zeros, as ``jax.grad`` gives).
    The parameters' ``.grad`` are left empty.  A DTensor loss (a model
    under a sharding policy) runs its backward pass with plain tensors
    taken as replicated, as its forward pass did."""
    for p in params.parameters():
        p.grad = None
    loss = loss_fn(params, batch)
    from repro_torch.sharding import is_dtensor
    if is_dtensor(loss):
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            loss.backward()
    else:
        loss.backward()
    grads = {}
    for n, p in params.named_parameters():
        grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    return loss.detach(), grads


def make_train_step(model, opt_cfg: OptimizerConfig, compression=None,
                    n_micro: int = 1, zero2_grads: bool = False) -> Callable:
    """The train step: loss -> grads (accumulated over ``n_micro``
    microbatches) -> optional ``compression(grads)`` -> clip -> update.
    ``train_step(state, batch)`` updates ``state`` in place and returns
    (state, metrics) with ``loss``, ``grad_norm`` and ``lr``.  Under the
    model's sharding policy the update is :func:`apply_update_sharded`;
    with ``zero2_grads`` the microbatch gradients accumulate in the
    optimizer state's layout (ZeRO-2)."""
    policy = getattr(model, "policy", None)
    if n_micro > 1:
        from repro_torch.distributed import make_accumulating_step
        grad_fn = make_accumulating_step(model.loss, n_micro, policy,
                                         zero2_grads)
    else:
        def grad_fn(params, batch):
            return value_and_grad(model.loss, params, batch)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        loss, grads = grad_fn(state["params"], batch)
        if compression is not None:
            grads = compression(grads)
        if policy is None:
            _, _, metrics = apply_update(state["params"], grads,
                                         state["opt"], state["step"], opt_cfg)
        else:
            _, _, metrics = apply_update_sharded(
                state["params"], grads, state["opt"], state["step"], opt_cfg,
                policy)
        del grads
        state["step"] += 1
        return state, dict(metrics, loss=loss)

    return train_step


def init_train_state(model, gen: torch.Generator,
                     opt_cfg: OptimizerConfig) -> Dict[str, Any]:
    """Random parameters from ``gen`` made trainable, their optimizer
    state (laid out by ``optimizer_specs`` under the model's sharding
    policy), and step 0."""
    params = model.init(gen).requires_grad_(True)
    policy = getattr(model, "policy", None)
    opt = (init_opt_state(params, opt_cfg) if policy is None
           else init_opt_state_sharded(params, opt_cfg, policy))
    return {"params": params, "opt": opt, "step": 0}

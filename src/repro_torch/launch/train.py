"""Fault-tolerant training driver, in PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen2-1.5b --preset smoke --steps 200 \\
        --ckpt-dir /tmp/run1 --ckpt-every 50 [--device cpu]

The counterpart of ``repro.launch.train``, with its flags and its loop:
  * resume from the latest checkpoint on start (the JAX package's
    on-disk format: either package resumes the other's run);
  * async checkpoints and a SIGTERM preemption hook;
  * a straggler monitor (sustained outliers trigger an early snapshot);
  * step-keyed deterministic data (resume == replay);
  * optional int8 gradient compression with error feedback;
  * the train state updated in place (the donated state of the JAX
    package's jitted step).

It runs on one card, CUDA unless ``--device`` names another.  On a
mesh (``--mesh production``, the 16 x 16 pod, or ``--mesh host
--data-par D --model-par M`` over the ranks that exist; also any run
under ``torchrun``) it starts the process world (NCCL on CUDA, gloo on
the CPU), lays the parameters and the ZeRO-1 optimizer state out by a
``ShardingPolicy``, and every rank takes its rows of each step's batch:

    torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch qwen2-1.5b --preset full --data-par 2 --model-par 4

Checkpoints gather the sharded state to full tensors, which rank 0
writes in the same byte format; a restore lays each rank's shards out
again.  A gather is collective, so on a mesh the ranks agree after
every step on whether to snapshot: a straggler snapshot or a SIGTERM
seen by any rank makes every rank save (and, after a SIGTERM, stop).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import types
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import configs, convert
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.distributed import (StragglerMonitor, ef_compress,
                                     init_error_feedback)
from repro_torch.models.model import Model
from repro_torch.optim import (OptimizerConfig, init_train_state,
                               make_train_step)


def _on_a_mesh(args) -> bool:
    return (args.mesh == "production" or args.data_par * args.model_par > 1
            or "WORLD_SIZE" in os.environ)


def build(args) -> Dict[str, Any]:
    cfg = (configs.get_smoke(args.arch) if args.preset == "smoke"
           else configs.get(args.arch))
    mesh = policy = None
    if _on_a_mesh(args):
        from repro_torch import device as tdevice
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.sharding import PolicyOptions, ShardingPolicy
        dev = tdevice.resolve(args.device)
        mesh_mod.init_world("nccl" if dev.type == "cuda" else "gloo")
        try:
            mesh = (mesh_mod.make_production_mesh()
                    if args.mesh == "production" else
                    mesh_mod.make_host_mesh(args.data_par, args.model_par))
        except Exception:
            mesh_mod.destroy_world()
            raise
        policy = ShardingPolicy(mesh, cfg, PolicyOptions(remat=args.remat))
    model = Model(cfg, args.device, remat=args.remat, policy=policy)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=args.warmup)
    return dict(cfg=cfg, mesh=mesh, policy=policy, model=model,
                opt_cfg=opt_cfg)


def _gathered(state: Dict[str, Any]) -> Dict[str, Any]:
    """A sharded train state with full tensors (every rank takes part in
    the gathers), as ``convert.train_state_to_tree`` reads one."""
    from repro_torch.sharding import is_dtensor

    def full(t):
        return t.full_tensor() if is_dtensor(t) else t
    named = {n: full(p.detach())
             for n, p in state["params"].named_parameters()}
    out = dict(state, opt={k: {n: full(t) for n, t in v.items()}
                           for k, v in state["opt"].items()})
    # what convert.train_state_to_tree reads of the params
    out["params"] = types.SimpleNamespace(
        named_parameters=lambda: iter(named.items()))
    return out


def _any_rank(flags, device) -> list:
    """Each of ``flags`` (bools) OR-ed over the ranks of the world: one
    all-reduce, so every rank takes the same branch."""
    t = torch.tensor([int(f) for f in flags], dtype=torch.int32,
                     device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


def _full_skeleton(cfg, state: Dict[str, Any]) -> Dict[str, Any]:
    """A train state of full, uninitialised CPU tensors with the layout
    of the sharded ``state``: what a checkpoint restores into."""
    params = Model(cfg, "cpu").empty_params()
    opt = {k: {n: torch.empty(tuple(t.shape), dtype=t.dtype)
               for n, t in v.items()} for k, v in state["opt"].items()}
    return {"params": params, "opt": opt, "step": 0}


def _scatter_into(state: Dict[str, Any], full_state: Dict[str, Any],
                  policy) -> None:
    """Fill a sharded train state's shards from a full one."""
    from repro_torch.sharding import spec_of

    def put(dst, src):
        with torch.no_grad():
            dst.to_local().copy_(policy.distribute(
                src.to(dst.to_local().device), spec_of(dst)).to_local())
    for n, p in state["params"].named_parameters():
        put(p, dict(full_state["params"].named_parameters())[n])
    for k, v in state["opt"].items():
        for n, t in v.items():
            put(t, full_state["opt"][k][n])
    state["step"] = full_state["step"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--mesh", default="host", choices=["host", "production"])
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' asks for "
                         "the CPU)")
    args = ap.parse_args(argv)

    parts = build(args)
    cfg, model, opt_cfg = parts["cfg"], parts["model"], parts["opt_cfg"]
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed)
    source = make_source(data_cfg)

    state = init_train_state(
        model, torch.Generator(model.device).manual_seed(args.seed), opt_cfg)
    compression = None
    if args.grad_compression == "int8_ef":
        state["ef"] = init_error_feedback(state["params"])

        def compression(grads):
            grads, state["ef"] = ef_compress(grads, state["ef"])
            return grads
    step_fn = make_train_step(model, opt_cfg, compression)

    policy = parts["policy"]
    if policy is not None and args.grad_compression != "none":
        raise ValueError("--grad-compression runs on the single-card "
                         "path; a mesh's gradients are reduced by DTensor")
    rank0 = policy is None or torch.distributed.get_rank() == 0
    start_step = 0
    checkpointer: Optional[ckpt.AsyncCheckpointer] = None
    if args.ckpt_dir:
        checkpointer = ckpt.AsyncCheckpointer(args.ckpt_dir)
        if ckpt.latest_step(args.ckpt_dir) is not None:
            target = state if policy is None else _full_skeleton(cfg, state)
            tree, start_step, _ = ckpt.restore(
                args.ckpt_dir, convert.train_state_to_tree(cfg, target,
                                                           "meta"))
            convert.train_state_from_numpy(cfg, tree, target)
            del tree
            if policy is not None:
                _scatter_into(state, target, policy)
                del target
            print(f"resumed from step {start_step}")

    def snapshot():
        return convert.train_state_to_tree(
            cfg, state if policy is None else _gathered(state))

    def save(at: int, extra=None) -> None:
        tree = snapshot()           # every rank takes part in the gathers
        if rank0:
            checkpointer.save_async(at, tree, extra)

    monitor = StragglerMonitor()
    metrics_log = []
    # on one card the SIGTERM hook saves at once; on a mesh it only flags
    # the signal, and the ranks save together after the step
    preempted = [False]
    old_handler = None
    if checkpointer is not None and policy is None:
        checkpointer.install_preemption_hook(
            lambda: (state["step"], snapshot()))
    elif checkpointer is not None:
        def flag_preempted(signum, frame):
            preempted[0] = True
        old_handler = signal.signal(signal.SIGTERM, flag_preempted)
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.as_tensor(v, device=model.device)
                     for k, v in source.batch_at(step).items()}
            monitor.start()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"].full_tensor() if policy is not None
                         else metrics["loss"])
            ev = monitor.stop(step)
            if ev is not None:
                print(f"[straggler] step {ev.step}: {ev.duration_s:.2f}s "
                      f"({ev.ratio:.1f}x median)")
            straggling, stop = monitor.should_checkpoint, False
            if policy is not None and checkpointer is not None:
                straggling, stop = _any_rank((straggling, preempted[0]),
                                             model.device)
            if stop:
                save(step + 1, {"preempted": True})
                checkpointer.wait()
                print(f"preempted: saved step {step + 1}", flush=True)
                torch.distributed.barrier()
                raise SystemExit(128 + signal.SIGTERM)
            if straggling and checkpointer is not None:
                save(step + 1)
            if step % args.log_every == 0 or step == args.steps - 1:
                gn = float(metrics["grad_norm"])
                print(f"step {step:5d} loss {loss:.4f} gnorm {gn:.3f}",
                      flush=True)
            metrics_log.append({"step": step, "loss": loss})
            if (checkpointer is not None and args.ckpt_every
                    and (step + 1) % args.ckpt_every == 0):
                save(step + 1)

        if checkpointer is not None:
            save(args.steps)
            checkpointer.wait()
    finally:
        if checkpointer is not None:
            checkpointer.remove_preemption_hook()
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
        if policy is not None:
            from repro_torch.launch import mesh as mesh_mod
            mesh_mod.destroy_world()

    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics_log, f)
    first = np.mean([m["loss"] for m in metrics_log[:5]])
    last = np.mean([m["loss"] for m in metrics_log[-5:]])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

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

It runs on one card, CUDA unless ``--device`` names another.  ``--mesh
host`` with ``--data-par 1 --model-par 1`` is that single-card run; a
production mesh, or any parallelism above 1, is not ported yet and
raises (ROADMAP Queue 1 item 9f).
"""
from __future__ import annotations

import argparse
import json
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


def build(args) -> Dict[str, Any]:
    if args.mesh != "host" or args.data_par != 1 or args.model_par != 1:
        raise NotImplementedError(
            f"--mesh {args.mesh} --data-par {args.data_par} --model-par "
            f"{args.model_par}: only the single-card run (--mesh host, "
            f"both 1) is ported; meshes are ROADMAP Queue 1 item 9f")
    cfg = (configs.get_smoke(args.arch) if args.preset == "smoke"
           else configs.get(args.arch))
    model = Model(cfg, args.device, remat=args.remat)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=args.warmup)
    return dict(cfg=cfg, model=model, opt_cfg=opt_cfg)


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

    start_step = 0
    checkpointer: Optional[ckpt.AsyncCheckpointer] = None
    if args.ckpt_dir:
        checkpointer = ckpt.AsyncCheckpointer(args.ckpt_dir)
        if ckpt.latest_step(args.ckpt_dir) is not None:
            tree, start_step, _ = ckpt.restore(
                args.ckpt_dir, convert.train_state_to_tree(cfg, state,
                                                           "meta"))
            convert.train_state_from_numpy(cfg, tree, state)
            del tree
            print(f"resumed from step {start_step}")

    def snapshot():
        return convert.train_state_to_tree(cfg, state)

    monitor = StragglerMonitor()
    metrics_log = []
    if checkpointer is not None:
        checkpointer.install_preemption_hook(
            lambda: (state["step"], snapshot()))
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.as_tensor(v, device=model.device)
                     for k, v in source.batch_at(step).items()}
            monitor.start()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            ev = monitor.stop(step)
            if ev is not None:
                print(f"[straggler] step {ev.step}: {ev.duration_s:.2f}s "
                      f"({ev.ratio:.1f}x median)")
            if monitor.should_checkpoint and checkpointer is not None:
                checkpointer.save_async(step + 1, snapshot())
            if step % args.log_every == 0 or step == args.steps - 1:
                gn = float(metrics["grad_norm"])
                print(f"step {step:5d} loss {loss:.4f} gnorm {gn:.3f}",
                      flush=True)
            metrics_log.append({"step": step, "loss": loss})
            if (checkpointer is not None and args.ckpt_every
                    and (step + 1) % args.ckpt_every == 0):
                checkpointer.save_async(step + 1, snapshot())

        if checkpointer is not None:
            checkpointer.save_async(args.steps, snapshot())
            checkpointer.wait()
    finally:
        if checkpointer is not None:
            checkpointer.remove_preemption_hook()

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

"""DSE autotuner: the paper's hardware-aware fitter, over a pod's
sharding options or over a CNN.

Runs BF-DSE / RL-DSE (Algorithm-1 reward shaping, unchanged) over the
``ShardingSpace`` of a cell, with the dry run (a trace on a fake world
of the production mesh, scored with the H100's data-sheet constants) as
the vendor compiler:

    PYTHONPATH=src python -m repro_torch.launch.autotune \\
        --arch qwen2-1.5b --shape train_4k --algo rl \\
        --axes remat=none,dots,full --axes n_micro=1,8 \\
        --out results/autotune_torch.json

or over the CNN (N_i, N_l, block_h[, ckpt_k]) space of a parsed model,
with the calibrated board estimator and the row-band working-set model
as the compiler (:mod:`repro_torch.core.spaces`):

    PYTHONPATH=src python -m repro_torch.launch.autotune \\
        --cnn alexnet --board ARRIA10 --algo rl \\
        --block-h 4,8,16,32 --out results/autotune_cnn.json

Flags and payload are the JAX package's (``repro.launch.autotune``).  In
CNN mode every quota is a modeled FPGA utilization (the payload equals
the JAX package's for the same arguments); in pod mode the quotas come
from the port's own dry run, so its decisions are not held to the JAX
package's, only its space, order and search.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import dse
from repro_torch.core.spaces import (DEFAULT_BLOCK_H_OPTIONS,
                                     DEFAULT_POD_AXES, CNNDesignSpace,
                                     ShardingSpace)


def parse_axes(specs: List[str]) -> List[Tuple[str, list]]:
    if not specs:
        return DEFAULT_POD_AXES
    axes = []
    for s in specs:
        name, vals = s.split("=")
        parsed = []
        for v in vals.split(","):
            if v in ("True", "False"):
                parsed.append(v == "True")
            else:
                try:
                    parsed.append(int(v))
                except ValueError:
                    parsed.append(v)
        axes.append((name, parsed))
    return axes


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="pod mode: LM architecture for the ShardingSpace")
    ap.add_argument("--cnn", default=None,
                    choices=["tiny", "alexnet", "vgg16"],
                    help="CNN mode: explore (N_i, N_l, block_h) for this "
                         "model instead of the pod ShardingSpace")
    ap.add_argument("--board", default="ARRIA10",
                    help="CNN mode: FPGA profile to score against")
    ap.add_argument("--block-h", default=None,
                    help="CNN mode: comma-separated row-band heights "
                         f"(default {DEFAULT_BLOCK_H_OPTIONS})")
    ap.add_argument("--checkpoint-k", default=None,
                    help="CNN mode: comma-separated candidate counts of "
                         "stage-boundary recovery snapshots (adds the "
                         "ckpt_k axis; snapshot bytes are charged "
                         "against the on-chip memory quota — include 0 "
                         "so resilience is only bought when it fits)")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--algo", default="rl", choices=["rl", "bf"])
    ap.add_argument("--axes", action="append", default=[])
    ap.add_argument("--eval-depth", type=int, default=4)
    ap.add_argument("--episodes", type=int, default=6)
    ap.add_argument("--steps-per-episode", type=int, default=8)
    ap.add_argument("--lut-threshold", type=float, default=100.0,
                    help="tolerated LUT quota %% (the paper's "
                         "user-provided T_th); also raises the memory "
                         "quota's threshold to at least this")
    ap.add_argument("--robust", action="store_true",
                    help="wrap the space in a RobustEvaluator (timeout, "
                         "retry, quarantine, resumable journal)")
    ap.add_argument("--eval-timeout-s", type=float, default=None,
                    help="robust mode: per-candidate wall-clock budget")
    ap.add_argument("--eval-retries", type=int, default=2,
                    help="robust mode: retries for raising evaluations")
    ap.add_argument("--journal", default=None,
                    help="robust mode: JSON journal path; rerunning with "
                         "the same journal resumes the sweep")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if (args.arch is None) == (args.cnn is None):
        ap.error("exactly one of --arch (pod mode) / --cnn (CNN mode) "
                 "is required")

    if args.cnn is not None:
        from repro_torch.core.parser import parse
        from repro_torch.core.resources import FPGA_BOARDS
        from repro_torch.models import cnn as cnn_models
        graph = {"tiny": cnn_models.tiny_cnn, "alexnet": cnn_models.alexnet,
                 "vgg16": cnn_models.vgg16}[args.cnn]()
        try:
            bh = ([int(v) for v in args.block_h.split(",")] if args.block_h
                  else list(DEFAULT_BLOCK_H_OPTIONS))
        except ValueError:
            ap.error("--block-h must be comma-separated ints, "
                     f"got {args.block_h!r}")
        try:
            ck = ([int(v) for v in args.checkpoint_k.split(",")]
                  if args.checkpoint_k else None)
        except ValueError:
            ap.error("--checkpoint-k must be comma-separated ints, "
                     f"got {args.checkpoint_k!r}")
        space = CNNDesignSpace(parse(graph), FPGA_BOARDS[args.board],
                               block_h_options=bh, checkpoint_options=ck)
    else:
        space = ShardingSpace(args.arch, args.shape,
                              axes=parse_axes(args.axes),
                              eval_depth=args.eval_depth)
    robust = None
    if args.robust or args.journal or args.eval_timeout_s is not None:
        robust = dse.RobustEvaluator(space,
                                     timeout_s=args.eval_timeout_s,
                                     retries=args.eval_retries,
                                     journal_path=args.journal)
        space = robust
    thresholds = dict(dse.DEFAULT_THRESHOLDS)
    thresholds["lut"] = args.lut_threshold
    thresholds["mem"] = max(thresholds["mem"], args.lut_threshold)
    print(f"option space: {len(space.options())} options "
          "x one compiler call each")
    if args.algo == "bf":
        res = dse.brute_force(space, thresholds=thresholds)
    else:
        res = dse.rl_dse(space, thresholds=thresholds,
                         episodes=args.episodes,
                         steps_per_episode=args.steps_per_episode)
    names = space.axis_names()
    print(f"best option: {dict(zip(names, res.best)) if res.best else None}")
    print(f"F_avg={res.f_max:.1f}  compiles={res.evaluations}  "
          f"wall={res.wall_time_s:.0f}s")
    if robust is not None:
        print(f"robust: {robust.stats}")
        for opt, why in robust.quarantined_options():
            print(f"quarantined: {dict(zip(names, opt))} ({why})")
    if res.best_report is not None:
        print("quotas:", {k: round(v, 1)
                          for k, v in res.best_report.percents.items()})
        print("projected:", {k: (round(v, 3) if isinstance(v, float) else v)
                             for k, v in res.best_report.raw.items()})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        payload = {
            "arch": args.arch or args.cnn, "shape": args.shape,
            "board": args.board if args.cnn else None, "algo": args.algo,
            "best": dict(zip(names, res.best)) if res.best else None,
            "f_max": res.f_max, "evaluations": res.evaluations,
            "history": [
                {"option": dict(zip(names, o)), "f_avg": f, "fits": ok}
                for o, f, ok in res.history],
        }
        if robust is not None:
            from repro_torch.core import telemetry as tele
            payload["robust"] = {
                "stats": robust.stats,
                "quarantined": [
                    {"option": dict(zip(names, o)), "reason": why}
                    for o, why in robust.quarantined_options()],
                # registry mirror of the stats (dse.* counters plus
                # whatever else incremented this process)
                "telemetry": tele.get_registry().snapshot(),
            }
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

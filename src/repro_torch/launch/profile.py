"""Modeled-vs-measured cost attribution.

Runs a model through the **stage-timed executor**
(``make_executor(stage_timed=True)``: ingress, each DAG stage and egress
in schedule order, the card synchronized after each), joins the measured
per-stage wall microseconds against the analytical cost models —
Table-1 latency, modeled DDR bytes, row-band working sets
(:func:`repro_torch.core.resources.modeled_stage_costs`, FPGA models of
the paper's boards) — and writes a document with per-stage
model-vs-wall ratios and a Spearman rank-correlation summary.  A model
that rank-orders stages like the wall clock does can steer the search
even when its absolute scale is off: the models price an FPGA, the wall
is the card's (or, with ``--device cpu``, the CPU's plain versions), so
*ranks*, not ratios, are the honest comparison.

Also exports the span trace (stage spans from the timed runs + any
guard/DSE/serve spans recorded in the process) as Chrome-trace JSON —
load it in Perfetto or chrome://tracing.

    PYTHONPATH=src python -m repro_torch.launch.profile \\
        --models resnet_tiny,googlenet_tiny --board ARRIA10 \\
        --trace results/torch_trace.json [--device cpu]

The document goes to ``BENCH_torch_profile.json`` unless ``--out``
names another path.  The report refuses to ship partial coverage: every
scheduled stage must appear in both the measured and the modeled rows.
"""
from __future__ import annotations

import argparse
import json
import platform
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import pipeline as pipe
from repro_torch.core import telemetry as tele
from repro_torch.core.resources import FPGA_BOARDS, modeled_stage_costs
from repro_torch.core.synthesis import CNN2Gate

PROFILE_MODELS = ("resnet_tiny", "googlenet_tiny", "mobilenet_tiny",
                  "squeezenet_tiny", "tiny_cnn", "alexnet")


def _ranks(v: np.ndarray) -> np.ndarray:
    """Average ranks (1-based, ties share their mean rank)."""
    v = np.asarray(v, np.float64)
    order = np.argsort(v, kind="stable")
    ranks = np.empty(len(v), np.float64)
    sv = v[order]
    i = 0
    while i < len(v):
        j = i
        while j + 1 < len(v) and sv[j + 1] == sv[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def spearman(a: Sequence[float], b: Sequence[float]) -> Optional[float]:
    """Spearman rank correlation (None when undefined: fewer than two
    points, or one side constant)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if len(a) < 2 or len(a) != len(b):
        return None
    ra, rb = _ranks(a), _ranks(b)
    if ra.std() == 0.0 or rb.std() == 0.0:
        return None
    return float(np.corrcoef(ra, rb)[0, 1])


def profile_model(name: str, board: str = "ARRIA10", n_i: int = 16,
                  n_l: int = 32, block_h: Optional[int] = None,
                  iters: int = 3, warmup: int = 1, seed: int = 0,
                  tracer: Optional[tele.Tracer] = None,
                  device=None) -> Dict:
    """Measure one model (a builder of :mod:`repro_torch.models.cnn`, at
    batch 1) stage by stage on ``device`` (CUDA by default) and join
    against the analytical models.  Returns the per-model attribution
    document (the value stored under ``models[<name>]``)."""
    from repro_torch.models import cnn

    tracer = tracer if tracer is not None else tele.get_tracer()
    graph = getattr(cnn, name)(batch=1)
    gate = CNN2Gate.from_graph(graph, device=device)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(gate.parsed.input_shape) * 0.5
         ).astype(np.float32)
    gate.calibrate_quantization(x)

    ex = pipe.make_executor(gate.quantized, n_i, n_l, block_h=block_h,
                            stage_timed=True, tracer=tracer)
    with tracer.span(f"profile.warmup:{name}", cat="profile"):
        for _ in range(max(warmup, 1)):   # build and load every kernel
            ex(x)
    runs: List[List[Dict]] = []
    with tracer.span(f"profile.measure:{name}", cat="profile",
                     args={"iters": iters}):
        for _ in range(max(iters, 1)):
            _, timings = ex(x)
            runs.append(timings)

    # median wall per stage across iters (schedule order is identical
    # in every run — the stage program is static)
    measured: Dict[str, Dict] = {}
    for i, row in enumerate(runs[0]):
        walls = [r[i]["wall_us"] for r in runs]
        measured[row["stage"]] = {"kind": row["kind"],
                                  "wall_us": float(np.median(walls))}

    modeled = modeled_stage_costs(gate.parsed, FPGA_BOARDS[board],
                                  n_i, n_l, block_h=block_h,
                                  per_channel=gate.per_channel)
    missing = [s for s in modeled if s not in measured]
    if missing:
        raise RuntimeError(
            f"attribution report for {name!r} is missing measured "
            f"times for scheduled stages {missing} — the stage-timed "
            "executor and the schedule disagree")

    rows: List[Dict] = []
    for stage, cost in modeled.items():
        wall_us = measured[stage]["wall_us"]
        model_us = cost["model_s"] * 1e6
        rows.append({
            "stage": stage, "kind": cost["kind"],
            "wall_us": wall_us, "model_us": model_us,
            "t_compute_us": cost["t_compute_s"] * 1e6,
            "t_memory_us": cost["t_memory_s"] * 1e6,
            "ddr_bytes": cost["ddr_bytes"],
            "vmem_bytes": cost["vmem_bytes"],
            "macs": cost["macs"],
            "model_wall_ratio": (model_us / wall_us if wall_us > 0
                                 else None),
        })
    overhead = {s: m["wall_us"] for s, m in measured.items()
                if s not in modeled}          # ingress/egress pseudo-stages

    walls = [r["wall_us"] for r in rows]
    models = [r["model_us"] for r in rows]
    return {
        "board": board, "n_i": n_i, "n_l": n_l, "block_h": block_h,
        "iters": iters, "seed": seed,
        "device": str(gate.device),
        "device_name": (torch.cuda.get_device_name(gate.device)
                        if gate.device.type == "cuda" else "cpu"),
        "stages": rows,
        "overhead_us": overhead,
        "summary": {
            "n_stages": len(rows),
            "wall_us_total": float(np.sum(walls)),
            "model_us_total": float(np.sum(models)),
            "rank_corr_model_vs_wall": spearman(models, walls),
            "rank_corr_macs_vs_wall": spearman(
                [r["macs"] for r in rows], walls),
            "rank_corr_ddr_vs_wall": spearman(
                [r["ddr_bytes"] for r in rows], walls),
        },
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-stage modeled-vs-measured cost attribution")
    ap.add_argument("--models", default="resnet_tiny,googlenet_tiny",
                    help=f"comma-separated subset of {PROFILE_MODELS}")
    ap.add_argument("--board", default="ARRIA10",
                    choices=sorted(FPGA_BOARDS))
    ap.add_argument("--n-i", type=int, default=16)
    ap.add_argument("--n-l", type=int, default=32)
    ap.add_argument("--block-h", type=int, default=None)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--trace", default="results/torch_trace.json",
                    help="Chrome-trace/Perfetto span export path")
    ap.add_argument("--out", default="BENCH_torch_profile.json",
                    help="where the attribution document goes")
    ap.add_argument("--no-bench-json", action="store_true",
                    help="skip writing the attribution document")
    args = ap.parse_args(argv)

    names = [m.strip() for m in args.models.split(",") if m.strip()]
    unknown = [m for m in names if m not in PROFILE_MODELS]
    if unknown:
        ap.error(f"unknown model(s) {unknown}; choose from "
                 f"{PROFILE_MODELS}")

    tracer = tele.get_tracer()
    results: Dict[str, Dict] = {}
    for name in names:
        doc = profile_model(name, board=args.board, n_i=args.n_i,
                            n_l=args.n_l, block_h=args.block_h,
                            iters=args.iters, warmup=args.warmup,
                            seed=args.seed, tracer=tracer,
                            device=args.device)
        results[name] = doc
        s = doc["summary"]
        corr = s["rank_corr_model_vs_wall"]
        corr_txt = f"{corr:.3f}" if corr is not None else "n/a"
        print(f"[profile] {name} on {doc['device_name']}: "
              f"{s['n_stages']} stages, "
              f"wall {s['wall_us_total']:.0f}us, "
              f"modeled {s['model_us_total']:.1f}us, "
              f"rank corr model-vs-wall {corr_txt}")
        worst = max(doc["stages"], key=lambda r: r["wall_us"])
        print(f"[profile]   hottest stage: {worst['stage']} "
              f"({worst['kind']}) wall {worst['wall_us']:.0f}us, "
              f"modeled {worst['model_us']:.2f}us, "
              f"ddr {worst['ddr_bytes']}B, vmem {worst['vmem_bytes']}B")

    # the process observability payload rides along: guard outcomes,
    # serve histograms — whatever ran here
    payload = {"models": results,
               "telemetry": tele.get_registry().snapshot(),
               "env": {"torch": torch.__version__,
                       "cuda": torch.version.cuda,
                       "python": platform.python_version(),
                       "host": platform.node()}}
    if not args.no_bench_json:
        text = json.dumps(payload, indent=2, sort_keys=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
        print(f"[profile] wrote {args.out}")
    if args.trace:
        print(f"[profile] wrote {tracer.export(args.trace)} "
              f"({len(tracer.events())} spans)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

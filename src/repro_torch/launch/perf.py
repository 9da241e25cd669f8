"""Performance hillclimbing driver over the dry run's roofline terms.

Runs named iteration configurations against a chosen (arch × shape)
cell and records the roofline terms of each, so the hypothesis ->
change -> measure -> validate log is reproducible:

    PYTHONPATH=src python -m repro_torch.launch.perf \\
        --cell qwen2.5-32b/train_4k --iter baseline --iter micro8 \\
        --out results/perf_torch.json

The counterpart of ``repro.launch.perf``, with its table of iterations
key for key; each is traced by :func:`.dryrun.lower_cell` on the fake
production world, with the H100's constants (``roofline.py``).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict

from repro_torch.launch.dryrun import lower_cell
from repro_torch.sharding import PolicyOptions

# named iteration configurations: (PolicyOptions kwargs, cfg_override,
# flash_accounting)
ITERATIONS: Dict[str, Dict[str, Any]] = {
    # paper-faithful baseline: remat=dots, plain DP+TP, chunked attention
    "baseline": dict(),
    # activation-memory attack
    "micro4": dict(policy=dict(n_micro=4)),
    "micro8": dict(policy=dict(n_micro=8)),
    "micro16": dict(policy=dict(n_micro=16)),
    "seqpar": dict(policy=dict(sequence_parallel=True)),
    "seqpar_micro8": dict(policy=dict(sequence_parallel=True, n_micro=8)),
    "remat_full": dict(policy=dict(remat="full")),
    "remat_none": dict(policy=dict(remat="none")),
    "remat_full_micro8": dict(policy=dict(remat="full", n_micro=8)),
    "seqpar_remat_full_micro8": dict(policy=dict(
        sequence_parallel=True, remat="full", n_micro=8)),
    # attention-memory attack: flash kernel accounting
    "flash": dict(flash=True),
    "flash_seqpar_micro8": dict(policy=dict(sequence_parallel=True,
                                            n_micro=8), flash=True),
    "flash_seqpar": dict(policy=dict(sequence_parallel=True), flash=True),
    "flash_micro8": dict(policy=dict(n_micro=8), flash=True),
    "flash_seqpar_micro16": dict(policy=dict(sequence_parallel=True,
                                             n_micro=16), flash=True),
    "flash_seqpar_micro4": dict(policy=dict(sequence_parallel=True,
                                            n_micro=4), flash=True),
    # ZeRO-2: reduce-scatter grads into the optimizer-shard layout
    "flash_micro8_zero2": dict(policy=dict(n_micro=8, zero2_grads=True),
                               flash=True),
    "flash_micro16_zero2": dict(policy=dict(n_micro=16, zero2_grads=True),
                                flash=True),
    "flash_seqpar_zero2": dict(policy=dict(sequence_parallel=True,
                                           zero2_grads=True), flash=True),
    "flash_micro16_zero2_rematfull": dict(
        policy=dict(n_micro=16, zero2_grads=True, remat="full"),
        flash=True),
    "flash_micro8_zero2_rematfull": dict(
        policy=dict(n_micro=8, zero2_grads=True, remat="full"),
        flash=True),
    # chunk-size sweeps (memory/compute balance of chunked attention)
    "chunk512": dict(cfg=dict(attention_chunk=512)),
    "chunk2048": dict(cfg=dict(attention_chunk=2048)),
    # MoE routing-group bound (dispatch cost linearisation)
    "moegroup4k": dict(cfg=dict(moe_group_size=4096)),
    "moegroup2k": dict(cfg=dict(moe_group_size=2048)),
    "moegroup4k_flash": dict(cfg=dict(moe_group_size=4096), flash=True),
    "moegroup2k_flash": dict(cfg=dict(moe_group_size=2048), flash=True),
    "moegroup4k_flash_seqpar": dict(cfg=dict(moe_group_size=4096),
                                    policy=dict(sequence_parallel=True),
                                    flash=True),
    # turn off TP (pure DP) / activation-head sharding ablations
    "no_head_shard": dict(policy=dict(shard_activation_heads=False)),
    "no_seq_shard_decode": dict(policy=dict(seq_shard_decode=False)),
}


def run_iteration(arch: str, shape: str, name: str) -> Dict[str, Any]:
    spec = ITERATIONS[name]
    options = PolicyOptions(**spec.get("policy", {}))
    _full, meta = lower_cell(
        arch, shape, options=options,
        cfg_override=spec.get("cfg"),
        flash_accounting=spec.get("flash", False))
    meta["iteration"] = name
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch/shape")
    ap.add_argument("--iter", action="append", default=[])
    ap.add_argument("--out", default="results/perf_torch.json")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split("/")
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for name in (args.iter or ["baseline"]):
        key = f"{arch}|{shape}|{name}"
        print(f"=== {key} ===", flush=True)
        meta = run_iteration(arch, shape, name)
        results[key] = meta
        print(json.dumps({k: meta[k] for k in
                          ("t_compute", "t_memory_fused", "t_collective",
                           "dominant", "t_step", "roofline_fraction",
                           "peak_bytes_per_dev")}, default=float),
              flush=True)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""qverify CLI — static design-rule checks over the model zoo.

Runs the :mod:`repro_torch.core.verify` rule catalog over the
named builders, calibrating each with the standard seeded random input
and checking every requested (quant mode, fusion mode) combination.
The process exits non-zero when any error-severity diagnostic fires —
the CI gate runs this over all five zoo builders, per-tensor and
per-channel, and requires a clean report.

    PYTHONPATH=src python -m repro_torch.launch.verify --device cpu \
        --models resnet_tiny,googlenet_tiny --per-channel both

``--probes`` additionally runs each fused executor once and applies the
QV501/QV502 structural probes (no standalone ``qadd_nhwc`` /
``qconcat_nhwc`` call may remain in a fully fused program) — opt-in
because a run is not free.  ``--vmem-budget`` arms the QV401/QV402
resource rules against a declared on-chip byte budget (of the FPGA/Pallas
row-band model).  The models are built on ``--device`` (CUDA by
default).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import device as _device
from repro_torch.core import parser as P
from repro_torch.core import verify as V
from repro_torch.core.synthesis import CNN2Gate

ZOO_MODELS = ("resnet_tiny", "mobilenet_tiny", "googlenet_tiny",
              "squeezenet_tiny", "resnet18")


def _modes(choice: str) -> List[bool]:
    return {"off": [False], "on": [True], "both": [False, True]}[choice]


def verify_model(name: str, per_channel: bool, fused: bool, *,
                 n_i: int = 16, n_l: int = 32,
                 block_h: Optional[int] = None,
                 vmem_budget: Optional[int] = None,
                 checkpoints: Sequence[int] = (),
                 probes: bool = False,
                 seed: int = 0,
                 device: _device.DeviceLike = None
                 ) -> V.VerificationReport:
    """Build + statically verify one (model, quant mode, fusion mode)
    combination; returns the report (QV5xx probes included on demand).
    """
    from repro_torch.models import cnn

    graph = getattr(cnn, name)(batch=1)
    parsed = P.parse(graph, fuse_skip=fused, fuse_concat=fused)
    gate = CNN2Gate(parsed, device=device)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(parsed.input_shape) * 0.5).astype(np.float32)
    # build_quantized already runs the build-time subset and would raise
    # on an error; the explicit pass below re-runs the full catalog and
    # *collects* (so one bad combination cannot mask another's report)
    gate.calibrate_quantization(x, per_channel=per_channel)
    rep = gate.verify(n_i=n_i, n_l=n_l, block_h=block_h,
                      vmem_budget=vmem_budget, checkpoints=checkpoints)
    if probes and fused:
        rep.diagnostics += V.structural_probes(
            gate.quantized, n_i=n_i, n_l=n_l, block_h=block_h)
    return rep


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Static program verification (DRC) over the model "
                    "zoo")
    ap.add_argument("--models", default=",".join(ZOO_MODELS),
                    help=f"comma-separated subset of {ZOO_MODELS}")
    ap.add_argument("--per-channel", default="both",
                    choices=("off", "on", "both"),
                    help="weight-quantization modes to check")
    ap.add_argument("--fused", default="both",
                    choices=("off", "on", "both"),
                    help="skip/concat fusion modes to check")
    ap.add_argument("--n-i", type=int, default=16)
    ap.add_argument("--n-l", type=int, default=32)
    ap.add_argument("--block-h", type=int, default=None)
    ap.add_argument("--vmem-budget", type=int, default=None,
                    help="arm QV401/QV402 against this on-chip byte "
                         "budget (default: unarmed)")
    ap.add_argument("--checkpoints", default="",
                    help="comma-separated boundary indices to prove "
                         "(QV304) and charge (QV402)")
    ap.add_argument("--probes", "--jaxpr-probes", dest="probes",
                    action="store_true",
                    help="also run fused executors for QV501/QV502 "
                         "(--jaxpr-probes: the JAX package's spelling)")
    ap.add_argument("--device", default=None,
                    help="where the models are built and probed "
                         "(default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in sorted(V.RULES):
            print(f"{rid}  {V.RULES[rid]}")
        return 0

    names = [m.strip() for m in args.models.split(",") if m.strip()]
    unknown = [m for m in names if m not in ZOO_MODELS]
    if unknown:
        ap.error(f"unknown model(s) {unknown}; choose from {ZOO_MODELS}")
    ckpts = [int(c) for c in args.checkpoints.split(",") if c.strip()]

    n_errors = 0
    n_combos = 0
    counts: Dict[str, int] = {}
    for name in names:
        for pc in _modes(args.per_channel):
            for fused in _modes(args.fused):
                n_combos += 1
                tag = (f"{name} [{'per-channel' if pc else 'per-tensor'}"
                       f", {'fused' if fused else 'unfused'}]")
                try:
                    rep = verify_model(
                        name, pc, fused, n_i=args.n_i, n_l=args.n_l,
                        block_h=args.block_h,
                        vmem_budget=args.vmem_budget,
                        checkpoints=ckpts,
                        probes=args.probes, seed=args.seed,
                        device=args.device)
                except V.VerificationError as e:
                    # build-time rejection IS a verifier result
                    rep = V.VerificationReport(list(e.diagnostics))
                for d in rep.diagnostics:
                    counts[d.rule_id] = counts.get(d.rule_id, 0) + 1
                if rep.ok:
                    extra = (f" ({len(rep.warnings)} warning(s))"
                             if rep.warnings else "")
                    print(f"[verify] {tag}: clean{extra}")
                else:
                    n_errors += len(rep.errors)
                    print(f"[verify] {tag}: {len(rep.errors)} error(s)")
                    for d in rep.diagnostics:
                        print(f"[verify]   {d}")
    summary = ", ".join(f"{r}x{n}" for r, n in sorted(counts.items())) \
        or "none"
    print(f"[verify] {n_combos} combination(s), {n_errors} error(s); "
          f"diagnostics: {summary}")
    return 1 if n_errors else 0


if __name__ == "__main__":
    raise SystemExit(main())

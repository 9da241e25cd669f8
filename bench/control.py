"""The control of the benchmark's comparison, at a cell's own size.

    python3 bench/control.py --workload vgg16.offline_b64 --seeds 1,2,3 --seconds 3

For each seed it runs the cell as a run does, with the plain reference
at int4 (the precision below the configuration's int8, calibrated by
the same rule at 4 bits) in the program's place: the window drives it
with the cell's own traffic, and the run's own check compares its
answers with the int8 reference.  It prints each run's result line; a
sound limit lies below every ``compared`` reading.  The benchmark's own
runs never run this; it needs a CUDA device, like a run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def executor(s):
    """The family's reference at int4 over the set-up's float weights
    and calibration image, as an executor: images in, float32 logits on
    the set-up's device out."""
    from bench import model

    fam, dev = s.family, s.device
    weights = {n: (w.to(dev), b.to(dev)) for n, (w, b) in
               s.host_weights.items()}
    x_cal = model.make_images(1, s.config["input"], s.seed, 1, dev)
    m_in, specs = fam.calibrate(s.layers, weights, x_cal, bits=4)

    def run(x):
        return fam.int_forward(s.layers, weights, m_in, specs, x.to(dev),
                               bits=4)
    return run


def readings(bench: dict, workload: str, seed: int, seconds: float,
             device) -> dict:
    """The result of one run of ``workload`` with the control in the
    program's place."""
    from bench import run as bench_run
    return bench_run.run(bench, workload, seed, seconds, 0, device,
                         time.time(), replace=executor)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the control is read on the card",
              file=sys.stderr)
        sys.exit(2)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(bench, args.workload, seed, args.seconds,
                     torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, **r}),
              flush=True)


if __name__ == "__main__":
    main()

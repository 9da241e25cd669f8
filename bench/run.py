"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload vgg16.stream_b1 --seed 7 --seconds 10 --trace 0

The cell, its configuration and traffic mix, and the metrics it reports
come from ``BENCHMARK.json`` at the root of the checkout.  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` the window runs under the profiler and they are its
per-layer metrics, each read by ``bench/metrics/<name>.py``, or where
that file is missing by the reader of the name before its first dot
(``mfu.offline`` and ``mfu.stream`` by ``bench/metrics/mfu.py``).  The last
line on standard output is one JSON object; the numbers the check
compared, with their limits, are the last lines on standard error and
the last key of that object.  Without as many CUDA devices as the cell
asks for, or with JAX or the JAX package loaded after the window, it
prints no result and exits 2.
"""
from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The wall-clock time this process started (Linux ``/proc``), or
    the time this module was first run where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def fail(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
    sys.exit(2)


def forbidden_modules():
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def reader_path(name: str) -> Path:
    """The file of a per-layer metric's reader: ``<name>.py``, else the
    file of the name before its first dot."""
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(name.split(".")[0] + ".py")
    return path


def reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def main(argv=None) -> None:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        fail(f"no workload {args.workload!r} in BENCHMARK.json")

    # every cache of the program and of torch inside the checkout, at
    # fixed paths (the kernels' own build directory is build/kernels)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(BUILD / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} CUDA devices, "
             f"{torch.cuda.device_count()} present")
    result = run(bench, args.workload, args.seed, args.seconds, args.trace,
                 torch.device("cuda", 0), t_start)
    loaded = forbidden_modules()
    if loaded:
        fail(f"loaded in this process: {', '.join(loaded)}")
    print(json.dumps(result), flush=True)


def run(bench: dict, workload: str, seed: int, seconds: float, traced: int,
        dev, t_start: float, replace=None) -> dict:
    """Set up, measure and check one cell on ``dev``; return the result
    object, after printing what was compared on standard error.

    ``replace``, given the set-up, returns an executor that the window
    drives in the program's place: the control (``bench/control.py``)."""
    import torch

    from bench import cell as run_cell

    cell, config, traffic = run_cell.resolve(bench, workload)
    s = run_cell.Setup(config, traffic, seed, dev)
    setup_s = time.time() - t_start
    print("setup_s %.2f: " % setup_s + ", ".join(
        f"{k} {v:.2f}" for k, v in s.steps.items()), file=sys.stderr)
    if replace is not None:
        s.executor = replace(s)

    tr = None
    if traced:
        w, tr = run_cell.traced_window(s, seconds)
    else:
        w = run_cell.window(s, seconds)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    print(f"window {w.requests} requests in {w.seconds:.4f} s, "
          f"{1e3 * w.seconds / max(w.requests, 1):.5f} ms a request"
          + (" (traced)" if traced else ""), file=sys.stderr)
    s.free_program()
    found = run_cell.check(s, w)

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": cell["chips"], "memory_peak_bytes": int(peak)}
    metrics = {}
    if traced:
        if tr is not None:
            device["busy_s"] = tr.busy_s
            device["window_s"] = tr.window_s
            for m in bench["per_layer"]:
                if applies(m, workload):
                    v = reader(m["name"])(tr)
                    if v is not None:
                        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = run_cell.end_to_end(s, w, setup_s)
        for m in bench["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    compared = {k: {"value": found[k], "limit": lim}
                for k, lim in run_cell.LIMITS.items()}
    correct = found["answers_checked"] > 0 and all(
        c["value"] <= c["limit"] for c in compared.values())
    attempted = w.requests * traffic["batch"]
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": found["answers_wrong"],
              "metrics": metrics, "device": device}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["compared"] = compared
    print(f"checked {found['answers_checked']} answers of {attempted}, "
          f"{found['answers_wrong']} wrong, {found['distinct_logits']} "
          f"distinct reference logits, reference "
          f"{found.get('reference_s', 0.0):.2f} s", file=sys.stderr)
    for k, c in compared.items():
        print(f"compared {k} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    return result


if __name__ == "__main__":
    main()

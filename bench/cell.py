"""One run of one cell: set-up, the measured window, the check.

Set-up is the user's path into the program: the configuration's
ONNX-lite model dict with weights drawn from the seed
(``core.onnx_lite.from_model_dict``, ``CNN2Gate.from_graph``), the
per-layer specs that the benchmark computes with its own copy of the
power-of-two rule (``CNN2Gate.apply_quantization``), and
``build("fullflow")`` at the default design point.  It then warms up the
cell's own input shape.  The window drives the returned
``core.synthesis.CapturedExecutor`` with the traffic mix's requests;
afterwards the program is freed and the plain reference of the
configuration's family (``bench/reference/<family>.py``) recomputes a
seeded sample of the answers.

A traffic mix (``bench/traffic/<name>.json``) is read by one general
generator, :func:`window`: a closed loop of one client sending
``batch``-image requests drawn in a seeded order from a ``pool`` of
distinct batches that lie on the host or the device (``input_on``);
``read_back`` copies each answer to the host before the next request
and times it, otherwise requests are queued back to back, at most
``in_flight`` of them on the device, and the window ends at one
synchronize.  ``sample_requests`` answers (and
``sample_rows`` rows of each, for batches) are kept by a seeded
reservoir for the check.  :func:`load_traffic` refuses a key or a value
that the generator does not implement.
"""
from __future__ import annotations

import collections
import gc
import sys
import json
import math
import random
import statistics
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from bench import model, trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: every number the check compares, with its limit: the program's int8
#: logits must equal the reference's exactly
LIMITS = {"logits_differing": 0}

#: warm-up requests before the window, beyond the capture
WARM_REQUESTS = 3

#: the longest traced window: reducing a profile of a 10-s stream window
#: (some 600,000 events) took two minutes on the card's host
TRACE_SECONDS = 2.0

def _count(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 1


#: every key a traffic mix may hold, with the test its value must pass
TRAFFIC_KEYS = {
    "name": lambda v: isinstance(v, str),
    "why": lambda v: isinstance(v, str),
    "batch": _count,
    "pool": _count,
    "input_on": lambda v: v in ("host", "device"),
    "read_back": lambda v: isinstance(v, bool),
    "in_flight": _count,
    "sample_requests": _count,
    "sample_rows": _count,
}
TRAFFIC_REQUIRED = ("batch", "pool", "input_on", "read_back",
                    "sample_requests")


def resolve(bench: dict, workload: str) -> Tuple[dict, dict, dict]:
    """A cell of ``bench`` (BENCHMARK.json) by name: its entry, its
    configuration and its traffic mix (``bench/traffic/<name>.json``)."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    traffic = load_traffic(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, model.load_config(ROOT / conf["file"]), traffic


def load_traffic(path) -> dict:
    """A traffic mix, refused with ValueError where it holds a key or a
    value that :func:`window` does not implement, or lacks one it needs."""
    with open(path) as f:
        traffic = json.load(f)
    for k, v in traffic.items():
        if k not in TRAFFIC_KEYS:
            raise ValueError(f"{path}: the generator implements no {k!r}")
        if not TRAFFIC_KEYS[k](v):
            raise ValueError(f"{path}: the generator implements no "
                             f"{k} = {v!r}")
    missing = [k for k in TRAFFIC_REQUIRED if k not in traffic]
    if missing:
        raise ValueError(f"{path}: lacks {', '.join(missing)}")
    if traffic["read_back"] == ("in_flight" in traffic):
        raise ValueError(f"{path}: the generator implements in_flight, "
                         "and needs it, only where answers are not read "
                         "back")
    return traffic


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn by ``rng``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Setup:
    """What set-up leaves for the window and the check."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        from repro_torch.core import onnx_lite
        from repro_torch.core.quantize import QuantSpec
        from repro_torch.core.synthesis import CNN2Gate

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        #: seconds of each step of set-up, in order
        self.steps: Dict[str, float] = {}
        t = [time.perf_counter()]

        def step(name: str) -> None:
            _sync(device)
            now = time.perf_counter()
            self.steps[name] = now - t[0]
            t[0] = now

        self.family = fam = model.family(config)
        self.layers = fam.layers_of(config)
        batch = traffic["batch"]
        weights = fam.make_weights(self.layers, seed, device)
        step("weights")
        x_cal = model.make_images(1, config["input"], seed, 1, device)
        self.m_in, self.specs = fam.calibrate(self.layers, weights, x_cal)
        step("calibrate")
        # the float weights go to the program as an exporter's numpy
        # arrays; the reference reads the same host copies after the window
        self.host_weights = {n: (w.cpu(), b.cpu())
                             for n, (w, b) in weights.items()}
        del weights, x_cal
        step("to_host")
        if device.type == "cuda":
            # the peak a run reports is the program's: from its build on
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        inits = {}
        for n, (w, b) in self.host_weights.items():
            inits[f"{n}_w"], inits[f"{n}_b"] = w.numpy(), b.numpy()
        graph = onnx_lite.from_model_dict(
            fam.model_dict(config, self.layers), inits)
        self.gate = CNN2Gate.from_graph(graph, device=device)
        step("parse")
        self.gate.apply_quantization(
            {n: QuantSpec(*s) for n, s in self.specs.items()})
        step("quantize")
        self.executor = self.gate.build("fullflow")
        step("build")
        images = model.make_images(traffic["pool"] * batch, config["input"],
                                   seed, 2, device)
        images = images.view((traffic["pool"], batch) + images.shape[1:])
        if traffic["input_on"] == "host":
            images = images.cpu()
        self.pool = images
        rng = random.Random(seed)
        self.order = list(range(traffic["pool"]))
        rng.shuffle(self.order)
        self.counts = fam.forward_counts(self.layers, batch)
        step("pool")
        for i in range(WARM_REQUESTS):
            y = self.executor(self.pool[self.order[i % len(self.order)]])
            if traffic["read_back"]:
                y.cpu()
        step("warm")

    def free_program(self) -> None:
        """Drop the program, its graphs and the device pool."""
        del self.executor, self.gate
        self.pool = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Window:
    """What one measured window recorded: each request's latency where
    answers are read back, the requests, the seconds, and the answers
    kept for the check."""

    def __init__(self, kept: Reservoir):
        self.latencies: List[float] = []
        self.requests = 0
        self.seconds = 0.0
        self.kept = kept


def window(s: Setup, seconds: float, kept: Reservoir = None) -> Window:
    """Drive the executor with the traffic mix for ``seconds``; the
    window ends after its last answer (read back, or synchronized).  The
    answers are offered to ``kept``, a new reservoir if it is None."""
    t = s.traffic
    ex, pool, order, dev = s.executor, s.pool, s.order, s.device
    read_back, depth = t["read_back"], t.get("in_flight")
    queued: collections.deque = collections.deque()
    if kept is None:
        kept = Reservoir(t["sample_requests"], random.Random(s.seed + 1))
    w = Window(kept)
    lat = w.latencies
    i = 0
    i0 = kept.seen
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        if ts - t0 >= seconds:
            break
        k = order[i % len(order)]
        y = ex(pool[k])
        if read_back:
            y = y.cpu()
            lat.append(time.perf_counter() - ts)
        elif dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            queued.append(ev)
            if len(queued) > depth:
                queued.popleft().synchronize()
        w.kept.offer((i0 + i, k, y))
        i += 1
    _sync(dev)
    w.seconds = time.perf_counter() - t0
    w.requests = i
    return w


def check(s: Setup, w: Window) -> Dict[str, float]:
    """Recompute the kept answers with the plain reference and count the
    logits that differ.  Runs after :meth:`Setup.free_program`."""
    batch = s.traffic["batch"]
    rows_per = min(s.traffic.get("sample_rows", batch), batch)
    rng = random.Random(s.seed + 2)
    pool_images = model.make_images(s.traffic["pool"] * batch,
                                    s.config["input"], s.seed, 2, s.device)
    got, want_idx = [], []
    for _i, k, y in sorted(w.kept.items, key=lambda it: it[0]):
        rows = sorted(rng.sample(range(batch), rows_per))
        got.append(y.to("cpu")[rows])
        want_idx += [k * batch + r for r in rows]
    if not got:
        return {"answers_checked": 0, "answers_wrong": 0,
                "logits_differing": None, "distinct_logits": 0}
    uniq = sorted(set(want_idx))
    t0 = time.perf_counter()
    ref = s.family.int_forward(s.layers, s.host_weights, s.m_in, s.specs,
                               pool_images[uniq]).cpu()
    ref = ref[[uniq.index(j) for j in want_idx]]
    got = torch.cat(got).to(torch.float32)
    diff = got != ref
    return {"reference_s": time.perf_counter() - t0,
            "answers_checked": int(got.shape[0]),
            "answers_wrong": int(diff.any(dim=1).sum()),
            "logits_differing": int(diff.sum()),
            "distinct_logits": int(torch.unique(ref).numel())}


def end_to_end(s: Setup, w: Window, setup_s: float) -> Dict[str, float]:
    """Every end-to-end metric this window can give, by name."""
    out = {"setup_s": setup_s}
    if w.latencies:
        lat = sorted(w.latencies)
        out["latency_p50_ms"] = 1e3 * statistics.median(lat)
        # nearest rank: the least latency that 95 % of requests met
        out["latency_p95_ms"] = 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
    if w.seconds > 0:
        out["images_per_s"] = w.requests * s.traffic["batch"] / w.seconds
    return out


def traced_window(s: Setup, seconds: float) -> Tuple[Window, object]:
    """Two windows of at most :data:`TRACE_SECONDS` each, and the
    :class:`trace.Trace` of the second.  The first runs untraced: its
    seconds a request are the host path's own, which the profiler
    stretches (at batch 1 by a quarter to a third, even with the CUDA
    activity alone).  The second runs under ``torch.profiler`` with the
    CUDA activity alone, so that no host operator is recorded; its trace
    carries the first's seconds a request.  The returned window counts
    both windows' requests and keeps answers of both for the check.  On a
    device other than CUDA: the untraced window and None.  A trace
    without a device event fails the run."""
    seconds = min(seconds, TRACE_SECONDS)
    plain = window(s, seconds)
    if s.device.type != "cuda":
        return plain, None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w = window(s, seconds, kept=plain.kept)
    print(f"traced window {w.requests} requests in {w.seconds:.4f} s, "
          f"untraced {plain.requests} in {plain.seconds:.4f} s",
          file=sys.stderr)
    tr = trace.read(prof, w.seconds, w.requests, s.counts,
                    plain.seconds / max(plain.requests, 1))
    if tr is None:
        raise RuntimeError("the profiler returned no device event for the "
                           "window")
    w.requests += plain.requests
    w.seconds += plain.seconds
    return w, tr


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)

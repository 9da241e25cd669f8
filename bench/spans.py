"""The program's spans on the fullflow path, joined with the device trace:
what span-reading per-layer metrics of a cell would read.

    python3 bench/spans.py --workload alexnet.stream_b1 --seed 7 --seconds 2

It sets the cell up as a run does (``bench/cell.py:Setup``) and runs
three windows of at most :data:`bench.cell.TRACE_SECONDS` each:

1. untraced, as a traced run's first window;
2. spans: ``executor.tracer`` set, no profiler;
3. profiled: ``torch.profiler`` with the CUDA activity alone, and
   ``executor.tracer`` set.

:func:`join` puts the program's spans and the profile on one timeline:
the tracer gives spans in Unix-epoch microseconds, kineto its events in
Unix-epoch nanoseconds.  The device events of a replay are those that
its ``cudaGraphLaunch`` runtime call launched (kineto's correlation id),
in start order; the stage map that the executor recorded at capture
(``CapturedExecutor.stage_map``) puts them under their stages.  A replay
whose count differs from the map's total is unmapped, and then no stage
reading is given.  The mapping reads correlation ids alone; idle by span
and the copies' order also read the timestamps, and the device clock may
drift from the host's inside a window (:attr:`Join.clock_drift_us`).

On standard error it prints the per-stage table (device ms a forward,
and for conv and FC stages the share of the bound of
``bench/counts.py``), the profiled window's device idle by the innermost
program span over each gap (``caller`` where the host was in none), the
tracing-on cost (window 2's seconds a request less window 1's, and
from interleaved blocks, :func:`interleaved_cost_us`) and the captures
inside windows 2 and 3.  The last line on standard output is a
JSON object of the readings, each None where nothing could be read.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import re
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]

#: a kernel of the int8 conv (``csrc/qconv.cu``, ``csrc/qdwconv.cu``)
CONV_KERNEL = re.compile(r"qconv|qdwconv")
#: the host runtime call that launches a graph
GRAPH_LAUNCH = "cudaGraphLaunch"

#: (start us, end us, name, correlation id) of a kineto event
Event = Tuple[float, float, str, int]


@dataclasses.dataclass
class Join:
    """The program's spans joined with one profiled window."""

    #: per stage of the map, in order: (stage, kind, device ms a
    #: forward, of which ms in events that are not int8 conv kernels)
    stages: List[Tuple[str, str, float, float]]
    #: replays whose device events the stage map covers, and all replays
    mapped: int
    replays: int
    #: why a replay was left unmapped ("" where none was)
    unmapped_why: str
    #: device seconds of every event the graph launches correlate with
    graph_device_s: float
    #: replay spans that hold exactly one graph launch
    launches_in_replay: int
    #: requests whose host-to-device copy starts inside or after their
    #: copy-in span and before their replay span ends, of those with one
    copies_in_order: int
    copies: int
    #: idle seconds of the profiled window by innermost program span
    idle_by_span: Dict[str, float]
    #: the device clock against the host's, from each replay's lag (us)
    #: between its graph launch's start and its graph's first device
    #: event: the least lag (below 0 the device clock runs ahead), and
    #: the least lag of the window's last tenth of replays less that of
    #: its first tenth (the drift across the window); None without a
    #: replay.  Idle by span and the copies' order shift with both.  A
    #: clock reading only where each launch finds the device idle (the
    #: stream cells); offline, a launch queues behind those in flight.
    launch_lag_us: Optional[float] = None
    clock_drift_us: Optional[float] = None

    def stage_ms(self, kind: str, side: bool = False) -> Optional[float]:
        """Device ms a forward of the stages of ``kind`` (with ``side``,
        of their events that are not int8 conv kernels); None where a
        replay is unmapped."""
        if self.unmapped_why or not self.mapped:
            return None
        return sum(other if side else ms
                   for _, k, ms, other in self.stages if k == kind)


def by_request(spans: Sequence[dict]) -> Dict[int, Dict[str, dict]]:
    """The ``captured.*`` spans of a tracer's events, by request id."""
    out: Dict[int, Dict[str, dict]] = {}
    for ev in spans:
        rid = ev.get("args", {}).get("rid")
        if rid is not None and ev["name"].startswith("captured."):
            out.setdefault(rid, {})[ev["name"]] = ev
    return out


def median_us(spans: Sequence[dict], name: str) -> Optional[float]:
    durs = [ev["dur"] for ev in spans if ev["name"] == name]
    return statistics.median(durs) if durs else None


def join(spans: Sequence[dict], device: Sequence[Event],
         host: Sequence[Event], stage_map: Sequence[Tuple[str, str, int]],
         conv_kernel=CONV_KERNEL) -> Join:
    """Join a profiled window's program spans (``Tracer.events()``) with
    its device and host runtime events, and map each replay's device
    events onto ``stage_map``."""
    reqs = by_request(spans)
    by_corr: Dict[int, List[Event]] = {}
    for ev in device:
        by_corr.setdefault(ev[3], []).append(ev)
    launches = sorted(ev for ev in host if ev[2].startswith(GRAPH_LAUNCH))
    starts = [ev[0] for ev in launches]
    copies_rt = sorted(ev for ev in host if ev[2].startswith("cudaMemcpy"))
    copy_starts = [ev[0] for ev in copies_rt]
    total = sum(n for _, _, n in stage_map)
    stage_s = [[0.0, 0.0] for _ in stage_map]
    graph_s = 0.0
    mapped = replays = in_replay = copies = in_order = 0
    lags: List[float] = []
    why = ""
    for rid in sorted(reqs):
        r = reqs[rid]
        rep = r.get("captured.replay")
        if rep is None:
            continue
        replays += 1
        r0, r1 = rep["ts"], rep["ts"] + rep["dur"]
        inside = launches[bisect.bisect_left(starts, r0):
                          bisect.bisect_right(starts, r1)]
        inside = [ev for ev in inside if ev[1] <= r1]
        if len(inside) == 1:
            in_replay += 1
        cin = r.get("captured.copy_in")
        if cin is not None:
            c0, c1 = cin["ts"], cin["ts"] + cin["dur"]
            for rt in copies_rt[bisect.bisect_left(copy_starts, c0):
                                bisect.bisect_right(copy_starts, c1)]:
                for d in by_corr.get(rt[3], ()):
                    if "HtoD" in d[2]:
                        copies += 1
                        in_order += c0 <= d[0] <= r1
        if len(inside) != 1:
            why = why or (f"request {rid}: {len(inside)} graph launches "
                          "inside its replay span")
            continue
        evs = sorted(by_corr.get(inside[0][3], ()))
        if evs:
            lags.append(evs[0][0] - inside[0][0])
        graph_s += sum(e - s for s, e, _, _ in evs) * 1e-6
        if len(evs) != total:
            why = why or (f"request {rid}: {len(evs)} device events, the "
                          f"stage map holds {total}")
            continue
        mapped += 1
        i = 0
        for k, (_, _, n) in enumerate(stage_map):
            for s, e, name, _ in evs[i:i + n]:
                stage_s[k][0] += (e - s) * 1e-6
                if not conv_kernel.search(name):
                    stage_s[k][1] += (e - s) * 1e-6
            i += n
    per = 1e3 / max(mapped, 1)
    stages = [(name, kind, per * stage_s[k][0], per * stage_s[k][1])
              for k, (name, kind, _) in enumerate(stage_map)]
    tenth = max(1, len(lags) // 10)
    return Join(stages=stages, mapped=mapped, replays=replays,
                unmapped_why=why, graph_device_s=graph_s,
                launches_in_replay=in_replay, copies_in_order=in_order,
                copies=copies, idle_by_span=idle_by_span(spans, device),
                launch_lag_us=min(lags) if lags else None,
                clock_drift_us=(min(lags[-tenth:]) - min(lags[:tenth])
                                if lags else None))


def idle_by_span(spans: Sequence[dict],
                 device: Sequence[Event]) -> Dict[str, float]:
    """Idle seconds between the window's device events, each gap put
    down to the innermost program span covering its middle, or
    ``caller`` where the host was in none: ``bench/trace.py``'s gaps and
    innermost host event, with the spans as the host events (sorted so
    that of two spans that start together the enclosing one comes
    first)."""
    from bench import trace

    busy = sorted((s, e) for s, e, _, _ in device)
    if not busy:
        return {}
    _, gaps = trace._union(busy, busy[0][0], max(e for _, e in busy))
    host = sorted(((ev["ts"], ev["ts"] + ev["dur"], ev["name"])
                   for ev in spans), key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        name = trace._host_at(host, starts, 0.5 * (g0 + g1))
        name = "caller" if name == "python" else name
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-6
    return out


def profile_events(prof) -> Tuple[List[Event], List[Event]]:
    """The device events and the host runtime events of a finished
    ``torch.profiler`` profile, as (start us, end us, name, correlation
    id) on the Unix epoch."""
    from torch.autograd import DeviceType

    device: List[Event] = []
    host: List[Event] = []
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            continue
        t = (ev.start_ns() * 1e-3, ev.end_ns() * 1e-3, ev.name(),
             ev.correlation_id())
        (device if ev.device_type() == DeviceType.CUDA else host).append(t)
    return device, host


def setup_seconds(spans: Sequence[dict], name: str) -> Optional[float]:
    """Seconds of every set-up span called ``name``; None without one."""
    durs = [ev["dur"] for ev in spans if ev["name"] == name]
    return 1e-6 * sum(durs) if durs else None


def windows(s, seconds: float):
    """Windows 1-3 (module docstring) on a set-up cell: the three
    :class:`bench.cell.Window`, the spans of windows 2 and 3, the
    profiled window's device and host events, and the captures counted
    inside windows 2 and 3."""
    from torch.profiler import ProfilerActivity, profile

    from bench import cell
    from repro_torch.core import telemetry as tele

    seconds = min(seconds, cell.TRACE_SECONDS)
    ex = s.executor
    captures = ex.registry.counter("captured.captures")
    before = captures.value
    plain = cell.window(s, seconds)
    ex.tracer = t2 = tele.Tracer()
    spans = cell.window(s, seconds, kept=plain.kept)
    ex.tracer = t3 = tele.Tracer()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = cell.window(s, seconds, kept=plain.kept)
    ex.tracer = None
    device, host = profile_events(prof)
    return ((plain, spans, traced), t2.events(), t3.events(), device, host,
            captures.value - before)


def interleaved_cost_us(s, request_s: float, seconds: float = 4.0,
                        calls: int = 20) -> float:
    """The tracing-on cost measured without the windows' drift: blocks
    of ``calls`` requests (each read back where the traffic reads back)
    alternate between ``executor.tracer`` unset and set, in the order
    off-on, on-off, ..., for about ``seconds`` at ``request_s`` seconds
    a request; the median over the pairs of the seconds a request on
    less off, in microseconds."""
    import torch
    from repro_torch.core import telemetry as tele

    ex, pool, order = s.executor, s.pool, s.order
    read_back = s.traffic["read_back"]
    tracer = tele.Tracer()

    def block(tr) -> float:
        ex.tracer = tr
        t0 = time.perf_counter()
        for i in range(calls):
            y = ex(pool[order[i % len(order)]])
            if read_back:
                y.cpu()
        torch.cuda.synchronize(s.device)
        return (time.perf_counter() - t0) / calls

    diffs = []
    for b in range(max(4, int(seconds / (2 * calls * request_s)))):
        if b % 2:
            on = block(tracer)
            off = block(None)
        else:
            off = block(None)
            on = block(tracer)
        diffs.append(on - off)
    ex.tracer = None
    return 1e6 * statistics.median(diffs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the spans are joined with the card's trace",
              file=sys.stderr)
        sys.exit(2)
    from bench import cell, counts
    from repro_torch.core import telemetry as tele

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    _, config, traffic = cell.resolve(bench, args.workload)
    s = cell.Setup(config, traffic, args.seed, torch.device("cuda", 0))
    (w1, w2, w3), spans2, spans3, device, host, captures = windows(
        s, args.seconds)
    shape = tuple(s.pool[s.order[0]].shape)
    stage_map = s.executor.stage_map.get(shape, [])
    j = join(spans3, device, host, stage_map)
    blocks_us = interleaved_cost_us(s, w1.seconds / max(w1.requests, 1))
    setup = tele.get_tracer().events()
    per = [1e6 * w.seconds / max(w.requests, 1) for w in (w1, w2, w3)]
    err = sys.stderr

    print(f"{args.workload} seed {args.seed} on "
          f"{torch.cuda.get_device_name(0)}: windows of {w1.requests}, "
          f"{w2.requests}, {w3.requests} requests; us a request untraced "
          f"{per[0]:.2f}, spans {per[1]:.2f}, profiled {per[2]:.2f}",
          file=err)
    print(f"tracing-on cost {per[1] - per[0]:.3f} us a request (windows 2 "
          f"less 1), {blocks_us:.3f} (interleaved blocks); captures inside "
          f"windows 2 and 3: {captures:g}", file=err)
    print(f"replays mapped {j.mapped} of {j.replays}"
          + (f" ({j.unmapped_why})" if j.unmapped_why else "")
          + f"; replay spans holding one {GRAPH_LAUNCH}: "
          f"{j.launches_in_replay}; host-to-device copies in order "
          f"{j.copies_in_order} of {j.copies}", file=err)
    if j.launch_lag_us is not None:
        print(f"device clock: a graph's first event at least "
              f"{j.launch_lag_us:.2f} us after its launch; drift across the "
              f"window {j.clock_drift_us:+.2f} us"
              + ("; the device clock runs ahead of the host's, so idle by "
                 "span and the copies' order are off" if j.launch_lag_us < 0
                 else ""), file=err)
    weighted = iter(l for l in s.layers if l.op in ("conv", "fc"))
    batch = traffic["batch"]
    print(f"{'stage':<12} {'kind':<8} {'device ms':>10} {'not conv':>9} "
          f"{'ops':>5} {'bound %':>8}", file=err)
    for (name, kind, ms, side), (_, _, n) in zip(j.stages, stage_map):
        share = ""
        if kind in ("conv", "fc"):
            layer = next(weighted, None)
            if layer is not None and ms > 0:
                share = f"{100 * counts.bound_s(layer, batch) * 1e3 / ms:.2f}"
        print(f"{name:<12} {kind:<8} {ms:>10.5f} {side:>9.5f} {n:>5} "
              f"{share:>8}", file=err)
    total_ms = sum(ms for _, _, ms, _ in j.stages)
    print(f"stages {total_ms:.5f} ms a forward; graph events "
          f"{1e3 * j.graph_device_s / max(j.mapped, 1):.5f}", file=err)
    for name, sec in sorted(j.idle_by_span.items(), key=lambda kv: -kv[1]):
        print(f"idle {name} {1e3 * sec / max(w3.requests, 1):.5f} ms a "
              f"request", file=err)
    readings = {
        "copy_in_us": median_us(spans2, "captured.copy_in"),
        "launch_us": median_us(spans2, "captured.replay"),
        "clone_out_us": median_us(spans2, "captured.clone_out"),
        "ingress_ms": j.stage_ms("ingress"),
        "conv_side_ms": j.stage_ms("conv", side=True),
        "quantize_s": setup_seconds(setup, "gate.quantize"),
        "capture_s": setup_seconds(setup, "captured.capture"),
        "tracing_cost_us": per[1] - per[0],
        "tracing_cost_blocks_us": blocks_us,
        "captures_in_windows": captures,
        "replays": j.replays, "mapped": j.mapped,
        "launch_in_replay_share": (j.launches_in_replay / j.replays
                                   if j.replays else None),
        "copies_in_order_share": (j.copies_in_order / j.copies
                                  if j.copies else None),
        "launch_lag_us": j.launch_lag_us, "clock_drift_us": j.clock_drift_us,
        "setup": {n: setup_seconds(setup, n) for n in
                  ("gate.parse", "gate.quantize", "quantize.numpy",
                   "quantize.stage", "quantize.verify", "gate.build",
                   "captured.capture", "kernels.load")},
    }
    s.free_program()
    w1.requests += w2.requests + w3.requests
    found = cell.check(s, w1)
    readings["logits_differing"] = found["logits_differing"]
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      **readings}), flush=True)


if __name__ == "__main__":
    main()

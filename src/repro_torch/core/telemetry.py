"""Per-stage telemetry: a metrics registry + span tracing.

The port's own copy of ``repro.core.telemetry``: the module is
dependency-free, so the port keeps it rather than import the JAX
package.  The port's :class:`Tracer` adds to the reference's a clock
shared with ``torch.profiler`` (spans on the Unix epoch), a request id
and a parent on each span, and a one-tuple hot-path :meth:`Tracer.record`.

CNN2Gate's DSE only works because the tool can *see* where time and
memory go per layer (the paper's Table-1 breakdowns drive the RL
agent).  This module is the observability substrate that turns our
modeled numbers into audited ones:

  * :class:`MetricsRegistry` — thread-safe **counters**, **gauges** and
    fixed-bucket **histograms** with a JSON-ready :meth:`snapshot`.
    Every consumer (guard rungs, DSE evaluations, serve requests)
    counts through one registry, so a single snapshot answers "what
    happened in this process" without log scraping.
  * :class:`Tracer` — **span tracing** exporting Chrome-trace /
    Perfetto-loadable JSON (``trace.json``): complete events
    (``ph="X"``) with ``ts``/``dur`` in microseconds, ``pid``/``tid``,
    a category and free-form ``args``.  Spans nest naturally per
    thread (Perfetto infers nesting from containment on one track).
    Spans measured elsewhere (a request's end-to-end latency, a
    stage's synchronized wall time) are injected via
    :meth:`Tracer.add_span`.

Dependency-free on purpose: the stdlib (``threading``, ``time``,
``json``) is the whole footprint, so the int8 runtime, the DSE sweeps
and the serving loop can all afford always-on telemetry.

Module-level defaults (:func:`get_registry` / :func:`get_tracer`) give
the instrumented consumers a shared sink without threading a handle
through every constructor; tests and CLIs that need isolation pass
their own instances or call :func:`reset`.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Tracer",
    "get_registry", "get_tracer", "reset",
    "DEFAULT_LATENCY_BUCKETS_S",
]

#: Default histogram bucket upper bounds for request/stage latencies in
#: seconds — log-spaced from 100 µs to 100 s (everything above the last
#: edge lands in the +Inf overflow bucket).
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0)


class Counter:
    """Monotonic counter.  ``inc`` is atomic under the registry lock."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc({n}))")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (queue depth, active slots, ...)."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with quantile estimation.

    ``buckets`` are the finite upper bounds, strictly increasing; an
    implicit +Inf bucket catches the overflow.  A value lands in the
    first bucket whose bound is ``>= value`` (inclusive upper edges,
    the Prometheus ``le`` convention).  :meth:`percentile` linearly
    interpolates within the winning bucket, clamped to the observed
    ``[min, max]`` so tiny samples don't report a bucket edge nobody
    measured.
    """

    def __init__(self, lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2
                             in zip(bounds, bounds[1:])):
            raise ValueError("histogram buckets must be a non-empty "
                             "strictly increasing sequence")
        self._lock = lock
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # +Inf overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = 0
            while i < len(self.bounds) and v > self.bounds[i]:
                i += 1
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-th percentile (q in [0, 100]); ``None`` when
        empty.  Overflow-bucket hits report the observed max (the only
        honest number for an unbounded bucket)."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile out of range: {q}")
        with self._lock:
            if self.count == 0:
                return None
            target = q / 100.0 * self.count
            acc = 0
            for i, c in enumerate(self.counts):
                acc += c
                if acc >= target and c:
                    if i >= len(self.bounds):      # +Inf bucket
                        return self.max
                    lo = self.bounds[i - 1] if i else (self.min or 0.0)
                    hi = self.bounds[i]
                    frac = (target - (acc - c)) / c
                    est = lo + (hi - lo) * frac
                    return min(max(est, self.min), self.max)
            return self.max

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return self.sum / self.count if self.count else None


class MetricsRegistry:
    """Named metric namespace.  ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent, so instrumentation sites never race on
    registration); registering one name as two different kinds raises.
    ``snapshot()`` returns a plain JSON-serializable dict — the process
    observability payload the profile report and serve stats embed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                # per-metric lock: hot-path inc/record never contends
                # with unrelated metrics or with registration
                m = self._metrics[name] = kind(threading.Lock(), *args)
            elif type(m) is not kind:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S
                  ) -> Histogram:
        return self._get(name, Histogram, buckets)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                assert isinstance(m, Histogram)
                out["histograms"][name] = {
                    "count": m.count, "sum": m.sum,
                    "min": m.min, "max": m.max, "mean": m.mean,
                    "p50": m.percentile(50), "p95": m.percentile(95),
                    "p99": m.percentile(99),
                    "buckets": list(m.bounds),
                    "bucket_counts": list(m.counts),
                }
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


class Tracer:
    """Span recorder exporting the Chrome trace-event format.

    Spans are **complete events** (``ph="X"``): one record with a start
    timestamp and a duration in microseconds.  Perfetto and
    chrome://tracing load the exported file directly; nesting is
    inferred per ``tid`` from containment, which live :meth:`span`
    blocks guarantee by construction (a nested ``with`` closes before
    its parent).

    **Clocks.**  The hot clock is ``time.perf_counter_ns``.  The tracer
    reads it together with ``time.time_ns()`` at construction and at
    :meth:`reset` (the anchor), and :meth:`events` gives every span's
    ``ts`` in microseconds since the Unix epoch: the clock of
    ``torch.profiler``'s device trace (kineto's ``trace_start_ns()``
    plus an event's relative time), so a span lies on the same
    timeline as the kernels it launched.  :meth:`now_us` and
    :meth:`add_span` keep microseconds since the anchor.

    **Requests.**  Each span may carry a request id (``rid``) and the
    name of the span that caused it (``parent``); both go to ``args``
    when set.  A :meth:`span` block takes as parent the innermost open
    block of the same tracer and thread, and its ``rid`` where it gives
    none.

    **Hot path.**  :meth:`record` takes two ``perf_counter_ns`` readings
    and appends one tuple; the event dict, pid, tid and args are built
    when :meth:`events` or :meth:`export` is called.

    ``max_events`` bounds memory: past it the tracer drops new events
    and counts them in ``dropped`` (an always-on serving loop must
    never grow a trace without limit).
    """

    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        #: (name, cat, t0_ns, t1_ns, rid, parent, args, tid, steps,
        #: stamps) a record
        self._events: List[Tuple] = []
        self._open = threading.local()
        self.max_events = max_events
        self.dropped = 0
        self._anchor()

    def _anchor(self) -> None:
        self._epoch_ns = time.perf_counter_ns()
        self._unix_ns = time.time_ns()

    def now_us(self) -> float:
        """Microseconds since the anchor, on the hot clock."""
        return (time.perf_counter_ns() - self._epoch_ns) * 1e-3

    def record(self, name: str, t0_ns: int, t1_ns: int,
               rid: Optional[int] = None, parent: Optional[str] = None,
               cat: str = "", args: Optional[Dict] = None,
               steps: Sequence[str] = (),
               stamps: Sequence[int] = ()) -> None:
        """Record a span between two ``time.perf_counter_ns()`` readings,
        and, with ``steps``, its children: step ``i`` runs from
        ``stamps[i]`` to ``stamps[i + 1]`` (``stamps`` has one reading
        more than ``steps``), with this span as parent and its ``rid``.
        The hot path: one tuple appended, without a lock (a list append
        is atomic; past ``max_events`` a race may keep a few more)."""
        ev = (name, cat, t0_ns, t1_ns, rid, parent, args,
              threading.get_ident(), steps, stamps)
        self._append(ev)

    def _append(self, ev: Tuple) -> None:
        events = self._events
        if len(events) < self.max_events:
            events.append(ev)
        else:
            with self._lock:
                self.dropped += 1

    def add_span(self, name: str, ts_us: float, dur_us: float,
                 cat: str = "", args: Optional[Dict] = None,
                 tid: Optional[int] = None) -> None:
        """Record an externally-timed span (e.g. a request's latency
        measured by the serving loop); ``ts_us`` is :meth:`now_us`'s."""
        t0 = self._epoch_ns + round(ts_us * 1e3)
        ev = (name, cat, t0, t0 + round(dur_us * 1e3), None, None,
              dict(args) if args else None,
              int(tid) if tid is not None else threading.get_ident(),
              (), ())
        self._append(ev)

    @contextmanager
    def span(self, name: str, cat: str = "",
             args: Optional[Dict] = None, rid: Optional[int] = None):
        """Time a block and record it as one complete event.  The span
        is recorded even when the block raises (with ``error`` in its
        args) — a failed DSE evaluation still shows up in the trace."""
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        parent = None
        if stack:
            parent = stack[-1][0]
            rid = stack[-1][1] if rid is None else rid
        stack.append((name, rid))
        t0 = time.perf_counter_ns()
        err: Optional[str] = None
        try:
            yield self
        except BaseException as e:
            err = f"{type(e).__name__}: {e}"
            raise
        finally:
            t1 = time.perf_counter_ns()
            stack.pop()
            a = dict(args) if args else {}
            if err is not None:
                a["error"] = err
            self.record(name, t0, t1, rid, parent, cat, a or None)

    def events(self) -> List[Dict]:
        """Every span as a Chrome-trace complete event, ``ts`` in
        microseconds since the Unix epoch."""
        with self._lock:
            raw = list(self._events)
        base = self._unix_ns - self._epoch_ns
        pid = os.getpid()
        out = []

        def emit(name, cat, t0, t1, rid, parent, args, tid):
            ev = {"name": name, "cat": cat, "ph": "X",
                  "ts": (t0 + base) * 1e-3, "dur": (t1 - t0) * 1e-3,
                  "pid": pid, "tid": tid}
            if args or rid is not None or parent is not None:
                a = dict(args) if args else {}
                if rid is not None:
                    a["rid"] = rid
                if parent is not None:
                    a["parent"] = parent
                ev["args"] = a
            out.append(ev)

        for (name, cat, t0, t1, rid, parent, args, tid, steps,
             stamps) in raw:
            emit(name, cat, t0, t1, rid, parent, args, tid)
            for i, step in enumerate(steps):
                emit(step, cat, stamps[i], stamps[i + 1], rid, name, None,
                     tid)
        return out

    def to_chrome_trace(self) -> Dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write ``trace.json`` (load it in Perfetto / chrome://tracing).
        Returns the path."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
        return path

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._anchor()


# ------------------------------------------------- module-level defaults

_registry = MetricsRegistry()
_tracer = Tracer()


def get_registry() -> MetricsRegistry:
    """The process-default registry (what instrumented consumers use
    when not handed an explicit one)."""
    return _registry


def get_tracer() -> Tracer:
    """The process-default tracer."""
    return _tracer


def reset() -> None:
    """Clear the default registry and tracer (test isolation)."""
    _registry.reset()
    _tracer.reset()

"""The device trace of one measured window, reduced to what the
per-layer readers (``bench/metrics/<name>.py``) read.

The window runs under ``torch.profiler`` with the CUDA activity alone,
started before the window's first request and stopped after its last
synchronize, so every device event (kernel, copy, set) of the profile
is the window's.  The window's length is the host clock's.  The device
is busy where at least one event runs.  An idle gap between two device
events is named by the innermost CUDA runtime or driver call that
covers its middle (the profiler records those with the CUDA activity),
or ``python`` where the host was in none; the idle time before the
first and after the last device event is named :data:`EDGES`.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

#: the name of the idle time at the window's two ends
EDGES = "window edges"


@dataclasses.dataclass
class Trace:
    """One traced window.  ``requests`` is the executor calls it holds,
    ``per_request`` the counts of one call
    (:func:`bench.counts.forward_counts`)."""

    window_s: float
    busy_s: float
    device_s: Dict[str, float]       # seconds in the window, by event name
    idle_by_host: Dict[str, float]   # idle seconds, by host activity
    requests: int
    per_request: Dict[str, float]
    #: seconds a request of an untraced window of the same run, where the
    #: profiler does not stretch the host path
    request_s: Optional[float] = None

    def device_seconds(self, pattern: str) -> float:
        """Device seconds of every event whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.device_s.items() if rx.search(name))

    @property
    def total_device_s(self) -> float:
        return sum(self.device_s.values())

    def roofline(self, pattern: str, bound_key: str) -> Optional[float]:
        """Percent: the summed bounds of the calls over the device time
        of the kernels named by ``pattern``; None where none ran."""
        t = self.device_seconds(pattern)
        if t <= 0 or not self.requests:
            return None
        return 100.0 * self.requests * self.per_request[bound_key] / t

    def breakdown(self, top: int = 10) -> dict:
        def largest(d):
            return [[short(k), v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": largest(self.device_s),
                "idle_gaps": largest(self.idle_by_host)}


def read(prof, window_s: float, requests: int,
         per_request: Dict[str, float],
         request_s: Optional[float] = None) -> Optional[Trace]:
    """The :class:`Trace` of a finished profile of a window that lasted
    ``window_s`` seconds on the host clock, or None when it holds no
    device event (a trace that came back empty)."""
    from torch.autograd import DeviceType

    device: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    for ev in prof.events():
        if getattr(ev, "is_user_annotation", False):
            continue
        span = (ev.time_range.start, ev.time_range.end, ev.name)
        (device if ev.device_type == DeviceType.CUDA else host).append(span)
    return reduce(device, host, window_s, requests, per_request, request_s)


def reduce(device: List[Tuple[float, float, str]],
           host: List[Tuple[float, float, str]], window_s: float,
           requests: int, per_request: Dict[str, float],
           request_s: Optional[float] = None) -> Optional[Trace]:
    """A :class:`Trace` from the device and host events of a window, as
    (start, end, name) in microseconds; None without a device event."""
    if not device:
        return None
    device_s: Dict[str, float] = {}
    for s, e, n in device:
        device_s[n] = device_s.get(n, 0.0) + (e - s) * 1e-6
    spans = sorted((s, e) for s, e, _ in device)
    w0, w1 = spans[0][0], max(e for _, e in spans)
    busy, gaps = _union(spans, w0, w1)
    host = sorted(host)
    starts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    for s, e in gaps:
        name = _host_at(host, starts, 0.5 * (s + e))
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    edges = window_s - (w1 - w0) * 1e-6
    if edges > 0:
        idle[EDGES] = edges
    return Trace(window_s=window_s, busy_s=busy * 1e-6, device_s=device_s,
                 idle_by_host=idle, requests=requests,
                 per_request=per_request, request_s=request_s)


def short(name: str, width: int = 160) -> str:
    """A kernel's name without ``void`` and anonymous namespaces, cut to
    ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


def _union(intervals, w0: float, w1: float):
    """Length of the union of sorted intervals, and the gaps between
    them inside [w0, w1] (microseconds)."""
    busy = 0.0
    gaps = []
    cur_s, cur_e = None, w0
    for s, e in intervals:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    return busy, gaps


def _host_at(host, starts, t: float, look_back: int = 256) -> str:
    """The innermost host event running at ``t``: of those that started
    before it and have not ended, the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - look_back), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "python"

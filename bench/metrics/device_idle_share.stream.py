"""device_idle_share.stream: percent of an untraced request's wall in
which no kernel, copy or set runs on the device: one less the traced
window's device busy seconds a request over the seconds a request of
the run's untraced window.  Where the host paces the requests, the
profiler's host cost stretches the traced window, and the idle share
of that window would count the profiler's time as the device's."""


def read(t):
    if not t.requests or t.busy_s <= 0 or not t.request_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.requests / t.request_s)

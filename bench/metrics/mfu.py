"""mfu: percent of the card's int8 peak that the whole forward reaches:
the int8 operations of one request (two per multiply-accumulate of
every conv and FC, from the configuration's shapes) over the seconds a
request of the run's untraced window, times 1,979 TOP/s.  The untraced
window's seconds, and not the traced window's, which the profiler
stretches where the host paces the requests."""
from bench import counts


def read(t):
    if not t.request_s or t.request_s <= 0:
        return None
    return 100.0 * t.per_request["ops"] / (t.request_s * counts.INT8_OPS_PER_S)

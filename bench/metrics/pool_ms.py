"""pool_ms: device milliseconds per forward of the standalone pool
stages (``kernels.ops`` maxpool2d_nhwc and avgpool2d_nhwc, torch ops in
the captured graph): the events whose name matches ``reduce_kernel`` or
``pool``.

In the cells that list it, torch's reductions run only in those stages:
the ingress, the conv stages' pads and the egress are elementwise
kernels and copies (the stage map of ``bench/spans.py`` shows it on the
card).  The pad of a padded max-pool and the GAP's rounding divide are
elementwise kernels too and are not counted: the metric reads the
windows' reductions.  A hand-written kernel that later takes these
stages keeps ``pool`` in its name, so that the metric reads the same
work whatever implements it.  0 where no such event ran; None without a
request."""


def read(t):
    if not t.requests:
        return None
    return 1e3 * t.device_seconds(r"reduce_kernel|pool") / t.requests

"""qdwconv_roofline: percent of the depthwise conv calls' summed bounds
(ops at the int8 peak or bytes at HBM bandwidth, whichever is longer;
``dwconv_bound_s`` of the family's counts) over the device time of the
depthwise kernel (``csrc/qdwconv.cu``), the share of that route alone
inside ``qconv_roofline``.  The padded copy its wrapper makes before
each padded launch is not the kernel's time: ``other_device_ms`` holds
it.  0 in a configuration without a depthwise conv (no bound to meet,
as ``pool_ms`` reads 0 without a pool); None without a request, or where
such a configuration's trace holds no depthwise kernel."""


def read(t):
    if not t.requests:
        return None
    if not t.per_request.get("dwconv_bound_s"):
        return 0.0
    return t.roofline(r"qdwconv", "dwconv_bound_s")

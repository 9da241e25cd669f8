"""qgconv_roofline: percent of the grouped conv calls' summed bounds (ops
at the int8 peak or bytes at HBM bandwidth, whichever is longer, each
call with its K = KH * KW * Cin/G; ``gconv_bound_s`` of the family's
counts) over the device time of the grouped conv kernel
(``csrc/qconv.cu``'s ``qconv_grouped_wgmma_kernel``), the share of that
route alone inside ``qconv_roofline``.  0 in a configuration without a
grouped conv (no bound to meet, as ``qdwconv_roofline`` reads 0 without
a depthwise conv); None without a request, or where such a
configuration's trace holds no grouped kernel (a program that launches
its grouped convs under the dense kernel's name)."""


def read(t):
    if not t.requests:
        return None
    if not t.per_request.get("gconv_bound_s"):
        return 0.0
    return t.roofline(r"qconv_grouped", "gconv_bound_s")

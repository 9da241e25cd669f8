"""qconv_roofline: percent of the conv calls' summed bounds (ops at the
int8 peak or bytes at HBM bandwidth, whichever is longer) over the
device time of the int8 conv kernels (``csrc/qconv.cu``,
``csrc/qdwconv.cu``)."""


def read(t):
    return t.roofline(r"qconv|qdwconv", "conv_bound_s")

"""qgemm_roofline: percent of the FC calls' summed bounds (ops at the
int8 peak or bytes at HBM bandwidth, whichever is longer) over the
device time of the int8 GEMM kernels (``csrc/qgemm.cu``)."""


def read(t):
    return t.roofline(r"qgemm", "fc_bound_s")

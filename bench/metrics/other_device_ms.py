"""other_device_ms: device milliseconds per forward of every
device event that is neither an int8 conv nor an int8 GEMM kernel: the
ingress, pads, copies and the clone of the logits."""


def read(t):
    if not t.requests:
        return None
    rest = (t.total_device_s - t.device_seconds(r"qconv|qdwconv")
            - t.device_seconds(r"qgemm"))
    return 1e3 * rest / t.requests

"""transfer_ms: device milliseconds of the host-to-device and
device-to-host copies of one request (the image in, the logits out)."""


def read(t):
    s = t.device_seconds(r"Memcpy (HtoD|DtoH)")
    return 1e3 * s / t.requests if s > 0 and t.requests else None

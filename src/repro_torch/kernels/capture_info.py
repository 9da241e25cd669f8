"""The device operations of a CUDA graph under capture.

:func:`captured_ops` calls the host entry of ``csrc/capture_info.cu``
(``cudaStreamGetCaptureInfo``, ``cudaGraphGetNodes``,
``cudaGraphNodeGetType``) on PyTorch's current stream, which must be
capturing: the kernel, memcpy and memset nodes the graph holds so far.
The captured executor reads it after each stage of the forward it
captures (``CapturedExecutor.stage_map``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

from . import _build

_SIGNATURES = {"captured_op_counts": [ctypes.c_void_p, ctypes.c_void_p]}


def load() -> ctypes.CDLL:
    """The C entry's library, built and loaded on the first call: call
    it before a capture begins."""
    return _build.load("capture_info", _SIGNATURES)


def captured_ops(device) -> Tuple[int, int, int]:
    """(kernels, memcpys, memsets) in the graph that the current stream
    on ``device`` is capturing into; raises when it is not capturing."""
    lib = load()
    counts = (ctypes.c_longlong * 3)()
    _build.check(lib.captured_op_counts(_build.stream(device),
                                        ctypes.cast(counts, ctypes.c_void_p)),
                 "captured_op_counts")
    return tuple(counts)

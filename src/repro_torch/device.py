"""Device selection and float32 precision for the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and there
    is no card, so no entry point ever falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Run float32 convolutions and matrix products in full float32.

    cuDNN convolutions default to TF32 on the card
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about
    three decimal digits and would move the max-abs calibration
    exponents off the float32 reference's.  Both TF32 switches are
    turned off inside the block and restored after it."""
    cudnn_prev = torch.backends.cudnn.allow_tf32
    mm_prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_prev
        torch.backends.cuda.matmul.allow_tf32 = mm_prev

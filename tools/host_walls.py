#!/usr/bin/env python3
"""Batch-1 wall time and host enqueue time of the int8 CNN path, for the
checkout at each path given (default: this one), in turns.

    python3 tools/host_walls.py OTHER_CHECKOUT . . OTHER_CHECKOUT

Each path runs in its own process (``src/`` of that path on
``sys.path``): VGG-16, mobilenet_tiny@224 and ResNet-18 (per-tensor and
per-channel) at batch 1, the median and least of 30 synchronized
forwards, the host's time to enqueue a forward while the card sleeps,
and the host microseconds a ``qconv2d`` call takes to enqueue at two
shapes.  One JSON line a path.
Needs a CUDA card; :func:`measure` also runs on the CPU (no sleep, so
its enqueue times are walls there), which is how it is tested.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: (name, builder name in ``repro_torch.models.cnn``, keywords, input hw,
#: per-channel weight scales)
MODELS = (("vgg16", "vgg16", {}, 224, False),
          ("mobilenet_tiny", "mobilenet_tiny", {"in_hw": 224}, 224, False),
          ("resnet18", "resnet18", {}, 224, False),
          ("resnet18_per_channel", "resnet18", {}, 224, True))
#: (name, NHWC input, HWIO weight, pool) of the timed conv calls
CONVS = (("conv_14x512_pool", (1, 16, 16, 512), (3, 3, 512, 512), (2, 2)),
         ("conv_56x64_1x1", (1, 56, 56, 64), (1, 1, 64, 64), None))


def measure(root: str, device: str = "cuda", models=MODELS, convs=CONVS,
            runs: int = 30, calls: int = 200) -> dict:
    sys.path.insert(0, str(Path(root) / "src"))
    import numpy as np
    import torch
    from repro_torch.core.synthesis import CNN2Gate
    from repro_torch.kernels import qconv
    from repro_torch.models import cnn
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def enqueue_s(fn, n: int) -> float:
        """Seconds a call of ``fn`` takes to enqueue behind a sleeping
        card, so that no wait for the card is in it."""
        sync()
        if cuda:
            torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n
        sync()
        return t

    out = {"tree": root}
    for name, builder, kw, hw, per_channel in models:
        rng = np.random.default_rng(1)
        gate = CNN2Gate.from_graph(
            getattr(cnn, builder)(batch=1, seed=0, **kw), device=dev)
        gate.calibrate_quantization(
            rng.standard_normal((1, 3, hw, hw)).astype(np.float32),
            per_channel=per_channel)
        run = gate.build("fullflow")
        x = torch.as_tensor(rng.standard_normal((1, 3, hw, hw))
                            .astype(np.float32), device=dev)
        for _ in range(5):
            run(x)
        ts = []
        for _ in range(runs):
            sync()
            t0 = time.perf_counter()
            run(x)
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(wall_ms_median=statistics.median(ts),
                         wall_ms_min=min(ts),
                         enqueue_ms=enqueue_s(lambda: run(x), 10) * 1e3)
    for tag, xs, ws, pool in convs:
        x = torch.randint(-128, 128, xs, dtype=torch.int8, device=dev)
        w = torch.randint(-128, 128, ws, dtype=torch.int8, device=dev)
        b = torch.zeros(ws[-1], dtype=torch.int32, device=dev)
        kw = ({"w_k": qconv.stage_kmajor(w)}
              if hasattr(qconv, "stage_kmajor") else {})

        def call():
            qconv.qconv2d(x, w, b, shift=10, pool=pool, **kw)
        for _ in range(10):
            call()
        out[tag + "_enqueue_us"] = enqueue_s(call, calls) * 1e6
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    for root in sys.argv[1:] or ["."]:
        r = subprocess.run([sys.executable, __file__, "--one", root])
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())

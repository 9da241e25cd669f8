#!/usr/bin/env python3
"""Drive the PyTorch port of CNN2Gate on one CUDA card.

    python3 chip_smoke.py

Three phases, each printing one JSON line per check:

1. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together) and hold each kernel bit-exact
   (``torch.equal``) against its plain PyTorch version on the card, at
   the main path's shapes and at ragged ones;
2. VGG-16 at full width (224x224, 1000 classes, 138 M random weights
   from a seed): ``CNN2Gate.from_graph`` -> ``calibrate_quantization`` ->
   ``build``, then serve 8 requests at batch 1 and one batch of 8.  The
   logits must equal those of the same executor with the plain ops, and
   every forward must launch the conv kernel 13 times and the GEMM
   kernel 3 times;
3. ResNet-18 at full width and googlenet_tiny, fused and unfused,
   per-tensor and per-channel: fused == unfused and kernel == plain.

Before the last line it prints the kernels' record (launches, error,
times, bounds) as one JSON object, then the card's name and power limit
from ``nvidia-smi``.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check exits non-zero without it, as does a run with no CUDA
or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak, same source
SEED = 0
TIME_REPS = 20

FAILED: list = []


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def check(phase: str, name: str, ok: bool, **extra) -> None:
    emit(phase=phase, check=name, ok=bool(ok), **extra)
    if not ok:
        FAILED.append(f"{phase}/{name}")


@contextlib.contextmanager
def guarded(phase: str):
    try:
        yield
    except Exception as e:  # a phase that raises fails the run, loudly
        traceback.print_exc()
        check(phase, "raised", False, error=f"{type(e).__name__}: {e}")


# --------------------------------------------------------------- helpers

def rand_i8(torch, shape, gen, dev):
    return torch.randint(-128, 128, shape, dtype=torch.int8, device=dev,
                         generator=gen)


def rand_bias(torch, n, gen, dev):
    return torch.randint(-(1 << 20), 1 << 20, (n,), dtype=torch.int32,
                         device=dev, generator=gen)


def shift_for(k: int) -> int:
    """A requant shift that keeps random int8 sums of depth k mostly
    inside int8 (std of one product is about 5461)."""
    return max(0, min(31, int(math.log2(5461 * math.sqrt(k) / 40))))


def time_ms(torch, fn, reps: int = TIME_REPS, flush=None) -> float:
    """Median device time of one call, by CUDA events around each call.
    ``flush`` runs between calls, outside the timed window, so each call
    finds the L2 cache cold as a forward pass does.  A spin of about a
    millisecond on the device before each window lets the host enqueue
    the whole call first, so the window holds the call's kernels and
    not the host's time to launch them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@contextlib.contextmanager
def plain_ops():
    """Route the executor's kernel calls to the plain versions (on the
    same device) for the duration of the block."""
    from repro_torch.kernels import qconv, qgemm
    saved = qconv.qconv2d, qgemm.qgemm
    qconv.qconv2d, qgemm.qgemm = qconv.qconv2d_plain, qgemm.qgemm_plain
    try:
        yield
    finally:
        qconv.qconv2d, qgemm.qgemm = saved


@contextlib.contextmanager
def recorded_calls(calls: list):
    """Record (kernel name, args, kwargs) of every kernel wrapper call the
    executor makes inside the block."""
    from repro_torch.kernels import qconv, qgemm
    saved = qconv.qconv2d, qgemm.qgemm

    def rec_conv(*a, **kw):
        calls.append(("qconv2d_into" if kw.get("out_buf") is not None
                      else "qconv2d", a, kw))
        return saved[0](*a, **kw)

    def rec_gemm(*a, **kw):
        calls.append(("qgemm", a, kw))
        return saved[1](*a, **kw)

    qconv.qconv2d, qgemm.qgemm = rec_conv, rec_gemm
    try:
        yield
    finally:
        qconv.qconv2d, qgemm.qgemm = saved


# ------------------------------------------------------ phase 1: kernels

def gemm_cases():
    vgg_fc = [(25088, 4096, True), (4096, 4096, True), (4096, 1000, False)]
    cases = []
    for m in (1, 8):
        for k, n, relu in vgg_fc:
            cases.append(dict(m=m, k=k, n=n, relu=relu, per_col=False))
    cases += [dict(m=37, k=1001, n=130, relu=True, per_col=False),
              dict(m=3, k=77, n=10, relu=False, per_col=True),
              dict(m=8, k=4096, n=1000, relu=True, per_col=True),
              dict(m=64, k=515, n=2049, relu=False, per_col=False),
              dict(m=5, k=33, n=7, relu=True, per_col=False, shift=0)]
    return cases


def conv_cases():
    # name, N, H(unpadded), Cin, Cout, k, stride, pad, pool, extras
    return [
        dict(name="vgg_224x3_64", n=1, h=224, cin=3, cout=64, k=3, s=1, p=1),
        dict(name="vgg_224x64_64_pool", n=1, h=224, cin=64, cout=64, k=3,
             s=1, p=1, pool=(2, 2)),
        dict(name="vgg_56x256_256", n=1, h=56, cin=256, cout=256, k=3, s=1,
             p=1),
        dict(name="vgg_14x512_512_pool", n=1, h=14, cin=512, cout=512, k=3,
             s=1, p=1, pool=(2, 2)),
        dict(name="alexnet_conv1_pool3s2", n=1, h=224, cin=3, cout=64, k=11,
             s=4, p=2, pool=(3, 2)),
        dict(name="stride2_batch2", n=2, h=33, cin=16, cout=32, k=3, s=2,
             p=1),
        dict(name="cout130_cin6", n=2, h=19, cin=6, cout=130, k=3, s=1, p=1,
             relu=False),
        dict(name="per_lane_shift", n=1, h=28, cin=64, cout=96, k=3, s=1,
             p=1, per_lane=True, pool=(2, 2)),
        dict(name="skip_with_pool", n=2, h=30, cin=32, cout=48, k=3, s=1,
             p=1, skip=True, pool=(2, 2)),
        dict(name="skip_per_lane_1x1_s2", n=1, h=56, cin=64, cout=128, k=1,
             s=2, p=0, skip=True, per_lane=True),
    ]


def conv_inputs(torch, c, gen, dev):
    hp = c["h"] + 2 * c["p"]
    x = rand_i8(torch, (c["n"], hp, hp, c["cin"]), gen, dev)
    w = rand_i8(torch, (c["k"], c["k"], c["cin"], c["cout"]), gen, dev)
    b = rand_bias(torch, c["cout"], gen, dev)
    s = shift_for(c["k"] * c["k"] * c["cin"])
    if c.get("per_lane"):
        shift = tuple(int(v) for v in np.clip(
            s + np.random.default_rng(len(c["name"])).integers(
                -3, 4, c["cout"]), 0, 31))
    else:
        shift = s
    kw = dict(strides=(c["s"], c["s"]), shift=shift,
              relu=c.get("relu", True), pool=c.get("pool"))
    if c.get("skip"):
        ho = (hp - c["k"]) // c["s"] + 1
        kw.update(skip=rand_i8(torch, (c["n"], ho, ho, c["cout"]), gen, dev),
                  skip_shifts=(1, 0), merge_shift=1, merge_relu=True)
    return x, w, b, kw


def phase_kernels(torch, dev):
    from repro_torch.kernels import _build, qconv, qgemm

    t0 = time.perf_counter()
    secs = _build.build_all()
    emit(phase="build", seconds=round(time.perf_counter() - t0, 3),
         per_source={k: round(v, 3) for k, v in secs.items()},
         sources=sorted(str(p.relative_to(ROOT))
                        for p in _build.sources().values()))
    for name in _build.sources():
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        emit(phase="build", kernel=name, ptxas=lines)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    for c in gemm_cases():
        x = rand_i8(torch, (c["m"], c["k"]), gen, dev)
        w = rand_i8(torch, (c["k"], c["n"]), gen, dev)
        b = rand_bias(torch, c["n"], gen, dev)
        s = c.get("shift", shift_for(c["k"]))
        shift = (tuple(int(v) for v in np.clip(
            s + np.random.default_rng(c["n"]).integers(-3, 4, c["n"]), 0, 31))
            if c["per_col"] else s)
        y = qgemm.qgemm(x, w, b, shift=shift, relu=c["relu"])
        yp = qgemm.qgemm_plain(x, w, b, shift=shift, relu=c["relu"])
        torch.cuda.synchronize()
        err = (y.int() - yp.int()).abs().max().item()
        check("kernels", f"qgemm_{c['m']}x{c['k']}x{c['n']}"
              f"{'_percol' if c['per_col'] else ''}"
              f"{'_relu' if c['relu'] else ''}", torch.equal(y, yp),
              max_abs_err=err, distinct_values=int(torch.unique(yp).numel()))

    for c in conv_cases():
        x, w, b, kw = conv_inputs(torch, c, gen, dev)
        y = qconv.qconv2d(x, w, b, **kw)
        yp = qconv.qconv2d_plain(x, w, b, **kw)
        torch.cuda.synchronize()
        err = (y.int() - yp.int()).abs().max().item()
        check("kernels", f"qconv2d_{c['name']}", torch.equal(y, yp),
              shape=list(y.shape), max_abs_err=err,
              distinct_values=int(torch.unique(yp).numel()))

    sweep(torch, gen, dev)

    # out_buf: non-zero offset, ragged Cout, sentinel sibling channels
    for n, h, cin, cout, off, c_tot, pool in ((2, 20, 12, 30, 17, 70, (2, 2)),
                                              (1, 24, 16, 10, 22, 32, None)):
        x = rand_i8(torch, (n, h + 2, h + 2, cin), gen, dev)
        w = rand_i8(torch, (3, 3, cin, cout), gen, dev)
        b = rand_bias(torch, cout, gen, dev)
        oh = h // 2 if pool else h
        sentinel = torch.full((n, oh, oh, c_tot), 77, dtype=torch.int8,
                              device=dev)
        kw = dict(strides=(1, 1), shift=shift_for(9 * cin), relu=True,
                  pool=pool, concat_shift=1, concat_relu=True)
        buf = qconv.qconv2d(x, w, b, out_buf=sentinel.clone(), out_off=off,
                            **kw)
        bufp = qconv.qconv2d_plain(x, w, b, out_buf=sentinel.clone(),
                                   out_off=off, **kw)
        torch.cuda.synchronize()
        others = torch.cat([buf[..., :off], buf[..., off + cout:]], dim=-1)
        check("kernels", f"qconv2d_into_off{off}_cout{cout}_ctot{c_tot}",
              torch.equal(buf, bufp) and bool((others == 77).all()),
              max_abs_err=(buf.int() - bufp.int()).abs().max().item())


def sweep(torch, gen, dev, cases: int = 40) -> None:
    """Seeded random shapes and epilogue modes, each kernel call held
    bit-exact against its plain version."""
    from repro_torch.kernels import qconv, qgemm
    rng = np.random.default_rng(SEED + 7)
    bad = []
    for i in range(cases):
        m, k, n = (int(rng.integers(1, 70)), int(rng.integers(1, 3000)),
                   int(rng.integers(1, 1500)))
        x, w = rand_i8(torch, (m, k), gen, dev), rand_i8(torch, (k, n), gen, dev)
        b = rand_bias(torch, n, gen, dev) if rng.random() < 0.8 else None
        s = shift_for(k)
        shift = (tuple(int(v) for v in rng.integers(0, s + 3, n))
                 if rng.random() < 0.4 else s)
        relu = bool(rng.random() < 0.5)
        if not torch.equal(qgemm.qgemm(x, w, b, shift=shift, relu=relu),
                           qgemm.qgemm_plain(x, w, b, shift=shift, relu=relu)):
            bad.append(("qgemm", i, m, k, n))
    for i in range(cases):
        kk = int(rng.choice([1, 2, 3, 5, 7]))
        st = int(rng.choice([1, 1, 2, 3]))
        nb = int(rng.integers(1, 4))
        cin = int(rng.choice([1, 3, 4, 5, 8, 12, 16, 33, 64]))
        cout = int(rng.choice([1, 3, 8, 17, 64, 65, 100]))
        hp = int(rng.integers(kk, 40))
        ho = (hp - kk) // st + 1
        pool = [None, (2, 2), (3, 2), (2, 1), (3, 3)][int(rng.integers(5))]
        if pool is not None and ho < pool[0]:
            pool = None
        x = rand_i8(torch, (nb, hp, hp, cin), gen, dev)
        w = rand_i8(torch, (kk, kk, cin, cout), gen, dev)
        b = rand_bias(torch, cout, gen, dev) if rng.random() < 0.8 else None
        s = shift_for(kk * kk * cin)
        kw = dict(strides=(st, st), relu=bool(rng.random() < 0.7), pool=pool,
                  shift=(tuple(int(v) for v in rng.integers(0, s + 3, cout))
                         if rng.random() < 0.4 else s))
        if rng.random() < 0.4:
            kw.update(skip=rand_i8(torch, (nb, ho, ho, cout), gen, dev),
                      skip_shifts=tuple(int(v) for v in rng.integers(0, 3, 2)),
                      merge_shift=int(rng.integers(0, 3)),
                      merge_relu=bool(rng.random() < 0.5))
        if rng.random() < 0.4:
            oh = ho if pool is None else (ho - pool[0]) // pool[1] + 1
            off = int(rng.integers(0, 9))
            fill = torch.full((nb, oh, oh, off + cout + int(rng.integers(0, 9))),
                              -5, dtype=torch.int8, device=dev)
            kw.update(out_buf=fill, out_off=off,
                      concat_shift=int(rng.integers(0, 3)),
                      concat_relu=bool(rng.random() < 0.5))
            y = qconv.qconv2d(x, w, b, **dict(kw, out_buf=fill.clone()))
            yp = qconv.qconv2d_plain(x, w, b, **dict(kw, out_buf=fill.clone()))
        else:
            y = qconv.qconv2d(x, w, b, **kw)
            yp = qconv.qconv2d_plain(x, w, b, **kw)
        if not torch.equal(y, yp):
            bad.append(("qconv2d", i, nb, hp, cin, cout, kk, st, pool,
                        "skip" in kw, "out_buf" in kw))
    torch.cuda.synchronize()
    check("kernels", f"random_sweep_{cases}_gemm_{cases}_conv", not bad,
          failures=bad[:10])


# ------------------------------------------------ phase 2/3: the network

def serve(torch, gate, xs, expect, phase, name):
    """Run each request through the gate's executor; check the launch
    counts of every forward; return (logits list, per-request ms)."""
    from repro_torch.kernels import ops
    run = gate.build("fullflow")
    emit(phase=phase, model=name, synthesis_s=round(gate.synthesis_time_s, 3))
    outs, ms = [], []
    for i, x in enumerate(xs):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = run(x)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        check(phase, f"{name}_launches_request{i}_batch{x.shape[0]}",
              all(counts[k] == v for k, v in expect.items()),
              counts=counts, expected=expect)
        outs.append(y)
    return run, outs, ms


def kernel_records(torch, run, x, launches, dev, phase):
    """Hold every kernel call one forward makes equal to its plain
    version at that call's shapes and time both; return per-kernel sums
    and bounds.  ``library_ms`` stays
    None: PyTorch has no int8 conv, and ``torch._int_mm`` takes no
    M <= 16 (see :func:`library_yardstick`)."""
    from repro_torch.kernels import qconv, qgemm
    calls: list = []
    with recorded_calls(calls):
        run(x)
    torch.cuda.synchronize()
    flush_buf = torch.empty(96 << 20, dtype=torch.int8, device=dev)
    flush = flush_buf.zero_
    kernel = {"qgemm": qgemm.qgemm, "qconv2d": qconv.qconv2d,
              "qconv2d_into": qconv.qconv2d}
    plain = {"qgemm": qgemm.qgemm_plain, "qconv2d": qconv.qconv2d_plain,
             "qconv2d_into": qconv.qconv2d_plain}
    rec = {}
    for name, a, kw in calls:
        r = rec.setdefault(name, dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0,
                                      library_ms=None, calls=0, err=0))
        if name == "qgemm":
            xx, ww = a[0], a[1]
            m, k = xx.shape
            n = ww.shape[1]
            r["bytes"] += m * k + k * n + 4 * n + m * n
            r["ops"] += 2 * m * k * n
        else:
            xx, ww = a[0], a[1]
            nb, hp, wp, cin = xx.shape
            kh, kw_, _, cout = ww.shape
            sh, sw = kw["strides"]
            ho, wo = (hp - kh) // sh + 1, (wp - kw_) // sw + 1
            pool = kw.get("pool")
            oh, ow = ((ho - pool[0]) // pool[1] + 1,
                      (wo - pool[0]) // pool[1] + 1) if pool else (ho, wo)
            r["bytes"] += (xx.numel() + ww.numel() + 4 * cout
                           + nb * oh * ow * cout)
            if kw.get("skip") is not None:
                r["bytes"] += kw["skip"].numel()
            r["ops"] += 2 * nb * ho * wo * cout * kh * kw_ * cin
        y = kernel[name](*a, **kw)
        yp = plain[name](*[t.clone() if torch.is_tensor(t) else t
                           for t in a],
                         **{k: (v.clone() if torch.is_tensor(v) else v)
                            for k, v in kw.items()})
        err = (y.int() - yp.int()).abs().max().item()
        check(phase, f"{name}_call{r['calls']}_equals_plain", err == 0,
              max_abs_err=err)
        r["err"] = max(r["err"], err)
        ms = time_ms(torch, lambda: kernel[name](*a, **kw), flush=flush)
        plain_ms = time_ms(torch, lambda: plain[name](*a, **kw), flush=flush)
        emit(phase="timing", kernel=name, call=r["calls"],
             shapes=[list(t.shape) for t in a if torch.is_tensor(t)],
             pool=kw.get("pool"), skip=kw.get("skip") is not None,
             ms=ms, plain_ms=plain_ms)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["calls"] += 1
    out = {}
    for name, r in rec.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / INT8_OPS_PER_S * 1e3
        out[name] = dict(launches=launches.get(name, 0),
                         calls_timed=r["calls"], max_abs_err=r["err"],
                         ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         library_ms=r["library_ms"])
    return out


def device_time(torch, fn, wall_ms: float) -> dict:
    """Device time of one call by kernel name, from ``torch.profiler``,
    and its share of the call's wall time measured without the
    profiler (the device's busy share; the rest is idle)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:   # no CUPTI on this host: say so
        return dict(device_ms="not measured", profiler_error=str(e))
    from torch.autograd import DeviceType
    # Only the device's own rows (kernels, copies, sets), as the
    # profiler's table sums them: a CPU op's row repeats the device time
    # of the kernels it launched.
    per_kernel: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        per_kernel[ev.key] = (per_kernel.get(ev.key, 0.0)
                              + ev.self_device_time_total / 1e3)
    device_ms = sum(per_kernel.values())
    if not device_ms:
        return dict(device_ms="not measured",
                    profiler_error="no device time in the trace")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return dict(device_ms=device_ms, wall_ms=wall_ms,
                device_busy_share=device_ms / wall_ms,
                top_device_ms=dict(top))


def phase_vgg(torch, dev, records):
    from repro_torch.core.synthesis import CNN2Gate
    from repro_torch.kernels import ops
    from repro_torch.models import cnn

    t0 = time.perf_counter()
    graph = cnn.vgg16(batch=1, seed=SEED)
    gate = CNN2Gate.from_graph(graph)
    rng = np.random.default_rng(SEED)
    x_cal = rng.standard_normal((1, 3, 224, 224)).astype(np.float32)
    gate.calibrate_quantization(x_cal)
    emit(phase="vgg16", setup_s=round(time.perf_counter() - t0, 3),
         weights_m=round(gate.parsed.total_weights / 1e6, 3),
         gop=round(gate.parsed.total_ops / 1e9, 3))
    reqs = [torch.as_tensor(rng.standard_normal((1, 3, 224, 224))
                            .astype(np.float32), device=dev)
            for _ in range(8)]
    batch = torch.cat(reqs)
    expect = {"qconv2d": 13, "qgemm": 3, "qconv2d_into": 0}
    run, outs, ms = serve(torch, gate, reqs + [batch], expect, "vgg16",
                          "vgg16")
    with plain_ops():
        plain_outs = [run(x) for x in reqs + [batch]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(reqs[0])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(a, b) for a, b in zip(outs, plain_outs))
    float_top1 = [int(cnn.run_float(graph, x, device=dev).argmax())
                  for x in reqs]
    emit(phase="vgg16", int8_top1=[int(y.argmax()) for y in outs[:-1]],
         float_top1=float_top1,
         distinct_probabilities=[int(torch.unique(y).numel())
                                 for y in outs[:-1]],
         max_probability=[float(y.max()) for y in outs[:-1]])
    batch_same = torch.equal(outs[-1], torch.cat(outs[:-1]))
    finite = all(bool(torch.isfinite(y).all()) for y in outs)
    check("vgg16", "kernel_path_equals_plain_path", same and finite,
          shapes=[list(y.shape) for y in outs[-1:]])
    check("vgg16", "batch8_equals_8_requests", batch_same)
    emit(phase="vgg16", ms_per_inference_batch1_median=statistics.median(
        ms[:-1]), ms_batch1_all=ms[:-1], ms_batch8=ms[-1],
        ms_per_inference_batch8=ms[-1] / 8,
        plain_ms_batch1=plain_ms)
    emit(phase="vgg16", **device_time(torch, lambda: run(reqs[0]),
                                      statistics.median(ms[:-1])))
    ops.reset_launch_counts()
    run(reqs[0])
    launches = ops.launch_counts()
    records.update(kernel_records(torch, run, reqs[0], launches, dev,
                                  "vgg16"))
    library_yardstick(torch, dev)


def library_yardstick(torch, dev, m: int = 32) -> None:
    """``torch._int_mm`` (int8 x int8 -> int32, no bias or requant) takes
    only M > 16, so it has no time at the main path's M = 1 and 8; time
    it and the qgemm kernel at VGG-16's FC shapes with M = 32."""
    from repro_torch.kernels import qgemm
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    flush = torch.empty(96 << 20, dtype=torch.int8, device=dev).zero_
    for k, n in ((25088, 4096), (4096, 4096), (4096, 1000)):
        x, w = rand_i8(torch, (m, k), gen, dev), rand_i8(torch, (k, n), gen, dev)
        b = rand_bias(torch, n, gen, dev)
        try:
            lib_ms = time_ms(torch, lambda: torch._int_mm(x, w), flush=flush)
        except RuntimeError as e:   # a build of torch without it
            lib_ms = f"not measured: {e}"
        emit(phase="library", m=m, k=k, n=n,
             qgemm_ms=time_ms(torch, lambda: qgemm.qgemm(
                 x, w, b, shift=shift_for(k), relu=True), flush=flush),
             int_mm_ms=lib_ms)


def phase_paths(torch, dev, records):
    from repro_torch.core.synthesis import CNN2Gate
    from repro_torch.kernels import ops
    from repro_torch.models import cnn

    for name, build in (("resnet18", cnn.resnet18),
                        ("googlenet_tiny", cnn.googlenet_tiny)):
        graph = build(batch=1, seed=SEED)
        hw = graph.inputs[0].shape[2]
        rng = np.random.default_rng(SEED + 1)
        x_cal = rng.standard_normal((1, 3, hw, hw)).astype(np.float32)
        xs = [torch.as_tensor(rng.standard_normal((2, 3, hw, hw))
                              .astype(np.float32), device=dev)]
        for per_channel in (False, True):
            tag = f"{name}_{'per_channel' if per_channel else 'per_tensor'}"
            fused = CNN2Gate.from_graph(graph)
            specs = fused.calibrate_quantization(x_cal,
                                                 per_channel=per_channel)
            unfused = CNN2Gate.from_graph(graph, fuse_skip=False,
                                          fuse_concat=False)
            unfused.apply_quantization(specs)
            ops.reset_launch_counts()
            run_f = fused.build("emulation")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y_f = run_f(xs[0])
            torch.cuda.synchronize()
            fused_ms = (time.perf_counter() - t0) * 1e3
            launches = ops.launch_counts()
            n_conv = sum(li.kind == "conv" for li in fused.parsed.layers)
            n_fc = sum(li.kind == "fc" for li in fused.parsed.layers)
            check(name, f"{tag}_every_stage_on_a_kernel",
                  launches["qconv2d"] + launches["qconv2d_into"] == n_conv
                  and launches["qgemm"] == n_fc, launches=launches,
                  conv_stages=n_conv, fc_stages=n_fc)
            y_u = unfused.build("emulation")(xs[0])
            with plain_ops():
                y_fp = run_f(xs[0])
            torch.cuda.synchronize()
            check(name, f"{tag}_fused_equals_unfused", torch.equal(y_f, y_u),
                  launches_fused=launches)
            check(name, f"{tag}_kernel_equals_plain",
                  torch.equal(y_f, y_fp)
                  and bool(torch.isfinite(y_f).all()),
                  shape=list(y_f.shape))
            if name == "googlenet_tiny":
                check(name, f"{tag}_concat_kernel_launched",
                      launches["qconv2d_into"] > 0, launches=launches)
                if not per_channel:
                    records.update(
                        {k: v for k, v in kernel_records(
                            torch, run_f, xs[0], launches, dev,
                            name).items()
                         if k == "qconv2d_into"})
            if name == "resnet18":
                # per-inference time at batch 1, after a warm run
                x1 = xs[0][:1]
                run_f(x1)
                times = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run_f(x1)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                emit(phase=name, mode=tag, ms_per_inference_batch1_median=
                     statistics.median(times), ms_batch2_first=fused_ms)
                emit(phase=name, mode=tag, **device_time(
                    torch, lambda: run_f(x1), statistics.median(times)))


SOURCES = {
    "qgemm": ("src/repro_torch/csrc/qgemm.cu",
              "src/repro/kernels/qgemm.py:60"),
    "qconv2d": ("src/repro_torch/csrc/qconv.cu",
                "src/repro/kernels/qconv.py:493"),
    "qconv2d_into": ("src/repro_torch/csrc/qconv.cu",
                     "src/repro/kernels/qconv.py:352"),
}


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke.py: not in a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    emit(phase="env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    records: dict = {}
    for phase, fn in (("kernels", phase_kernels), ("vgg16", phase_vgg),
                      ("paths", phase_paths)):
        t0 = time.perf_counter()
        with guarded(phase):
            if phase == "kernels":
                fn(torch, dev)
            else:
                fn(torch, dev, records)
        emit(phase=phase, seconds=round(time.perf_counter() - t0, 3))
    missing = [k for k in SOURCES if k not in records
               or records[k]["launches"] == 0]
    check("record", "every_kernel_launched_on_its_path", not missing,
          missing=missing)
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = records.get(name)
        if r is None:
            continue
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=r["launches"],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    if FAILED:
        print(f"chip_smoke.py: {len(FAILED)} check(s) failed: {FAILED}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

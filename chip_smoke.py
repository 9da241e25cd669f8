#!/usr/bin/env python3
"""Drive the PyTorch port of CNN2Gate on one CUDA card.

    python3 chip_smoke.py

Four phases, each printing one JSON line per check:

1. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together) and hold each kernel bit-exact
   (``torch.equal``) against its plain PyTorch version on the card, at
   the main paths' shapes and at ragged ones: dense, depthwise
   (multipliers, pools, skip, concat buffer) and ragged grouped convs,
   the GEMM, and a seeded random sweep over all of them; the standalone
   pools' plain versions on the card equal to the CPU's;
2. VGG-16 at full width (224x224, 1000 classes, 138 M random weights
   from a seed): ``CNN2Gate.from_graph`` -> ``calibrate_quantization`` ->
   ``build``, then serve 8 requests at batch 1 and one batch of 8.  The
   logits must equal those of the same executor with the plain ops, and
   every forward must launch the conv kernel 13 times and the GEMM
   kernel 3 times;
3. mobilenet_tiny at its own widths on 224x224 inputs, per-tensor and
   per-channel, served the same way: every forward launches the dense
   conv 4 times, the depthwise conv 3 times and the GEMM once;
4. ResNet-18 at full width, googlenet_tiny, a depthwise producer with a
   fused skip (dw-skip), a depthwise and a dense producer of one concat
   (dw-concat), and the two-tower AlexNet (group 2 on convs 2, 4 and 5,
   224x224), each fused and unfused, per-tensor and per-channel: fused
   == unfused and kernel == plain.

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


def rand_bias(torch, n, gen, dev, depth=None):
    """Random int32 biases; given the contraction depth, of the size of
    the sums' spread, so that they do not swamp short sums."""
    bound = 1 << 20 if depth is None else int(2 * 5461 * math.sqrt(depth))
    return torch.randint(-bound, bound, (n,), dtype=torch.int32, device=dev,
                         generator=gen)


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


def wrappers():
    """The kernel wrappers the executor calls, by name: {name: (module,
    wrapper, plain version)}."""
    from repro_torch.kernels import qconv, qgemm
    return {"qconv2d": (qconv, qconv.qconv2d, qconv.qconv2d_plain),
            "qdwconv2d": (qconv, qconv.qdwconv2d, qconv.qdwconv2d_plain),
            "qgconv2d": (qconv, qconv.qgconv2d, qconv.qconv2d_plain),
            "qgemm": (qgemm, qgemm.qgemm, qgemm.qgemm_plain)}


@contextlib.contextmanager
def patched_wrappers(make):
    """Replace each kernel wrapper with ``make(name, wrapper, plain)`` for
    the duration of the block."""
    found = wrappers()
    for name, (mod, fn, plain) in found.items():
        setattr(mod, name, make(name, fn, plain))
    try:
        yield
    finally:
        for name, (mod, fn, _plain) in found.items():
            setattr(mod, name, fn)


def plain_ops():
    """Route the executor's kernel calls to the plain versions (on the
    same device) for the duration of the block."""
    return patched_wrappers(lambda name, fn, plain: plain)


def recorded_calls(calls: list):
    """Record (kernel name, args, kwargs) of every kernel wrapper call the
    executor makes inside the block; a call into a concat buffer is
    named ``<wrapper>_into``."""
    def make(name, fn, _plain):
        def rec(*a, **kw):
            into = "_into" if kw.get("out_buf") is not None else ""
            calls.append((name + into, a, kw))
            return fn(*a, **kw)
        return rec
    return patched_wrappers(make)


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
    # name, N, H(unpadded), Cin, Cout, k, stride, pad, pool, extras;
    # "dw": depthwise (Cout = m * Cin), "groups": ragged grouped
    mobilenet_dw = [
        dict(name=f"mobilenet224_dw{i}_{h}x{c}_s{st}"
             f"{'_per_lane' if per_lane else ''}", n=1, h=h, cin=c, cout=c,
             k=3, s=st, p=1, dw=True, per_lane=per_lane)
        for i, (h, c, st) in enumerate(((112, 16, 1), (112, 32, 2),
                                        (56, 64, 1)), 1)
        for per_lane in (False, True)]
    return mobilenet_dw + [
        dict(name="dw_m2", n=2, h=20, cin=12, cout=24, k=3, s=1, p=1,
             dw=True),
        dict(name="dw_m4_s2_per_lane", n=1, h=21, cin=8, cout=32, k=3, s=2,
             p=1, dw=True, per_lane=True),
        dict(name="dw_pool2s2", n=2, h=28, cin=32, cout=32, k=3, s=1, p=1,
             dw=True, pool=(2, 2)),
        dict(name="dw_m2_pool3s2_per_lane", n=1, h=27, cin=16, cout=32, k=3,
             s=1, p=1, dw=True, pool=(3, 2), per_lane=True),
        dict(name="dw_c130_skip", n=2, h=17, cin=130, cout=130, k=3, s=1,
             p=1, dw=True, skip=True, relu=False),
        dict(name="dw_c130_skip_pool2s2_per_lane", n=1, h=18, cin=130,
             cout=130, k=3, s=1, p=1, dw=True, skip=True, pool=(2, 2),
             per_lane=True),
        dict(name="g2_cin8_cout12_pool2s2", n=2, h=12, cin=8, cout=12, k=3,
             s=1, p=1, groups=2, pool=(2, 2)),
        dict(name="g3_cin9_cout6_per_lane", n=2, h=12, cin=9, cout=6, k=3,
             s=1, p=1, groups=3, per_lane=True),
        dict(name="alexnet2tower_conv2_27x96_256_pool3s2", n=1, h=27, cin=96,
             cout=256, k=5, s=1, p=2, groups=2, pool=(3, 2)),
        dict(name="alexnet2tower_conv4_13x384_384_per_lane", n=1, h=13,
             cin=384, cout=384, k=3, s=1, p=1, groups=2, per_lane=True),

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


def conv_kind(c):
    """(wrapper name, its kernel callable, plain callable) of a case."""
    import functools
    from repro_torch.kernels import qconv
    if c.get("dw"):
        return "qdwconv2d", qconv.qdwconv2d, qconv.qdwconv2d_plain
    g = c.get("groups", 1)
    if g > 1:
        return ("qgconv2d", functools.partial(qconv.qgconv2d, groups=g),
                functools.partial(qconv.qconv2d_plain, groups=g))
    return "qconv2d", qconv.qconv2d, qconv.qconv2d_plain


def conv_inputs(torch, c, gen, dev):
    hp = c["h"] + 2 * c["p"]
    cin_g = 1 if c.get("dw") else c["cin"] // c.get("groups", 1)
    x = rand_i8(torch, (c["n"], hp, hp, c["cin"]), gen, dev)
    w = rand_i8(torch, (c["k"], c["k"], cin_g, c["cout"]), gen, dev)
    depth = c["k"] * c["k"] * cin_g
    b = rand_bias(torch, c["cout"], gen, dev, depth)
    s = shift_for(depth)
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
    from repro_torch.kernels import _build, qgemm

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
        name, kernel, plain = conv_kind(c)
        y = kernel(x, w, b, **kw)
        yp = plain(x, w, b, **kw)
        torch.cuda.synchronize()
        err = (y.int() - yp.int()).abs().max().item()
        check("kernels", f"{name}_{c['name']}", torch.equal(y, yp),
              shape=list(y.shape), max_abs_err=err,
              distinct_values=int(torch.unique(yp).numel()))

    sweep(torch, gen, dev)
    pools_on_the_card(torch, gen, dev)

    # out_buf: non-zero offsets, ragged Cout, depthwise multipliers; the
    # sentinel sibling channels must come back untouched
    for c in (dict(n=2, h=20, cin=12, cout=30, off=17, c_tot=70, pool=(2, 2)),
              dict(n=1, h=24, cin=16, cout=10, off=22, c_tot=32),
              dict(n=2, h=20, cin=12, cout=24, off=17, c_tot=70, pool=(2, 2),
                   dw=True, relu=False),
              dict(n=1, h=24, cin=16, cout=16, off=5, c_tot=40, dw=True,
                   relu=False, per_lane=True),
              dict(n=1, h=15, cin=8, cout=32, off=3, c_tot=40, pool=(3, 2),
                   dw=True, relu=False)):
        c.update(k=3, s=1, p=1, name=f"off{c['off']}_cout{c['cout']}"
                 f"_ctot{c['c_tot']}")
        x, w, b, kw = conv_inputs(torch, c, gen, dev)
        kw.update(concat_shift=1, concat_relu=True)
        name, kernel, plain = conv_kind(c)
        pool, off, cout = c.get("pool"), c["off"], c["cout"]
        oh = c["h"] if pool is None else (c["h"] - pool[0]) // pool[1] + 1
        sentinel = torch.full((c["n"], oh, oh, c["c_tot"]), 77,
                              dtype=torch.int8, device=dev)
        buf = kernel(x, w, b, out_buf=sentinel.clone(), out_off=off, **kw)
        bufp = plain(x, w, b, out_buf=sentinel.clone(), out_off=off, **kw)
        torch.cuda.synchronize()
        others = torch.cat([buf[..., :off], buf[..., off + cout:]], dim=-1)
        check("kernels", f"{name}_into_{c['name']}",
              torch.equal(buf, bufp) and bool((others == 77).all()),
              max_abs_err=(buf.int() - bufp.int()).abs().max().item())


def pools_on_the_card(torch, gen, dev) -> None:
    """The standalone pools run their plain versions on every path; on
    the card they must equal the same calls on the CPU, at one-channel,
    ragged and global windows too."""
    from repro_torch.kernels import ref
    bad, n = [], 0
    for c in (1, 3, 17, 64, 130, 520):
        for hw in (5, 13, 56):
            for win, st, pads in ((2, 2, (0, 0, 0, 0)), (3, 2, (0, 0, 0, 0)),
                                  (3, 3, (1, 0, 1, 2)), (hw, 1, (0, 0, 0, 0))):
                if hw < win:
                    continue
                x = rand_i8(torch, (3, hw, hw, c), gen, dev)
                for fn in (ref.maxpool2d_ref, ref.avgpool2d_ref):
                    n += 1
                    if not torch.equal(fn(x, win, st, pads).cpu(),
                                       fn(x.cpu(), win, st, pads)):
                        bad.append((fn.__name__, c, hw, win, st, pads))
    check("kernels", f"plain_pools_equal_the_cpu_{n}_cases", not bad,
          failures=bad[:10])


def sweep(torch, gen, dev, cases: int = 40) -> None:
    """Seeded random shapes and epilogue modes, each kernel call held
    bit-exact against its plain version: GEMMs, then dense, depthwise
    and ragged grouped convs (skip and concat buffer on the first two)."""
    from repro_torch.kernels import qgemm
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
    for kind in ("dense", "dw", "grouped"):
        for i in range(cases):
            kk = int(rng.choice([1, 2, 3, 5, 7]))
            st = int(rng.choice([1, 1, 2, 3]))
            nb = int(rng.integers(1, 4))
            if kind == "dense":
                groups = 1
                cin = int(rng.choice([1, 3, 4, 5, 8, 12, 16, 33, 64]))
                cout = int(rng.choice([1, 3, 8, 17, 64, 65, 100]))
            elif kind == "dw":
                cin = groups = int(rng.choice([1, 3, 4, 8, 16, 33, 64, 130]))
                cout = cin * int(rng.choice([1, 1, 2, 3, 4]))
            else:
                groups = int(rng.choice([2, 3, 4]))
                cin = groups * int(rng.choice([1, 2, 3, 4, 5, 8, 16]))
                cout = groups * int(rng.choice([1, 3, 8, 17, 33, 64, 65]))
            name, kernel, plain = conv_kind(dict(dw=kind == "dw",
                                                 groups=groups))
            cin_g = 1 if kind == "dw" else cin // groups
            hp = int(rng.integers(kk, 40))
            ho = (hp - kk) // st + 1
            pool = [None, (2, 2), (3, 2), (2, 1), (3, 3)][int(rng.integers(5))]
            if pool is not None and ho < pool[0]:
                pool = None
            x = rand_i8(torch, (nb, hp, hp, cin), gen, dev)
            w = rand_i8(torch, (kk, kk, cin_g, cout), gen, dev)
            b = rand_bias(torch, cout, gen, dev, kk * kk * cin_g) \
                if rng.random() < 0.8 else None
            s = shift_for(kk * kk * cin_g)
            kw = dict(strides=(st, st), relu=bool(rng.random() < 0.7),
                      pool=pool,
                      shift=(tuple(int(v) for v in rng.integers(0, s + 3, cout))
                             if rng.random() < 0.4 else s))
            if kind != "grouped" and rng.random() < 0.4:
                kw.update(skip=rand_i8(torch, (nb, ho, ho, cout), gen, dev),
                          skip_shifts=tuple(int(v)
                                            for v in rng.integers(0, 3, 2)),
                          merge_shift=int(rng.integers(0, 3)),
                          merge_relu=bool(rng.random() < 0.5))
            if kind != "grouped" and rng.random() < 0.4:
                oh = ho if pool is None else (ho - pool[0]) // pool[1] + 1
                off = int(rng.integers(0, 9))
                fill = torch.full(
                    (nb, oh, oh, off + cout + int(rng.integers(0, 9))), -5,
                    dtype=torch.int8, device=dev)
                kw.update(out_off=off, concat_shift=int(rng.integers(0, 3)),
                          concat_relu=bool(rng.random() < 0.5))
                y = kernel(x, w, b, out_buf=fill.clone(), **kw)
                yp = plain(x, w, b, out_buf=fill.clone(), **kw)
            else:
                y = kernel(x, w, b, **kw)
                yp = plain(x, w, b, **kw)
            if not torch.equal(y, yp):
                bad.append((name, i, nb, hp, cin, cout, groups, kk, st, pool,
                            "skip" in kw, "out_off" in kw))
    torch.cuda.synchronize()
    check("kernels", f"random_sweep_{cases}_gemm_{cases}_dense_{cases}"
          f"_depthwise_{cases}_grouped", not bad, failures=bad[:10])


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
    calls: list = []
    with recorded_calls(calls):
        run(x)
    torch.cuda.synchronize()
    flush_buf = torch.empty(96 << 20, dtype=torch.int8, device=dev)
    flush = flush_buf.zero_
    kernel, plain = {}, {}
    for name, (_mod, fn, plain_fn) in wrappers().items():
        for key in (name, name + "_into"):
            kernel[key], plain[key] = fn, plain_fn
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
            # multiply-adds: each output reads KH*KW*(Cin per group)
            r["ops"] += 2 * nb * ho * wo * cout * kh * kw_ * ww.shape[2]
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


def phase_mobilenet(torch, dev, records):
    """mobilenet_tiny at its builder's widths (16/32/64/64) on 224x224
    inputs: serve 8 requests at batch 1 and one batch of 8, per-tensor
    and per-channel, each logit equal to the plain path's."""
    from repro_torch.core.synthesis import CNN2Gate
    from repro_torch.kernels import ops
    from repro_torch.models import cnn

    graph = cnn.mobilenet_tiny(batch=1, in_hw=224, seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    x_cal = rng.standard_normal((1, 3, 224, 224)).astype(np.float32)
    reqs = [torch.as_tensor(rng.standard_normal((1, 3, 224, 224))
                            .astype(np.float32), device=dev)
            for _ in range(8)]
    batch = torch.cat(reqs)
    expect = {"qconv2d": 4, "qdwconv2d": 3, "qgemm": 1, "qconv2d_into": 0,
              "qdwconv2d_into": 0, "qgconv2d": 0}
    for per_channel in (False, True):
        tag = f"mobilenet_tiny_{'per_channel' if per_channel else 'per_tensor'}"
        gate = CNN2Gate.from_graph(graph)
        gate.calibrate_quantization(x_cal, per_channel=per_channel)
        run, outs, ms = serve(torch, gate, reqs + [batch], expect,
                              "mobilenet", tag)
        with plain_ops():
            plain_outs = [run(x) for x in reqs + [batch]]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs, plain_outs))
        finite = all(bool(torch.isfinite(y).all()) for y in outs)
        check("mobilenet", f"{tag}_kernel_path_equals_plain_path",
              same and finite, shapes=[list(y.shape) for y in outs[-1:]])
        check("mobilenet", f"{tag}_batch8_equals_8_requests",
              torch.equal(outs[-1], torch.cat(outs[:-1])))
        median = statistics.median(ms[:-1])
        emit(phase="mobilenet", mode=tag,
             ms_per_inference_batch1_median=median, ms_batch1_all=ms[:-1],
             ms_batch8=ms[-1], ms_per_inference_batch8=ms[-1] / 8)
        emit(phase="mobilenet", mode=tag,
             **device_time(torch, lambda: run(reqs[0]), median))
        if not per_channel:
            ops.reset_launch_counts()
            run(reqs[0])
            launches = ops.launch_counts()
            records.update({k: v for k, v in kernel_records(
                torch, run, reqs[0], launches, dev, "mobilenet").items()
                if k == "qdwconv2d"})


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


def dw_skip_graph(cnn, batch: int = 1, seed: int = 4):
    """A residual Add whose operand is a single-consumer depthwise conv:
    the parser folds the Add onto it (``tests/test_skip_fusion.py``'s
    ``dwadd`` graph)."""
    b = cnn.GraphBuilder("dw_skip", (batch, 3, 12, 12), seed)
    b.conv(16, 3, pad=1)
    split = b.tap()
    b.dwconv(3, pad=1, relu=False)
    left = b.tap()
    b.from_tap(split).dwconv(3, pad=1, relu=False)
    b.add_from(left, relu=True)
    b.global_avgpool()
    b.fc(3, relu=False, softmax=True)
    return b.build()


def dw_concat_graph(cnn, batch: int = 1, seed: int = 6):
    """A depthwise conv with channel multiplier 2 and a dense conv, both
    writing into one Concat's buffer; the merge absorbs a 2x2 pool."""
    b = cnn.GraphBuilder("dw_concat", (batch, 3, 12, 12), seed)
    b.conv(8, 3, pad=1)
    split = b.tap()
    b.conv(16, 3, pad=1, group=8, relu=False)
    dw = b.tap()
    b.from_tap(split).conv(6, 3, pad=1)
    b.concat_from(dw).maxpool(2, 2)
    b.fc(5, relu=False, softmax=True)
    return b.build()


def alexnet_2tower_graph(cnn, batch: int = 1, seed: int = SEED):
    """``cnn.alexnet``'s layers (kernels, strides, pads, pools, FC head,
    224x224, 1000 classes) at the widths of Krizhevsky et al.'s two-tower
    network (96, 256, 384, 384, 256), with group 2 on convs 2, 4 and 5."""
    b = cnn.GraphBuilder("alexnet_2tower", (batch, 3, 224, 224), seed)
    b.conv(96, 11, stride=4, pad=2).maxpool(3, 2)
    b.conv(256, 5, pad=2, group=2).maxpool(3, 2)
    b.conv(384, 3, pad=1)
    b.conv(384, 3, pad=1, group=2)
    b.conv(256, 3, pad=1, group=2).maxpool(3, 2)
    b.fc(4096).fc(4096).fc(1000, relu=False, softmax=True)
    return b.build()


def path_checks(name, launches, layers):
    """The path-specific checks of one fused forward: (check, ok) pairs."""
    if name == "googlenet_tiny":
        return [("concat_kernel_launched", launches["qconv2d_into"] > 0)]
    if name == "dw_skip":
        return [("depthwise_skip_launched", launches["qdwconv2d"] > 0 and any(
            li.is_dw_kernel and li.merge is not None for li in layers))]
    if name == "dw_concat":
        return [("depthwise_concat_launched",
                 launches["qdwconv2d_into"] > 0)]
    if name == "alexnet_2tower":
        grouped = [li for li in layers if li.kind == "conv" and li.group > 1]
        return [("three_grouped_launches_two_pooled",
                 launches["qgconv2d"] == 3 and len(grouped) == 3
                 and sum(li.pool is not None for li in grouped) == 2)]
    return []


#: Which kernel's record each path of phase 4 supplies.
PATH_RECORDS = {"googlenet_tiny": "qconv2d_into",
                "dw_concat": "qdwconv2d_into", "alexnet_2tower": "qgconv2d"}


def phase_paths(torch, dev, records):
    from repro_torch.core.synthesis import CNN2Gate
    from repro_torch.kernels import ops
    from repro_torch.models import cnn

    for name, build in (("resnet18", cnn.resnet18),
                        ("googlenet_tiny", cnn.googlenet_tiny),
                        ("dw_skip", lambda **kw: dw_skip_graph(cnn, **kw)),
                        ("dw_concat", lambda **kw: dw_concat_graph(cnn, **kw)),
                        ("alexnet_2tower",
                         lambda **kw: alexnet_2tower_graph(cnn, **kw))):
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
            conv_launches = sum(n for k, n in launches.items()
                                if k != "qgemm")
            check(name, f"{tag}_every_stage_on_a_kernel",
                  conv_launches == n_conv
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
            for what, ok in path_checks(name, launches,
                                        fused.parsed.layers):
                check(name, f"{tag}_{what}", ok, launches=launches)
            if name in PATH_RECORDS and not per_channel:
                records.update(
                    {k: v for k, v in kernel_records(
                        torch, run_f, xs[0], launches, dev, name).items()
                     if k == PATH_RECORDS[name]})
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
    "qdwconv2d": ("src/repro_torch/csrc/qdwconv.cu",
                  "src/repro/kernels/qconv.py:654"),
    "qdwconv2d_into": ("src/repro_torch/csrc/qdwconv.cu",
                       "src/repro/kernels/qconv.py:770"),
    "qgconv2d": ("src/repro_torch/csrc/qconv.cu",
                 "src/repro/kernels/qconv.py:877"),
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
                      ("mobilenet", phase_mobilenet), ("paths", phase_paths)):
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

#!/usr/bin/env python3
"""Drive the PyTorch port of CNN2Gate on one CUDA card.

    python3 chip_smoke.py

Twelve phases, each printing one JSON line per check:

1. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together) and hold each kernel bit-exact
   (``torch.equal``) against its plain PyTorch version on the card, at
   the main paths' shapes and at ragged ones: dense, depthwise
   (multipliers, pools, skip, concat buffer) and ragged grouped convs,
   the GEMM, and a seeded random sweep over all of them, with the dense
   kernel's edges (split K at 14x14x512, batch 1 and 8; rows and K off
   its tiles; Cin 3; 11x11/4 with the 3x3/2 pool; cout_g 192; skip with
   pool; concat buffers at odd offsets; narrow convs of 4-64 channels),
   the GEMM kernel's (M 1, 2, 7, 8, 9, 16, 17, 32 and 69 against N 1,
   10, 1000 and 4096, ragged K, per-column shifts) and the depthwise
   kernel's (mobilenet_tiny@224's three layers at batch 1 and 8, m = 2,
   stride 3, a 5x5 window, 3x3/2 windows across one-row bands, 20 and
   130 channels, skip, concat buffers), each check printing its plan
   (tile width and K split; the GEMM's wgmma N; the depthwise band); the
   standalone max-pool kernel and the average pool's plain version on
   the card equal to the CPU's plain versions;
2. VGG-16 at full width (224x224, 1000 classes, 138 M random weights
   from a seed): ``CNN2Gate.from_graph`` -> ``calibrate_quantization`` ->
   ``build``, then serve 8 requests at batch 1 and one batch of 8.  The
   logits must equal those of the same executor with the plain ops, and
   every forward must launch the conv kernel 13 times and the GEMM
   kernel 3 times.  Every kernel call of a forward is held equal to its
   plain version and timed, at batch 1 and at batch 8; the profiler
   must see the int8 ``wgmma`` conv kernel launched once for every conv
   call and the GEMM's ``wgmma`` kernel once for every FC call, each FC
   call alone launching nothing else, and each library's SASS must hold
   IGMMA and UTMALDG and no other kernel; ``qgemm_launch_split`` gives
   the device launches and ms of one FC call at each FC shape;
3. mobilenet_tiny at its own widths on 224x224 inputs, per-tensor and
   per-channel, served the same way: every forward launches the dense
   conv 4 times, the depthwise conv 3 times and the GEMM once (one
   device launch); the depthwise launches are timed at batch 1 and 8
   beside an empty kernel's time (``launch_floor_ms``);
4. ResNet-18 at full width, googlenet_tiny, a depthwise producer with a
   fused skip (dw-skip), a depthwise and a dense producer of one concat
   (dw-concat), and the two-tower AlexNet (group 2 on convs 2, 4 and 5,
   224x224), each fused and unfused, per-tensor and per-channel: fused
   == unfused and kernel == plain, every AlexNet and googlenet_tiny
   conv launching the ``wgmma`` kernel, each conv, FC and standalone
   max-pool stage one launch of its kernel (ResNet-18: 20, 1 and 1);
   the max-pool kernel at ResNet-18's batch-512 stage equal to its plain
   version at each chunk width and timed beside its bound;
   the static verifier and the QV501/QV502 probes clean on the fused
   programs built on the card, the probe seeing each unfused merge.
   Every net of phases 2-4 is also served through ``build("fullflow")``,
   the executor captured as a CUDA graph: each output ``torch.equal`` to
   the eager executor's over several requests, two results kept across
   calls, a second input shape captured at its first call, every kernel
   of the path launched between the build and the last request, and a
   profiler trace of one replay holding each expected
   ``*_wgmma_kernel``/``qdwconv_kernel`` launch and nothing the plain
   versions launch; VGG-16 and mobilenet_tiny print both executors'
   walls on the same requests;
4a. mobilenet_v2, MobileNetV2 1.0 at full width (224x224, 1000 classes):
   the build's 35 clamped stages and 10 fused skips; the fullflow checks
   of phase 4 on batch-1 requests and a batch of 8; one eager forward at
   batch 512 launching the dense conv 35 times (18 with a clamp below
   127, 10 with a skip), the depthwise conv 17 times (each with a clamp,
   each taking its pads in its band staging) and the GEMM once, its
   logits equal to the plain path's and each of its 53 kernel calls
   equal to its plain version; four batch-512 stages (block 2's
   depthwise /2, block 3's depthwise, block 2's expansion with K 16,
   block 1's projection with Cout 16, that one also with a clamp) timed
   beside their bounds and the plain version, in the conv kernels'
   records;
4a'. resnext50_32x4d, ResNeXt-50 (32x4d) at full width: the build's 16
   grouped stages and 16 fused skips; the fullflow checks of phase 4 (the
   replay's 16 grouped launches under ``qconv_grouped_wgmma_kernel``); one
   eager forward at batch 512 launching the dense conv 37 times (16 with
   a skip), the grouped conv 16 times, the max-pool and the GEMM once,
   its logits equal to the plain path's and each of its 55 kernel calls
   equal to its plain version; one grouped stage of each per-group width
   (4, 8, 16, 32 channels) timed beside its bound and the plain version,
   in the grouped kernel's record;
4b. flow, the paper's whole flow at full width for AlexNet and VGG-16:
   ``verify()`` clean, ``explore`` on the three boards (BF, and RL with
   seeds 0-2) giving the FPGA model's decisions (AlexNet: no fit, (8, 8),
   (16, 32); VGG-16: no fit, no fit, (16, 32)), the ARRIA10
   ``latency_report`` (an FPGA model figure, not a card time), then
   ``build("fullflow", *best)`` serving 8 batch-1 requests and a batch
   of 8 with the checks above, and both executors' walls and the
   fullflow's device busy share;
4c. resilience, the guarded int8 path and the stage-timed profile:
   VGG-16 at full width under ``build_guarded(GuardPolicy(margin=0,
   sat_tol=0), checkpoints=2)`` — a clean request ``torch.equal`` to the
   unguarded executor, ``build_guarded(policy=None)`` making the ops calls
   of ``build()``, a weight flip after the first boundary recovered by
   checkpoint replay, conv1's flip re-flagging on ``reexecute`` and
   served by ``fallback:unfused``, an fc6 flip (the GEMM's restaged
   ``w_k``), an activation flip; ResNet-18 per-channel with a shift-lane
   fault (the restaged ``shift_vec``) down to ``fallback:per_tensor``;
   googlenet_tiny with faults on a concat-fused producer's slice.  Every
   report (outcome, flagged stages, actions, ``replayed``) and output
   equal to the same plan's on the plain path.  SER campaigns (weight
   bit, dropped tile, activation bit; seed 0, 2 checkpoints, chunks of
   32 trials, each chunk one call of the executor's trial form, so that
   its stages with trial weights launch the kernels' trial forms):
   VGG-16, 64 trials, mobilenet_tiny@224, googlenet_tiny, dw_concat and
   alexnet_2tower, 32 each, every trial record equal to the plain path's
   and to a per-trial yardstick's (each plan through ``inject`` and the
   audited executor alone), with counts, Wilson intervals, trials/s of
   all three, a one-chunk campaign's device ms, the peak memory and the
   derived audit set; then each trial form (dense, into, grouped and
   depthwise convs, the GEMM) at the campaigns' shapes with T = 32, N =
   1 (VGG-16's 13 convs and 3 FCs, mobilenet_tiny@224's depthwise
   stages, googlenet_tiny's concat producers, dw_concat's depthwise
   producer, alexnet_2tower's grouped convs) ``torch.equal`` to its
   plain version and to the single kernel's loop over the trials, timed
   beside both and its bound.  The audit's cost (guarded vs unguarded walls, taking
   turns), the stage-timed VGG-16 ``torch.equal`` to the executor with
   every stage timed, and ``profile_model`` for VGG-16 and AlexNet;
5. lm, the dense-LM serving path in bf16 with random weights from a
   seed: the built flash library's SASS must hold HGMMA (wgmma) and
   UTMALDG (TMA loads); the flash-attention kernel held against its
   plain version (float32 within 2e-5, bf16 within one bf16 ulp plus
   2e-6) at qwen2-1.5b's and h2o-danube-3-4b's prefill shapes, on rows
   that see no key, over a seeded sweep, and at the bf16 kernel's tile
   edges (Sq 4095 and 1, Skv 100, D 64, 80, 120 and 77, a GQA 6:1
   chunked prefill); at qwen2-1.5b's shape no farther from a float64 run
   than 1.5x the plain version and within its bf16 allowance of it;
   qwen2-1.5b at full width (28 layers,
   d_model 1536, GQA 12:2, 1.54 B parameters): ``Model.prefill`` of
   2 x 4096 tokens, each run launching the kernel 28 times, every call
   agreeing with the plain version and the logits with the plain path's;
   16 greedy ``decode_step``s; ``Server`` (4 slots, 64-token cache)
   answering 8 requests; then h2o-danube-3-4b at full width and 2 of its
   24 layers: a 6144-token prefill under its 4096 window and 8 decode
   steps.  It prints prefill ms and tokens/s, ms per decode step, the
   server's tokens/s and p50 latency, and the kernel's time per launch
   beside the plain version's, ``scaled_dot_product_attention``'s and
   the bound;
6. ssm, the Mamba-2 SSM and hybrid serving paths in bf16 with random
   weights from a seed, ``conv_b``/``conv_c`` drawn from it too (with the
   reference's zeros there the SSD term is 0 whatever the kernel
   computes): the SSD-scan kernel held against its plain version (y and
   the final state; float32 within atol 1e-4 + rtol 1e-3, bf16 y within
   one bf16 ulp more) at mamba2-2.7b's prefill shape with and
   without ``d``, with an initial state, at the decode shape, at a ragged
   L, with G = 2, in float32 and over a 24-case seeded sweep, and no
   farther than 1.5x the plain version from a float64 run;
   mamba2-2.7b at full width and depth (64 layers, d_model 2560, 80
   heads of 64, N 128, 2.7 B parameters): ``Model.prefill`` of 2 x 4096
   tokens launching the kernel 64 times, every call agreeing with the
   plain version and the logits with the plain path's (float32-distance
   criterion of phase 5); 16 greedy ``decode_step``s of 64 launches
   each; ``Server`` (4 slots) answering 8 requests of 16 + 16 tokens;
   then zamba2-2.7b at full width and 12 of its 54 layers (two
   applications of its shared attention block): a 4096-token prefill
   and 8 decode steps.  It prints the same times as phase 5 and the
   kernel's time per launch beside the plain version's and the bound;
7. families, the MoE, VLM-input and encoder-decoder serving paths in
   bf16 on the flash kernel, random weights from a seed:
   granite-moe-1b-a400m at full width and depth (24 layers, 32 experts
   top-8, capacity factor 1.25, GQA 16:8 at D 64, tied head, 1.33 B
   parameters): ``Model.prefill`` of 2 x 4096 tokens launching flash 24
   times, 16 decode steps, ``Server`` answering 8 requests of 16 + 16
   tokens; llama4-scout-17b-a16e at full width and 4 of its 48 layers
   (16 experts top-1, GQA 40:8 at D 128, 10.4 B parameters; all 48 are
   101.7 B, more than one card holds): prefill 1 x 4096 (4 launches), 8
   decode steps; qwen2-vl-2b at full width and depth: prefill of 2 x
   4096 seeded embeddings on M-RoPE ids laid out as text, one 48 x 64
   image and text again (28 launches; a check that the ids exercise the
   three sections), 16 decode steps fed embeddings; whisper-large-v3 at
   full width and depth (32 + 32 layers, MHA 20:20 at D 64): 1500
   seeded audio frames a row and a 448-token decoder prefill, 96
   launches (32 non-causal 1500 x 1500, 32 causal 448 x 448, 32 cross
   448 x 1500), then 16 decode steps of 32 cross-attention launches (Sq
   1 over 1500 keys), each call held against the plain version.  Every
   flash call is checked as in phase 5 and the logits by phase 5's
   float32-distance criterion; for MoE the plain and float32 runs replay
   the kernel path's routing decisions, after the plain path's own
   routing is compared with it (dropped slots per layer, differing
   decisions, rows whose routing agreed in every layer).  Both paths'
   routing of every layer is rechecked on the card by independent means
   (``torch.topk``, ties to the lower expert, the capacity, and the JAX
   package's cumsum over one-hots for queue positions and drops), and
   every token whose experts differ between the paths must sit at a
   near-tie of the plain path's probabilities.  It prints the
   times of phase 5 and flash's time per launch at each new shape beside
   SDPA's and the bound;
8. train, training on the card, which launches neither kernel: the
   flash and SSD kernels have no backward (nor have the JAX package's),
   so both refuse inputs that require grad, checked on the card.
   qwen2-1.5b at full width and depth (bf16, chunked attention, remat
   "full", AdamW, 2 x 4096 ``SyntheticLM`` tokens): step 1's gradient
   against a float32 run of the same weights and batch (whole-gradient
   cosine >= 0.99, loss within 1 %), 4 timed steps with no flash or SSD
   launch (ms a step, tokens/s, peak memory, model-FLOPs share, the busy
   share of a step), then the trained weights served by
   ``Model.prefill`` on the flash kernel (1 x 4096: 28 launches, each
   held against the plain version, logits by phase 5's criterion);
   remat "none", "full" and "dots" giving equal gradients under
   deterministic algorithms (4 layers, 2 x 4096; CUBLAS_WORKSPACE_CONFIG
   is set at the top of this script for it); lm100m at full width
   through ``launch/train.py``: 60 steps whose loss falls by 10 %, 6
   steps against 3 + resume + 3, int8 error feedback, and step 1 in
   float32 against the port on the CPU; mamba2-2.7b (4 of 64 layers,
   1 x 2048) against float32 with no ``ssd_scan`` launch, its serving
   prefill then launching it once a layer; one step each of
   granite-moe (4 layers), qwen2-vl (4) and whisper (4 + 4), every
   gradient leaf nonzero but the key biases;
9. dist, the distribution layer.  On an NCCL world of one rank, a 1 x 1
   ``("data", "model")`` mesh and a ``ShardingPolicy``: qwen2-1.5b
   (flash, bf16, full width and depth) prefills 2 x 4096 tokens with its
   weights distributed by the policy, launching flash 28 times on each
   rank's local heads (every call held against the plain version) and
   giving the unsharded run's logits bit for bit; mamba2-2.7b the same
   with 64 ``ssd_scan`` launches; one qwen2-1.5b train step (remat
   "full", AdamW with a ZeRO-1 state) equal to the unsharded step in
   loss and every weight under deterministic algorithms;
   ``compressed_psum`` (its int32 and float32 all-reduces, equal to the
   dequantized input).  Then two gloo ranks on the one card
   (``torch.multiprocessing``): flash-decoding over a 4096-token cache
   split in two against ``decode_attention`` within 1e-5, with no
   window, h2o's 4096 and a 1000 window, and ``compressed_psum`` of
   distinct shards.  Last, the dry run on a fake process world, on the
   host: qwen2-1.5b train_4k on the 16 x 16 and the 2 x 16 x 16 mesh,
   and the one-card cell of phase 8's step, its predicted step time and
   peak memory beside the measured ones.

Before the last line it prints the kernels' record (launches, error,
times, bounds; for the dense conv, the GEMM, flash_attention and
ssd_scan also the design, the SASS counts and nvcc's registers, shared
memory and spills; for the convs and the GEMM each call's plan; batch-8
times of the GEMM and the depthwise conv, and the launch floor beside
the depthwise rows) as one JSON object, then
the card's name and power limit from ``nvidia-smi``.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check exits non-zero without it, as does a run with no CUDA
or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
#: cuBLAS computes deterministically under
#: ``torch.use_deterministic_algorithms(True)`` (the remat and resume
#: checks of the train phase) only with a fixed workspace, set before its
#: first handle; it raises otherwise.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
#: Float kernel tolerances against the plain version.  float32: both sum
#: in float32 in other orders.  bfloat16: both compute in float32 and
#: round once, so a result may land one bf16 ulp away where the float32
#: values straddle a rounding boundary; plus BF16_ATOL where the output
#: cancels to near 0 (|o| ~ 1e-6) and float32's absolute rounding
#: (measured up to 6e-8 at 6144 keys) exceeds the ulp of so small a value.
F32_TOL = 2e-5
BF16_ATOL = 2e-6
SEED = 0
TIME_REPS = 20

FAILED: list = []
#: measurements one phase hands to a later one (the dist phase's dry run
#: is held against the train phase's measured step)
MEASURED: dict = {}


def card():
    """The H100's data-sheet rates the bounds divide by (HBM bytes/s, the
    dense int8 and bf16 tensor-core peaks): ``core/resources.py:H100``."""
    from repro_torch.core.resources import H100
    return H100


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
    """The kernel wrappers the executor and the LM layers call, by name:
    {name: (module, wrapper, plain version)}; the convs' and the GEMM's
    trial forms (an SER campaign's chunk) with the loops of
    ``kernels/ref.py``; the standalone max-pool."""
    from repro_torch.kernels import flash_attention as fa, pool, qconv
    from repro_torch.kernels import qgemm, ref
    from repro_torch.kernels import ssd_scan as ssd
    return {"qconv2d": (qconv, qconv.qconv2d, qconv.qconv2d_plain),
            "qdwconv2d": (qconv, qconv.qdwconv2d, qconv.qdwconv2d_plain),
            "qgconv2d": (qconv, qconv.qgconv2d, qconv.qconv2d_plain),
            "qgemm": (qgemm, qgemm.qgemm, qgemm.qgemm_plain),
            "qconv2d_trials": (qconv, qconv.qconv2d_trials,
                               ref.qconv2d_trials_ref),
            "qdwconv2d_trials": (qconv, qconv.qdwconv2d_trials,
                                 ref.qdwconv2d_trials_ref),
            "qgconv2d_trials": (qconv, qconv.qgconv2d_trials,
                                ref.qconv2d_trials_ref),
            "qgemm_trials": (qgemm, qgemm.qgemm_trials,
                             ref.qgemm_trials_ref),
            "maxpool2d": (pool, pool.maxpool2d, ref.maxpool2d_ref),
            "flash_attention": (fa, fa.flash_attention,
                                fa.flash_attention_plain),
            "ssd_scan": (ssd, ssd.ssd_scan, ssd.ssd_scan_plain)}


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
    named ``<wrapper>_into`` (a trial form's ``<wrapper>_into_trials``)."""
    def make(name, fn, _plain):
        def rec(*a, **kw):
            into = "_into" if kw.get("out_buf") is not None else ""
            base = name.removesuffix("_trials")
            calls.append((base + into + name[len(base):], a, kw))
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
    # the swap-AB kernel's tiles: each wgmma N (8, 16, 32) and its edges,
    # M past 32 (tiled over gridDim.y); N of 1 and 10 (narrow heads), 1000
    # (64-column tiles, the last ragged) and 4096; ragged K (x padded to
    # 16 bytes, the weight to 128); per-column shifts every other case
    ks = (777, 130, 2500, 4096, 1001, 64, 3001)
    for i, (m, n) in enumerate((m, n) for m in (1, 2, 7, 8, 9, 16, 17, 32, 69)
                               for n in (1, 10, 1000, 4096)):
        cases.append(dict(m=m, k=ks[i % len(ks)], n=n, relu=i % 3 != 0,
                          per_col=i % 2 == 1))
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
    ] + [
        dict(name=f"mobilenet224_dw{i}_{h}x{c}_s{st}_batch8", n=8, h=h,
             cin=c, cout=c, k=3, s=st, p=1, dw=True)
        for i, (h, c, st) in enumerate(((112, 16, 1), (112, 32, 2),
                                        (56, 64, 1)), 1)
    ] + [
        # the band kernel's edges: stride 3; a 5x5 window (the generic
        # path); 3x3/2 windows across one-row bands at batch 8; m = 2 with
        # stride 2 and the 2x2/2 pool; 20 channels (4-byte copies)
        dict(name="dw_s3", n=2, h=25, cin=16, cout=16, k=3, s=3, p=1,
             dw=True),
        dict(name="dw_5x5_c24", n=1, h=20, cin=24, cout=24, k=5, s=1, p=2,
             dw=True),
        dict(name="dw_pool3s2_bands_batch8", n=8, h=56, cin=32, cout=32, k=3,
             s=1, p=1, dw=True, pool=(3, 2)),
        dict(name="dw_m2_s2_pool2s2", n=2, h=30, cin=12, cout=24, k=3, s=2,
             p=1, dw=True, pool=(2, 2)),
        dict(name="dw_c20_per_lane", n=2, h=15, cin=20, cout=20, k=3, s=1,
             p=1, dw=True, per_lane=True),
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
        # the wgmma kernel's edges: split K at 14x14x512, batch 1 and 8,
        # with and without the pool; 169 rows and K = 360 (neither a
        # multiple of the tile); cout_g 192 = 128 + 64 with the 3x3/2 pool;
        # a skip with the pool and per-lane shifts at 256 channels
        dict(name="vgg_14x512_512", n=1, h=14, cin=512, cout=512, k=3, s=1,
             p=1),
        dict(name="vgg_14x512_512_batch8", n=8, h=14, cin=512, cout=512,
             k=3, s=1, p=1),
        dict(name="vgg_14x512_512_pool_batch8", n=8, h=14, cin=512,
             cout=512, k=3, s=1, p=1, pool=(2, 2)),
        dict(name="rows169_k360", n=1, h=13, cin=40, cout=96, k=3, s=1, p=1),
        dict(name="g2_cout384_pool3s2", n=1, h=13, cin=256, cout=384, k=3,
             s=1, p=1, groups=2, pool=(3, 2)),
        dict(name="skip_pool_per_lane_c256", n=2, h=14, cin=128, cout=256,
             k=3, s=1, p=1, skip=True, pool=(2, 2), per_lane=True),
    ] + [
        # narrow convs on a 64-channel tile: googlenet_tiny's Cout 4-12
        # (batch 2), then 8-64 channels over 56x56x64
        dict(name=f"narrow_{n}x{h}x{cin}_c{cout}_k{k}", n=n, h=h, cin=cin,
             cout=cout, k=k, s=1, p=p, pool=pool)
        for n, h, cin, cout, k, p, pool in (
            (2, 12, 16, 4, 1, 0, None), (2, 12, 16, 8, 1, 0, None),
            (2, 14, 8, 12, 3, 1, (2, 2)), (2, 12, 4, 6, 5, 2, (2, 2)),
            (2, 6, 32, 10, 1, 0, None), (2, 14, 16, 16, 3, 1, None),
            (2, 14, 16, 32, 3, 1, None), (1, 56, 64, 8, 3, 1, None),
            (1, 56, 64, 16, 3, 1, None), (1, 56, 64, 32, 3, 1, None),
            (1, 56, 64, 64, 3, 1, None))]


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


def padded_hw(x, kw) -> tuple:
    """The height and width of a conv call's input with its ``pads``: the
    wrappers take the unpadded input and the pads."""
    pt, pl, pb, pr = kw.get("pads", (0, 0, 0, 0))
    return x.shape[1] + pt + pb, x.shape[2] + pl + pr


def conv_plan(name, x, w, kw):
    """A conv call's plan as a dict: the dense/grouped kernel's tile
    width and K split, or the depthwise kernel's band (output rows,
    columns, channels a block)."""
    from repro_torch.kernels import qconv, qgemm
    if name.startswith("qdwconv2d"):
        pool = kw.get("pool")
        pl = qconv.dw_plan(x.shape[0], *padded_hw(x, kw), x.shape[3],
                           w.shape[0], w.shape[1], w.shape[3],
                           tuple(kw["strides"]),
                           None if pool is None else tuple(pool),
                           qgemm.sms_of(x.device.index))
        return dict(rp=pl.rp, cp=pl.cp, cb=pl.cb,
                    blocks=x.shape[0] * pl.blocks_per_image, smem=pl.smem)
    groups = x.shape[-1] // w.shape[2]
    pool = kw.get("pool")
    pl = qconv.plan(x.shape[0], *padded_hw(x, kw), x.shape[3], w.shape[0],
                    w.shape[1], w.shape[3], tuple(kw["strides"]),
                    None if pool is None else tuple(pool), groups,
                    qgemm.sms_of(x.device.index))
    return dict(bn=pl.bn, k_pad=pl.k_pad, groups=pl.groups,
                tiles=pl.tiles, splits=pl.splits, chunk=pl.chunk,
                blocks=pl.blocks)


def gemm_plan(x, w):
    """The GEMM kernel's plan of a call (tiles, wgmma N, K split)."""
    from repro_torch.kernels import qgemm
    pl = qgemm.plan(x.shape[0], w.shape[1], x.shape[1],
                    qgemm.sms_of(x.device.index))
    return dict(bn=pl.bn, nw=pl.nw, tiles=pl.tiles, splits=pl.splits,
                chunk=pl.chunk, blocks=pl.blocks)


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
              max_abs_err=err, distinct_values=int(torch.unique(yp).numel()),
              plan=gemm_plan(x, w))

    for c in conv_cases():
        x, w, b, kw = conv_inputs(torch, c, gen, dev)
        name, kernel, plain = conv_kind(c)
        y = kernel(x, w, b, **kw)
        yp = plain(x, w, b, **kw)
        torch.cuda.synchronize()
        err = (y.int() - yp.int()).abs().max().item()
        check("kernels", f"{name}_{c['name']}", torch.equal(y, yp),
              shape=list(y.shape), max_abs_err=err,
              distinct_values=int(torch.unique(yp).numel()),
              plan=conv_plan(name, x, w, kw))

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
                   dw=True, relu=False),
              dict(n=2, h=16, cin=64, cout=96, off=3, c_tot=131,
                   pool=(2, 2), per_lane=True),
              dict(n=1, h=14, cin=128, cout=192, off=17, c_tot=224),
              dict(n=1, h=14, cin=512, cout=512, off=16, c_tot=544,
                   pool=(2, 2))):
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
              max_abs_err=(buf.int() - bufp.int()).abs().max().item(),
              plan=conv_plan(name, x, w, kw))


def pools_on_the_card(torch, gen, dev) -> None:
    """The standalone max-pool launches its kernel (``csrc/pool.cu``) and
    the average pool runs its plain version; on the card each must equal
    the same call's plain version on the CPU, at one-channel, ragged and
    global windows too."""
    from repro_torch.kernels import ops, ref
    bad, n = [], 0
    launched = ops.launch_counts()["maxpool2d"]
    for c in (1, 3, 17, 64, 130, 520):
        for hw in (5, 13, 56):
            for win, st, pads in ((2, 2, (0, 0, 0, 0)), (3, 2, (0, 0, 0, 0)),
                                  (3, 3, (1, 0, 1, 2)), (hw, 1, (0, 0, 0, 0))):
                if hw < win:
                    continue
                x = rand_i8(torch, (3, hw, hw, c), gen, dev)
                for fn, plain in ((ops.maxpool2d_nhwc, ref.maxpool2d_ref),
                                  (ops.avgpool2d_nhwc, ref.avgpool2d_ref)):
                    n += 1
                    if not torch.equal(fn(x, win, st, pads).cpu(),
                                       plain(x.cpu(), win, st, pads)):
                        bad.append((fn.__name__, c, hw, win, st, pads))
    launched = ops.launch_counts()["maxpool2d"] - launched
    check("kernels", f"maxpool_kernel_and_plain_avgpool_equal_the_cpu_{n}"
          "_cases", not bad and launched == n // 2, failures=bad[:10],
          maxpool_launches=launched)


def pool_record(torch, dev, launches: int) -> dict:
    """The max-pool kernel's record: ``launches`` from its path's forward;
    the kernel equal to the plain version at ResNet-18's batch-512 stage
    (112x112x64, 3x3/2, pads 1), and its time there beside its bound (the
    input read once, the output written once) and the plain version's.
    The same stage is also launched at each chunk width the kernel has
    (16, 4 and 1 bytes, which 64 channels all allow), each output held
    equal and timed: what a wider chunk buys."""
    from repro_torch.kernels import _build, pool, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    n, h, c, args = 512, 112, 64, (3, 2, (1, 1, 1, 1))
    x = rand_i8(torch, (n, h, h, c), gen, dev)
    y = pool.maxpool2d(x, *args)
    yp = ref.maxpool2d_ref(x, *args)
    err = (y.int() - yp.int()).abs().max().item()
    chunk = pool.chunk_width(c, x.data_ptr(), y.data_ptr())
    check("resnet18", "maxpool_resnet18_stage_batch512_equals_plain",
          err == 0, max_abs_err=err, chunk=chunk)
    lib = _build.load("pool", pool._SIGNATURES)
    oh = y.shape[1]

    def at(width, out):
        return lambda: _build.check(lib.maxpool_s8(
            _build.ptr(x), _build.ptr(out), n, h, h, c, 3, 2, 1, 1, oh, oh,
            width, _build.stream(dev)), "maxpool2d")
    by_chunk, bad = {}, []
    for width in (16, 4, 1):
        out = torch.empty_like(y)
        at(width, out)()
        torch.cuda.synchronize()
        if not torch.equal(out, yp):
            bad.append(width)
        by_chunk[str(width)] = time_ms(torch, at(width, out))
    check("resnet18", "maxpool_every_chunk_width_equals_plain", not bad,
          failures=bad, ms_by_chunk=by_chunk)
    ms = time_ms(torch, lambda: pool.maxpool2d(x, *args))
    plain_ms = time_ms(torch, lambda: ref.maxpool2d_ref(x, *args))
    bound_ms = (x.numel() + y.numel()) / card().hbm_bandwidth * 1e3
    emit(phase="resnet18", what="maxpool_resnet18_stage_batch512",
         shape=list(x.shape), ms=ms, bound_ms=bound_ms, bound_by="bytes",
         share_of_bound=bound_ms / ms, plain_ms=plain_ms, library_ms=None,
         ms_by_chunk=by_chunk, card=card_line())
    return dict(launches=launches, calls_timed=1, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None,
                extra=dict(shape=list(x.shape), chunk=chunk,
                           ms_by_chunk=by_chunk))


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
    """Run each request through the gate's eager executor and check the
    launch counts of every forward; then serve the same requests through
    ``build("fullflow")`` (:func:`fullflow_checks`).  Return (eager
    executor, eager logits, eager per-request ms, fullflow executor)."""
    from repro_torch.kernels import ops
    run = gate.build("emulation")
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
    full = fullflow_checks(torch, gate, run, xs, outs, expect, phase, name)
    return run, outs, ms, full


def fullflow_walls(torch, phase, name, eager, full, xs) -> dict:
    """Emit the walls of the eager and the fullflow executor on the same
    batch-1 requests and the one batch (``xs[-1]``), and the fullflow's
    device busy share at batch 1; return the walls."""
    w = walls(torch, {"eager": eager, "fullflow": full}, xs)
    row = dict(eager_batch1_median_ms=statistics.median(w["eager"][:-1]),
               fullflow_batch1_median_ms=statistics.median(
                   w["fullflow"][:-1]),
               eager_batch1_ms=w["eager"][:-1],
               fullflow_batch1_ms=w["fullflow"][:-1],
               batch=int(xs[-1].shape[0]),
               eager_batch_ms=w["eager"][-1],
               fullflow_batch_ms=w["fullflow"][-1])
    emit(phase=phase, model=name, what="fullflow_vs_eager_walls", **row)
    emit(phase=phase, model=name, executor="fullflow", **device_time(
        torch, lambda: full(xs[0]), row["fullflow_batch1_median_ms"]))
    return row


#: The device kernel each counted wrapper launches.
KERNEL_OF = {"qconv2d": "qconv_wgmma_kernel",
             "qconv2d_into": "qconv_wgmma_kernel",
             "qgconv2d": "qconv_grouped_wgmma_kernel",
             "qdwconv2d": "qdwconv_kernel",
             "qdwconv2d_into": "qdwconv_kernel",
             "qgemm": "qgemm_wgmma_kernel",
             "maxpool2d": "maxpool_nhwc_kernel"}


def device_kernels(torch, fn, traces: int = 3, attempts: int = 10) -> dict:
    """Device launches of one call of ``fn`` by kernel name, from
    ``torch.profiler`` (a CUDA graph's replay shows each kernel it
    holds): the most of each name over ``traces`` traces that hold a
    device event, taking at most ``attempts`` traces.  On the H100 a
    trace has come back with no device event at all (three in a row for
    one FC call alone); every ``fn`` here launches something, so an
    empty trace is a failed trace, not a finding, and a trace never
    adds a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    seen: dict = {}
    kept = 0
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts: dict = {}
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA \
                    and not ev.is_user_annotation:
                counts[ev.key] = counts.get(ev.key, 0) + ev.count
        for key, n in counts.items():
            seen[key] = max(seen.get(key, 0), n)
        kept += bool(counts)
        if kept == traces:
            break
    return seen


def walls(torch, fns: dict, xs, rounds: int = 3) -> dict:
    """Host wall ms of each request of ``xs`` through each executor of
    ``fns``, synchronized before and after, the executors taking turns
    on every request (the same timer and the same requests for all);
    per executor, the median over the rounds of each request."""
    times = {k: [[] for _ in xs] for k in fns}
    for _ in range(rounds):
        for i, x in enumerate(xs):
            for k, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(x)
                torch.cuda.synchronize()
                times[k][i].append((time.perf_counter() - t0) * 1e3)
    return {k: [statistics.median(t) for t in v] for k, v in times.items()}


def fullflow_checks(torch, gate, eager, xs, want, expect, phase, name,
                    profile: bool = True, design: tuple = ()):
    """``build("fullflow")`` on the card: the executor captured as a CUDA
    graph at build time (batch 1), serving the requests ``xs``.  Checks:
    a ``CapturedExecutor`` with the batch-1 graph, every kernel of
    ``expect`` (launches per eager forward) launched while the counts
    ran from the build to the last request, every result ``torch.equal``
    to the eager executor's ``want``, results kept across calls, a new
    shape captured at its first call, and (``profile``) a replay that
    launches exactly the expected hand-written kernels and nothing the
    plain versions launch.  ``design`` is the (n_i, n_l) design point to
    build.  Returns the fullflow executor."""
    from repro_torch.core.synthesis import CapturedExecutor
    from repro_torch.kernels import ops
    one = (1,) + tuple(gate.parsed.input_shape[1:])
    ops.reset_launch_counts()
    full = gate.build("fullflow", *design)
    emit(phase=phase, model=name, synthesis_s=gate.synthesis_time_s)
    check(phase, f"{name}_fullflow_captured_at_build",
          isinstance(full, CapturedExecutor) and list(full.graphs) == [one]
          and gate.compiled is full.graphs[one][0])
    outs = [full(x) for x in xs]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(phase, f"{name}_fullflow_launched_every_kernel_of_the_path",
          all(counts[k] > 0 for k, v in expect.items() if v),
          counts=counts, per_eager_forward=expect)
    check(phase, f"{name}_fullflow_equals_eager",
          len(outs) == len(want)
          and all(torch.equal(a, b) for a, b in zip(outs, want)))
    check(phase, f"{name}_fullflow_results_kept_across_calls",
          len(outs) >= 2 and outs[0].data_ptr() != outs[1].data_ptr()
          and torch.equal(outs[0], want[0]) and torch.equal(outs[1], want[1]))
    shapes = {one} | {tuple(x.shape) for x in xs}
    check(phase, f"{name}_fullflow_new_shape_captured_on_first_use",
          len(shapes) > 1 and set(full.graphs) == shapes,
          shapes=sorted(shapes))
    if profile:
        x = xs[0]
        wanted: dict = {}
        for k, n in expect.items():
            if n:
                wanted[KERNEL_OF[k]] = wanted.get(KERNEL_OF[k], 0) + n
        replay = device_kernels(torch, lambda: full(x))
        # only the eager paths' kernel names are read, so each trace
        # holds two forwards: the profiler has dropped a window's first
        # kernels, the ingress's, which the replay then shows alone
        # (VGG-16's int8 cast in the flow phase, PR 21)
        kernel_path = device_kernels(torch, lambda: (eager(x), eager(x)))
        with plain_ops():
            plain_path = device_kernels(torch,
                                        lambda: (eager(x), eager(x)))
        got = {k: sum(n for key, n in replay.items() if k in key)
               for k in wanted}
        plain_only = set(plain_path) - set(kernel_path)
        leaked = sorted(set(replay) & plain_only)
        # kernels of the replay that no eager trace showed: printed, not
        # failed on (AlexNet's eager traces lack the ingress's round
        # kernel that its replay shows, in 2 of 3 runs on the H100)
        unseen = sorted(k for k in set(replay) - set(kernel_path)
                        if not k.startswith(("Memcpy", "Memset")))
        check(phase, f"{name}_fullflow_replay_launches_the_kernels",
              got == wanted and not leaked,
              replay_launches=got, expected=wanted,
              plain_kernels_in_replay=leaked,
              not_in_the_eager_traces=unseen,
              device_launches=sum(replay.values()))
    return full


def call_cost(name, a, kw) -> tuple:
    """(bytes, operations) of one recorded kernel call: a GEMM's or a
    conv's operands read once and its output written once, and two
    operations a multiply-add; a max-pool's input and output bytes."""
    from repro_torch.kernels import ref
    if name == "qgemm":
        m, k = a[0].shape
        n = a[1].shape[1]
        return m * k + k * n + 4 * n + m * n, 2 * m * k * n
    if name == "maxpool2d":
        xx, window, stride, pads = a
        oh, ow = ref.out_hw(xx.shape[1], xx.shape[2], window, window,
                            (stride, stride), pads)
        return xx.numel() + xx.shape[0] * oh * ow * xx.shape[3], 0
    xx, ww = a[0], a[1]
    nb = xx.shape[0]
    hp, wp = padded_hw(xx, kw)
    kh, kw_, _, cout = ww.shape
    sh, sw = kw["strides"]
    ho, wo = (hp - kh) // sh + 1, (wp - kw_) // sw + 1
    pool = kw.get("pool")
    oh, ow = ((ho - pool[0]) // pool[1] + 1,
              (wo - pool[0]) // pool[1] + 1) if pool else (ho, wo)
    nbytes = xx.numel() + ww.numel() + 4 * cout + nb * oh * ow * cout
    if kw.get("skip") is not None:
        nbytes += kw["skip"].numel()
    # multiply-adds: each output reads KH*KW*(Cin per group)
    return nbytes, 2 * nb * ho * wo * cout * kh * kw_ * ww.shape[2]


def both_sides(torch, kernel, plain, a, kw) -> tuple:
    """One recorded call through the kernel and through its plain version,
    the plain side on copies of the tensors (an ``out_buf`` is written in
    place)."""
    y = kernel(*a, **kw)
    yp = plain(*[t.clone() if torch.is_tensor(t) else t for t in a],
               **{k: (v.clone() if torch.is_tensor(v) else v)
                  for k, v in kw.items()})
    return y, yp


def kernel_records(torch, run, x, launches, dev, phase, plain_times=True):
    """Hold every kernel call one forward makes equal to its plain
    version at that call's shapes and time both (the plain version only
    with ``plain_times``); return per-kernel sums and bounds, and for the
    convs and the GEMM each call's plan (:func:`conv_plan`,
    :func:`gemm_plan`), which its ``timing`` line prints too.
    ``library_ms`` stays
    None: PyTorch has no int8 conv, and ``torch._int_mm`` takes no
    M <= 16 (see :func:`library_yardstick`).  A max-pool call counts the
    bytes it reads and writes, and its plan is its chunk."""
    from repro_torch.kernels.pool import chunk_width
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
                                      library_ms=None, calls=0, err=0,
                                      plans=[]))
        nbytes, nops = call_cost(name, a, kw)
        r["bytes"] += nbytes
        r["ops"] += nops
        y, yp = both_sides(torch, kernel[name], plain[name], a, kw)
        err = (y.int() - yp.int()).abs().max().item()
        check(phase, f"{name}_call{r['calls']}_equals_plain", err == 0,
              max_abs_err=err)
        r["err"] = max(r["err"], err)
        ms = time_ms(torch, lambda: kernel[name](*a, **kw), flush=flush)
        plain_ms = (time_ms(torch, lambda: plain[name](*a, **kw),
                            flush=flush) if plain_times else None)
        pl = (gemm_plan(a[0], a[1]) if name == "qgemm"
              else dict(chunk=chunk_width(a[0].shape[-1], a[0].data_ptr(),
                                          y.data_ptr()))
              if name == "maxpool2d" else conv_plan(name, a[0], a[1], kw))
        r["plans"].append(pl)
        emit(phase="timing", kernel=name, call=r["calls"],
             batch=int(a[0].shape[0]),
             shapes=[list(t.shape) for t in a if torch.is_tensor(t)],
             pool=kw.get("pool"), skip=kw.get("skip") is not None,
             ms=ms, plain_ms=plain_ms, plan=pl)
        r["ms"] += ms
        r["plain_ms"] += plain_ms or 0.0
        r["calls"] += 1
    out = {}
    for name, r in rec.items():
        t_bytes = r["bytes"] / card().hbm_bandwidth * 1e3
        t_ops = r["ops"] / card().peak_int8_ops * 1e3
        out[name] = dict(launches=launches.get(name, 0),
                         calls_timed=r["calls"], max_abs_err=r["err"],
                         ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         library_ms=r["library_ms"], plans=r["plans"])
    return out


def device_time(torch, fn, wall_ms: float, kinds=None) -> dict:
    """Device time of one call by kernel name, from ``torch.profiler``,
    and its share of the call's wall time measured without the
    profiler (the device's busy share; the rest is idle).  ``kinds``
    ((label, regex) pairs, the first match wins) adds every kernel's time
    summed by kind, ``other`` for the rest."""
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
    out = dict(device_ms=device_ms, wall_ms=wall_ms,
               device_busy_share=device_ms / wall_ms,
               top_device_ms=dict(top))
    if kinds:
        by_kind: dict = {}
        for key, ms in per_kernel.items():
            label = next((lb for lb, rx in kinds if re.search(rx, key)),
                         "other")
            by_kind[label] = by_kind.get(label, 0.0) + ms
        out["device_ms_by_kind"] = dict(sorted(by_kind.items(),
                                               key=lambda kv: -kv[1]))
    return out


def launch_split(torch, fn, calls: int = 5) -> dict:
    """Device launches and device ms of each kernel, per call of ``fn``,
    from ``torch.profiler`` over ``calls`` calls (L2 warm): where the
    time of one call falls between its kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        r = split.setdefault(ev.key, dict(launches_per_call=0.0,
                                          ms_per_call=0.0))
        r["launches_per_call"] += ev.count / calls
        r["ms_per_call"] += ev.self_device_time_total / 1e3 / calls
    return split


def qgemm_launch_split(torch, dev) -> None:
    """The device launches of one ``qgemm`` call at each of VGG-16's FC
    shapes at batch 1 and 8, with the weight staged K-major once as the
    executor stages it, and the device ms of each."""
    from repro_torch.kernels import qgemm
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for m in (1, 8):
        for k, n, relu in ((25088, 4096, True), (4096, 4096, True),
                           (4096, 1000, False)):
            x = rand_i8(torch, (m, k), gen, dev)
            w = rand_i8(torch, (k, n), gen, dev)
            w_k = qgemm.stage_kmajor(w)   # staged once, as a layer does
            b = rand_bias(torch, n, gen, dev)
            split = launch_split(torch, lambda: qgemm.qgemm(
                x, w, b, shift=shift_for(k), relu=relu, w_k=w_k))
            emit(phase="vgg16", what="qgemm_launch_split", m=m, k=k, n=n,
                 launches_per_call=sum(r["launches_per_call"]
                                       for r in split.values()),
                 per_kernel=split)


#: The conv's two int8 ``wgmma`` kernels: the dense and the grouped
#: instance of one body (``csrc/qconv.cu``).
QCONV_KERNELS = ("qconv_wgmma_kernel", "qconv_grouped_wgmma_kernel")


def wgmma_launches(torch, fn, kernels=QCONV_KERNELS) -> dict:
    """Launches of int8 ``wgmma`` kernels (a tuple of names, the conv's
    two by default) in one call of ``fn``, as ``torch.profiler`` sees
    them on the device (:func:`device_kernels`), beside the launches of
    every device kernel in the trace."""
    seen = device_kernels(torch, fn)
    return dict(wgmma_launches=sum(n for key, n in seen.items()
                                   if any(k in key for k in kernels)),
                device_launches=sum(seen.values()))


def one_launch_per_fc(torch, phase: str, tag: str, run, x) -> None:
    """The profiler sees one ``qgemm`` kernel launch per FC call of a
    forward, and an FC call alone launches that kernel and nothing else:
    no zeroed scratch, no second kernel."""
    from repro_torch.kernels import qgemm
    calls: list = []
    with recorded_calls(calls):
        run(x)
    fcs = [(a, kw) for name, a, kw in calls if name == "qgemm"]
    forward = wgmma_launches(torch, lambda: run(x), ("qgemm_wgmma_kernel",))
    alone = [wgmma_launches(torch, lambda: qgemm.qgemm(*a, **kw),
                            ("qgemm_wgmma_kernel",)) for a, kw in fcs]
    check(phase, f"{tag}_one_qgemm_launch_per_fc_call",
          forward["wgmma_launches"] == len(fcs) > 0
          and all(r["wgmma_launches"] == r["device_launches"] == 1
                  for r in alone),
          fc_calls=len(fcs), forward=forward, each_call_alone=alone)


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
    run, outs, ms, full = serve(torch, gate, reqs + [batch], expect,
                                "vgg16", "vgg16")
    fullflow_walls(torch, "vgg16", "vgg16", run, full, reqs + [batch])
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
    ops.reset_launch_counts()
    run(batch)
    b8 = kernel_records(torch, run, batch, ops.launch_counts(), dev,
                        "vgg16_batch8", plain_times=False)
    emit(phase="vgg16", batch=8, qconv2d_ms=b8["qconv2d"]["ms"],
         qgemm_ms=b8["qgemm"]["ms"],
         qconv2d_bound_ms=b8["qconv2d"]["bound_ms"],
         qgemm_bound_ms=b8["qgemm"]["bound_ms"])
    records["qgemm"]["extra"] = dict(batch8_ms=b8["qgemm"]["ms"],
                                     batch8_bound_ms=b8["qgemm"]["bound_ms"])
    for x, tag in ((reqs[0], "batch1"), (batch, "batch8")):
        wg = wgmma_launches(torch, lambda: run(x))
        check("vgg16", f"every_conv_call_on_the_wgmma_kernel_{tag}",
              wg["wgmma_launches"] == 13, conv_calls=13, **wg)
        one_launch_per_fc(torch, "vgg16", f"vgg16_{tag}", run, x)
    attach_qconv_build(torch, records, "qconv2d")
    attach_qgemm_build(torch, records)
    qgemm_launch_split(torch, dev)
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
        run, outs, ms, full = serve(torch, gate, reqs + [batch], expect,
                                    "mobilenet", tag)
        fullflow_walls(torch, "mobilenet", tag, run, full, reqs + [batch])
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
        one_launch_per_fc(torch, "mobilenet", tag, run, reqs[0])
        if not per_channel:
            ops.reset_launch_counts()
            run(reqs[0])
            launches = ops.launch_counts()
            records.update({k: v for k, v in kernel_records(
                torch, run, reqs[0], launches, dev, "mobilenet").items()
                if k == "qdwconv2d"})
            ops.reset_launch_counts()
            run(batch)
            b8 = kernel_records(torch, run, batch, ops.launch_counts(), dev,
                                "mobilenet_batch8", plain_times=False)
            dw = records["qdwconv2d"]
            dw["extra"] = dict(batch8_ms=b8["qdwconv2d"]["ms"],
                               batch8_bound_ms=b8["qdwconv2d"]["bound_ms"],
                               launch_floor_ms=launch_floor_ms(torch),
                               plans=dw.pop("plans"),
                               batch8_plans=b8["qdwconv2d"]["plans"])
            emit(phase="mobilenet", what="qdwconv2d_times",
                 launches=dw["launches"], batch1_ms=dw["ms"],
                 batch1_bound_ms=dw["bound_ms"], **dw["extra"])


#: The batch of the offline cells ``mobilenet_v2.offline_b512`` and
#: ``resnext50_32x4d.offline_b512``, at which :func:`phase_mobilenet_v2`
#: and :func:`phase_resnext50` hold every kernel call.
OFFLINE_BATCH = 512
#: MobileNetV2's batch-512 stages timed beside their bounds: (label,
#: wrapper, Cin, Cout, stride, input H), each found among the calls of
#: the eager forward.
MOBILENET_V2_STAGES = (
    ("block2_dw_112x96_s2", "qdwconv2d", 96, 96, 2, 112),
    ("block3_dw_56x144_s1", "qdwconv2d", 144, 144, 1, 56),
    ("block2_expand_112x16_96", "qconv2d", 16, 96, 1, 112),
    ("block1_project_112x32_16", "qconv2d", 32, 16, 1, 112),
)


def phase_mobilenet_v2(torch, dev, records):
    """MobileNetV2 1.0 at full width (224x224, 1000 classes), the net of
    the ``mobilenet_v2.offline_b512`` cell: the build counters (35
    clamped stages, 10 fused skips); the fullflow executor on batch-1
    requests and a batch of 8 (:func:`fullflow_checks`); then one eager
    forward at the cell's batch of 512, whose launch counts are held
    (dense conv 35, depthwise 17 each taking its pads itself, GEMM 1; 18
    dense and 17 depthwise launches clamping below 127, 10 with a skip),
    whose logits equal the plain path's, and each of whose kernel calls
    equals its plain version at the call's shapes and epilogue.  Four
    of those calls (:data:`MOBILENET_V2_STAGES`) are timed beside their
    bound and the plain version, block 1's projection (Cout 16, linear
    in the net) also with a clamp (at 96, or at half its largest output
    where that is lower); their rows go to the dense and
    depthwise kernels' records."""
    from repro_torch.core import telemetry as tele
    from repro_torch.core.synthesis import CNN2Gate
    from repro_torch.kernels import ops, qconv
    from repro_torch.models import cnn

    phase = "mobilenet_v2"
    rng = np.random.default_rng(SEED + 3)
    gate = CNN2Gate.from_graph(cnn.mobilenet_v2(batch=1, seed=SEED))
    gate.calibrate_quantization(
        rng.standard_normal((1, 3, 224, 224)).astype(np.float32))
    reg = tele.get_registry()
    names = ("build.clipped_stages", "build.fused_skips")
    before = [reg.counter(n).value for n in names]
    run = gate.build("emulation")
    built = [reg.counter(n).value - v for n, v in zip(names, before)]
    check(phase, "build_counts_35_clamped_stages_10_fused_skips",
          built == [35, 10], counters=dict(zip(names, built)))
    expect = {"qconv2d": 35, "qdwconv2d": 17, "qgemm": 1}
    reqs = [torch.as_tensor(rng.standard_normal((n, 3, 224, 224))
                            .astype(np.float32), device=dev)
            for n in (1, 1, 8)]
    fullflow_checks(torch, gate, run, reqs, [run(x) for x in reqs], expect,
                    phase, phase)

    x = torch.as_tensor(rng.standard_normal((OFFLINE_BATCH, 3, 224, 224))
                        .astype(np.float32), device=dev)
    ops.reset_launch_counts()
    y = run(x)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    epilogues = dict(qconv.skip_launches)
    padded = qconv.padded_launches["qdwconv"]
    check(phase, "batch512_launches",
          all(launches[k] == v for k, v in expect.items())
          and epilogues == {"qconv": 10, "qdwconv": 0, "qconv.clip": 18,
                            "qdwconv.clip": 17} and padded == 17,
          launches={k: launches[k] for k in expect},
          skip_launches=epilogues, padded_depthwise_launches=padded)
    with plain_ops():
        yp = run(x)
    torch.cuda.synchronize()
    check(phase, "batch512_kernel_path_equals_plain_path",
          torch.equal(y, yp) and bool(torch.isfinite(y).all()),
          shape=list(y.shape))
    del y, yp

    calls: list = []
    with recorded_calls(calls):
        run(x)
    torch.cuda.synchronize()
    wrap = wrappers()
    bad = []
    for i, (name, a, kw) in enumerate(calls):
        yk, ypl = both_sides(torch, wrap[name][1], wrap[name][2], a, kw)
        if not torch.equal(yk, ypl):
            bad.append((i, name, list(a[0].shape), kw.get("hi")))
    check(phase, "every_call_of_the_batch512_forward_equals_plain",
          not bad and len(calls) == 53, calls=len(calls), failures=bad[:10],
          clamped_calls=sum(kw.get("hi", 127) < 127 for _n, _a, kw in calls))

    flush = torch.empty(96 << 20, dtype=torch.int8, device=dev).zero_
    rows: dict = {"qconv2d": [], "qdwconv2d": []}
    for label, name, cin, cout, stride, h in MOBILENET_V2_STAGES:
        _n, a, kw = next(
            c for c in calls if c[0] == name and c[1][0].shape[1] == h
            and c[1][0].shape[-1] == cin and c[1][1].shape[-1] == cout
            and tuple(c[2]["strides"]) == (stride, stride))
        variants = [(label, kw)]
        if kw.get("hi", 127) == 127:
            # the linear projection with a clamp too: at 96, or at half its
            # largest output where that stays below 96, so that it acts
            top = int(wrap[name][2](*a, **kw).max())
            hi = min(96, max(1, top // 2))
            variants.append((f"{label}_clamped_{hi}",
                             dict(kw, relu=True, hi=hi)))
        for tag, kw_ in variants:
            _mod, fn, plain = wrap[name]
            yk, ypl = both_sides(torch, fn, plain, a, kw_)
            hi = kw_.get("hi", 127)
            nbytes, nops = call_cost(name, a, kw_)
            t_bytes = nbytes / card().hbm_bandwidth * 1e3
            t_ops = nops / card().peak_int8_ops * 1e3
            row = dict(stage=tag, shape=list(a[0].shape), cout=cout,
                       stride=stride, relu=bool(kw_["relu"]), hi=hi,
                       share_at_hi=float((ypl == hi).float().mean()),
                       ms=time_ms(torch, lambda: fn(*a, **kw_), flush=flush),
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations",
                       plain_ms=time_ms(torch, lambda: plain(*a, **kw_),
                                        reps=3, flush=flush),
                       plan=conv_plan(name, a[0], a[1], kw_))
            check(phase, f"{tag}_batch512_equals_plain",
                  torch.equal(yk, ypl), **row)
            rows[name].append(row)
    check(phase, "the_clamp_acts_in_every_clamped_timed_stage",
          all(r["share_at_hi"] > 0 for rs in rows.values() for r in rs
              if r["hi"] < 127))
    for name, rs in rows.items():
        if name in records:
            records[name].setdefault("extra", {})["mobilenet_v2_batch512"] = rs


#: ResNeXt-50's grouped stages timed at batch 512, one a per-group width:
#: (label, Cin = Cout, stride, input H), each found among the calls of the
#: eager forward
RESNEXT50_STAGES = (
    ("layer1_conv2_56x128_g4", 128, 1, 56),
    ("layer2_0_conv2_56x256_g8_s2", 256, 2, 56),
    ("layer3_conv2_14x512_g16", 512, 1, 14),
    ("layer4_conv2_7x1024_g32", 1024, 1, 7),
)


def phase_resnext50(torch, dev, records):
    """ResNeXt-50 (32x4d) at full width (224x224, 1000 classes), the net of
    the ``resnext50_32x4d.offline_b512`` cell: the build counters (16
    grouped stages, 16 fused skips); the fullflow executor on batch-1
    requests and a batch of 8 (:func:`fullflow_checks`, the replay's 16
    grouped launches under ``qconv_grouped_wgmma_kernel``); then one eager
    forward at the cell's batch of 512, whose launch counts are held
    (dense conv 37, grouped 16, max-pool 1, GEMM 1; 16 with a skip; the
    grouped launches' packs ``qconv.group_pack`` 16, 8, 4 and 2 groups a
    tile, 3, 4, 6 and 3 times), whose logits equal the plain path's, and
    each of whose kernel calls
    equals its plain version.  One grouped stage of each per-group width
    (:data:`RESNEXT50_STAGES`) is timed beside its bound and the plain
    version; the rows go to the grouped kernel's record."""
    from repro_torch.core import telemetry as tele
    from repro_torch.core.synthesis import CNN2Gate
    from repro_torch.kernels import ops, qconv
    from repro_torch.models import cnn

    phase = "resnext50_32x4d"
    rng = np.random.default_rng(SEED + 4)
    gate = CNN2Gate.from_graph(cnn.resnext50_32x4d(batch=1, seed=SEED))
    gate.calibrate_quantization(
        rng.standard_normal((1, 3, 224, 224)).astype(np.float32))
    reg = tele.get_registry()
    names = ("build.grouped_stages", "build.fused_skips")
    before = [reg.counter(n).value for n in names]
    run = gate.build("emulation")
    built = [reg.counter(n).value - v for n, v in zip(names, before)]
    check(phase, "build_counts_16_grouped_stages_16_fused_skips",
          built == [16, 16], counters=dict(zip(names, built)))
    expect = {"qconv2d": 37, "qgconv2d": 16, "maxpool2d": 1, "qgemm": 1}
    reqs = [torch.as_tensor(rng.standard_normal((n, 3, 224, 224))
                            .astype(np.float32), device=dev)
            for n in (1, 1, 8)]
    fullflow_checks(torch, gate, run, reqs, [run(x) for x in reqs], expect,
                    phase, phase)

    x = torch.as_tensor(rng.standard_normal((OFFLINE_BATCH, 3, 224, 224))
                        .astype(np.float32), device=dev)
    ops.reset_launch_counts()
    y = run(x)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(phase, "batch512_launches",
          all(launches[k] == v for k, v in expect.items())
          and qconv.skip_launches["qconv"] == 16,
          launches={k: launches[k] for k in expect},
          skip_launches=dict(qconv.skip_launches))
    # 4, 8, 16 and 32 channels a group: 16, 8, 4 and 2 groups a tile
    check(phase, "batch512_group_pack",
          qconv.group_pack == {"16": 3, "8": 4, "4": 6, "2": 3},
          group_pack=dict(qconv.group_pack))
    with plain_ops():
        yp = run(x)
    torch.cuda.synchronize()
    check(phase, "batch512_kernel_path_equals_plain_path",
          torch.equal(y, yp) and bool(torch.isfinite(y).all()),
          shape=list(y.shape))
    del y, yp

    calls: list = []
    with recorded_calls(calls):
        run(x)
    torch.cuda.synchronize()
    wrap = wrappers()
    bad = []
    for i, (name, a, kw) in enumerate(calls):
        yk, ypl = both_sides(torch, wrap[name][1], wrap[name][2], a, kw)
        if not torch.equal(yk, ypl):
            bad.append((i, name, list(a[0].shape), kw.get("groups")))
    del yk, ypl
    check(phase, "every_call_of_the_batch512_forward_equals_plain",
          not bad and len(calls) == 55, calls=len(calls), failures=bad[:10],
          grouped_calls=sum(n == "qgconv2d" for n, _a, _kw in calls))

    flush = torch.empty(96 << 20, dtype=torch.int8, device=dev).zero_
    rows = []
    for label, c, stride, h in RESNEXT50_STAGES:
        _n, a, kw = next(
            call for call in calls if call[0] == "qgconv2d"
            and call[1][0].shape[1] == h and call[1][0].shape[-1] == c
            and tuple(call[2]["strides"]) == (stride, stride))
        fn, plain = wrap["qgconv2d"][1:]
        yk, ypl = both_sides(torch, fn, plain, a, kw)
        nbytes, nops = call_cost("qgconv2d", a, kw)
        t_bytes = nbytes / card().hbm_bandwidth * 1e3
        t_ops = nops / card().peak_int8_ops * 1e3
        row = dict(stage=label, shape=list(a[0].shape), groups=kw["groups"],
                   channels_a_group=c // kw["groups"], stride=stride,
                   ms=time_ms(torch, lambda: fn(*a, **kw), flush=flush),
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   plain_ms=time_ms(torch, lambda: plain(*a, **kw), reps=3,
                                    flush=flush),
                   plan=conv_plan("qgconv2d", a[0], a[1], kw))
        check(phase, f"{label}_batch512_equals_plain", torch.equal(yk, ypl),
              **row)
        rows.append(row)
    if "qgconv2d" in records:
        records["qgconv2d"].setdefault("extra", {})[
            "resnext50_batch512"] = rows


def launch_floor_ms(torch) -> float:
    """An empty kernel's time under :func:`time_ms`'s timer: the least a
    launch can show there (``torch.cuda._sleep(0)`` spins no cycles)."""
    return time_ms(torch, lambda: torch.cuda._sleep(0))


def library_yardstick(torch, dev, m: int = 32) -> None:
    """``torch._int_mm`` (int8 x int8 -> int32, no bias or requant) takes
    only M > 16, so it has no time at the main path's M = 1 and 8; time
    it and the qgemm kernel at VGG-16's FC shapes with M = 32, the
    kernel's weight staged K-major once beforehand, as a layer stages
    it."""
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
        w_k = qgemm.stage_kmajor(w)
        emit(phase="library", m=m, k=k, n=n,
             qgemm_ms=time_ms(torch, lambda: qgemm.qgemm(
                 x, w, b, shift=shift_for(k), relu=True, w_k=w_k),
                 flush=flush),
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
        from repro_torch.kernels import qconv
        grouped = [li for li in layers if li.kind == "conv" and li.group > 1]
        # 48-192 channels a group: none narrow enough to pack
        return [("three_grouped_launches_two_pooled",
                 launches["qgconv2d"] == 3 and len(grouped) == 3
                 and sum(li.pool is not None for li in grouped) == 2),
                ("no_grouped_launch_packs_groups", not qconv.group_pack)]
    return []


def verifier_checks(phase, tag, fused, unfused) -> None:
    """The static verifier and the QV501/QV502 probes on the programs
    built on the card: both clean for the fused program, and the probe
    sees one standalone merge call for each merge stage of the unfused
    one."""
    from repro_torch.core import verify as V
    rep = fused.verify()
    probes = V.structural_probes(fused.quantized)
    check(phase, f"{tag}_verifier_and_probes_clean",
          rep.ok and not probes,
          diagnostics=[str(d) for d in rep.diagnostics + probes])
    trace = V.executor_trace(unfused.quantized)
    layers = unfused.parsed.layers
    check(phase, f"{tag}_probe_sees_each_unfused_merge",
          V.int_add_calls(trace) == sum(li.kind == "add" for li in layers)
          and V.concat_calls(trace) == sum(li.kind == "concat"
                                           for li in layers),
          qadd_calls=V.int_add_calls(trace),
          qconcat_calls=V.concat_calls(trace))


#: Which kernel's record each path of phase 4 supplies.
PATH_RECORDS = {"googlenet_tiny": "qconv2d_into",
                "dw_concat": "qdwconv2d_into", "alexnet_2tower": "qgconv2d"}


def phase_paths(torch, dev, records):
    from repro_torch.core.synthesis import CNN2Gate
    from repro_torch.kernels import ops, qconv
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
        reqs = [torch.as_tensor(rng.standard_normal((1, 3, hw, hw))
                                .astype(np.float32), device=dev)
                for _ in range(3)] + xs
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
            n_maxpool = sum(li.kind == "pool" and li.pool_type == "max"
                            for li in fused.parsed.layers)
            conv_launches = sum(launches[k] for k in qconv.launches)
            check(name, f"{tag}_every_stage_on_a_kernel",
                  conv_launches == n_conv and launches["qgemm"] == n_fc
                  and launches["maxpool2d"] == n_maxpool,
                  launches=launches, conv_stages=n_conv, fc_stages=n_fc,
                  maxpool_stages=n_maxpool)
            if name == "resnet18" and not per_channel:
                records["maxpool2d"] = pool_record(torch, dev,
                                                   launches["maxpool2d"])
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
            verifier_checks(name, tag, fused, unfused)
            want = [run_f(x) for x in reqs]
            fullflow_checks(torch, fused, run_f, reqs, want, launches, name,
                            tag, profile=not per_channel)
            if name in PATH_RECORDS and not per_channel:
                recs = kernel_records(torch, run_f, xs[0], launches, dev,
                                      name)
                if name in ("alexnet_2tower", "googlenet_tiny"):
                    wg = wgmma_launches(torch, lambda: run_f(xs[0]))
                    check(name, f"{tag}_every_conv_call_on_the_wgmma_kernel",
                          wg["wgmma_launches"] == n_conv, conv_calls=n_conv,
                          **wg)
                kept = PATH_RECORDS[name]
                records[kept] = recs[kept]
                if kept == "qdwconv2d_into":
                    records[kept]["extra"] = dict(
                        launch_floor_ms=launch_floor_ms(torch),
                        plans=records[kept].pop("plans"))
                    emit(phase=name, what="qdwconv2d_into_times",
                         launches=recs[kept]["launches"],
                         ms=recs[kept]["ms"],
                         bound_ms=recs[kept]["bound_ms"],
                         **records[kept]["extra"])
                if kept != "qdwconv2d_into":
                    attach_qconv_build(torch, records, kept)
            if name == "resnet18":
                one_launch_per_fc(torch, name, tag, run_f, xs[0])
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


# ------------------------------------------- phase 4b: the paper's flow

#: The DSE's decisions on the paper's three boards, as the FPGA model of
#: ``core/resources.py`` gives them (the JAX package's model, to the
#: byte): AlexNet as the paper's Table 2; VGG-16's 138 M weights take
#: 614 of 5CSEMA5's 397 RAM blocks at (8, 8) in the calibrated RAM
#: model, so no option fits that board.
FLOW_DECISIONS = {"alexnet": {"5CSEMA4": None, "5CSEMA5": (8, 8),
                              "ARRIA10": (16, 32)},
                  "vgg16": {"5CSEMA4": None, "5CSEMA5": None,
                            "ARRIA10": (16, 32)}}


def phase_flow(torch, dev, records):
    """The paper's whole flow at full width (224x224, 1000 classes,
    random weights from a seed) for AlexNet and VGG-16: ``from_graph`` ->
    ``calibrate_quantization`` -> ``verify()`` (and the QV501/QV502
    probes) -> ``explore`` on the three boards, BF and RL -> the ARRIA10
    ``latency_report`` (the FPGA model, not a card time) ->
    ``build("fullflow", *best)`` serving 8 batch-1 requests and one batch
    of 8, every result equal to the eager executor's, with the launch
    counts set to 0 before the build and read after the last request;
    then both executors' walls on the same requests and the fullflow's
    device busy share."""
    from repro_torch.core import verify as V
    from repro_torch.core.synthesis import CNN2Gate
    from repro_torch.kernels import ops
    from repro_torch.models import cnn

    for name in ("alexnet", "vgg16"):
        t0 = time.perf_counter()
        gate = CNN2Gate.from_graph(getattr(cnn, name)(batch=1, seed=SEED))
        rng = np.random.default_rng(SEED + 3)
        gate.calibrate_quantization(rng.standard_normal(
            (1, 3, 224, 224)).astype(np.float32))
        emit(phase="flow", model=name,
             setup_s=time.perf_counter() - t0,
             weights_m=gate.parsed.total_weights / 1e6)
        t0 = time.perf_counter()
        rep = gate.verify()
        probes = V.structural_probes(gate.quantized)
        check("flow", f"{name}_verifies_clean",
              rep.ok and not rep.diagnostics and not probes,
              diagnostics=[str(d) for d in rep.diagnostics + probes],
              verify_s=time.perf_counter() - t0)
        for board, expected in FLOW_DECISIONS[name].items():
            bf = gate.explore(board, algo="bf")
            rl = [gate.explore(board, algo="rl", seed=seed)
                  for seed in range(3)]
            check("flow", f"{name}_{board}_decision",
                  bf.best == expected
                  and all(r.best == expected for r in rl),
                  bf=bf.best, rl=[r.best for r in rl], expected=expected,
                  f_max=bf.f_max, bf_evaluations=bf.evaluations,
                  rl_evaluations=[r.evaluations for r in rl])
        best = gate.explore("ARRIA10", algo="rl", seed=0).best
        lat = gate.latency_report("ARRIA10", *best)
        emit(phase="flow", model=name, what="fpga_latency_model",
             board="ARRIA10", design_point=best,
             fpga_model_total_ms=lat.total_s * 1e3,
             fpga_model_gops=lat.gops,
             note="the Table-1 FPGA model's latency on the board, "
                  "not a time on the card")
        reqs = [torch.as_tensor(rng.standard_normal((1, 3, 224, 224))
                                .astype(np.float32), device=dev)
                for _ in range(8)]
        xs = reqs + [torch.cat(reqs)]
        eager = gate.build("emulation", *best)
        ops.reset_launch_counts()
        want = [eager(x) for x in xs]
        expect = {k: v // len(xs) for k, v in ops.launch_counts().items()}
        check("flow", f"{name}_eager_forward_launches",
              expect["qconv2d"] > 0 and expect["qgemm"] == 3,
              per_forward=expect)
        full = fullflow_checks(torch, gate, eager, xs, want, expect, "flow",
                               name, design=best)
        check("flow", f"{name}_fullflow_design_point",
              full.design_point == tuple(best) + (None,),
              design_point=full.design_point)
        check("flow", f"{name}_fullflow_batch8_equals_8_requests",
              torch.equal(full(xs[-1]), torch.cat([full(x) for x in reqs]))
              and all(bool(torch.isfinite(y).all()) for y in want)
              and tuple(want[-1].shape) == (8, 1000))
        fullflow_walls(torch, "flow", name, eager, full, xs)


# ------------------------------------- phase 4c: resilience and profiling

def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi: {smi.stderr.strip()}")


def report_key(rep) -> tuple:
    """What a guarded run decided: outcome, flagged stages, the ladder's
    actions with their flags, ``replayed`` and ``boundary``."""
    return (rep.outcome, tuple(rep.flagged), rep.recovered_by,
            tuple((a.action, tuple(a.flagged), a.replayed, a.boundary)
                  for a in rep.actions))


def record_key(r) -> tuple:
    return (r.plan, r.stages, r.flagged, r.outcome, r.output_differs,
            r.recovered, r.escalated, r.replayed)


def guarded_run(torch, gx, x, tag, golden=None, **want):
    """Run the guarded executor ``gx`` on ``x`` on the kernel path, then
    the same executor on the plain path; the logits must be
    ``torch.equal`` and the reports the same.  ``golden`` (logits) and
    ``want`` (outcome, recovered_by, actions) are what the run must
    give."""
    y, rep = gx(x)
    with plain_ops():
        yp, repp = gx(x)
    key = report_key(rep)
    ok = torch.equal(y, yp) and key == report_key(repp)
    if golden is not None:
        ok = ok and torch.equal(y, golden)
    for k, v in want.items():
        got = ([a.action for a in rep.actions] if k == "actions"
               else getattr(rep, k))
        ok = ok and got == v
    check("resilience", tag, ok, outcome=rep.outcome, flagged=rep.flagged,
          actions=[dataclasses.asdict(a) for a in rep.actions],
          recovered_by=rep.recovered_by,
          plain=report_key(repp) == key, expected=want)
    return rep


def first_upset(gx, qm, faults_mod, candidates):
    """The guarded executor over the first candidate plan whose run is
    not clean (a flip can die inside the datapath), and its plan."""
    for plan in candidates:
        gxf = gx.with_program(faults_mod.inject(qm, plan))
        _, rep = gxf(gx.x_cal)
        if rep.outcome != "clean":
            return gxf, plan
    return gxf, plan


def campaign_yardstick(torch, gate, x, *, trials, kinds, seed, checkpoints,
                       flips=1):
    """The campaign one trial at a time, as the port ran it before its
    trial form: each plan through ``faults.inject`` and the audited
    executor alone, each detected trial's snapshot replayed alone through
    the golden ``replay_from`` executor.  Returns its ``TrialRecord``s, the
    yardstick ``run_campaign``'s are held to."""
    from repro_torch.core import faults as F
    from repro_torch.core import pipeline as pipe
    from repro_torch.core import resources as R
    from repro_torch.core import ser

    qm = gate.quantized
    stages = qm.layers
    names = [ql.info.name for ql in stages]
    plans = [F.FaultPlan.sample(qm, flips, kinds=kinds, seed=seed + 17 * t)
             for t in range(trials)]
    a_touched = sorted({f.tensor for p in plans for f in p.faults
                        if f.kind == F.ACTIVATION_BIT})
    slots = max([sum(1 for f in p.faults if f.kind == F.ACTIVATION_BIT)
                 for p in plans] + [1])
    bnd = R.plan_checkpoints(gate.parsed, checkpoints)

    def run(qm_t, plan):
        ex = pipe.make_executor(qm_t, audit=True, checkpoints=bnd or None,
                                fault_args=tuple(a_touched))
        extra = ((ser._trial_payload(plan, a_touched, slots),)
                 if a_touched else ())
        res = ex(x, *extra)
        return res[0], pipe.stats_to_host(res[1]), (res[2] if bnd else {})

    y0, st0, _ = run(qm, F.FaultPlan(()))
    audited = sorted(st0)
    t2s = {ql.info.output: ql.info.name for ql in stages}
    replays = {b: pipe.make_executor(qm, audit=True, replay_from=b)
               for b in bnd}
    records = []
    for plan in plans:
        y, st, ck = run(F.inject(qm, plan), plan)
        flags = ser._flag_matrix({t: st[t][None] for t in audited}, st0,
                                 audited, 0.0, 0.0)[0]
        differs = not torch.equal(y, y0)
        flagged = tuple(t2s[t] for t, hit in zip(audited, flags)
                        if hit and t in t2s)
        rec = ser.TrialRecord(
            plan=plan, stages=tuple(dict.fromkeys(f.stage
                                                  for f in plan.faults)),
            flagged=flagged, outcome=("detected" if flagged else
                                      "masked" if not differs else "silent"),
            output_differs=differs)
        if flagged:
            first = min(names.index(s) for s in flagged)
            b = max([c for c in bnd if c < first], default=None)
            rec.recovered = True
            if b is None:
                rec.escalated, rec.replayed = True, len(stages)
            else:
                yr, sr = replays[b](ck[names[b]])
                sr = pipe.stats_to_host(sr)
                clean = not ser._flag_matrix(
                    {t: sr[t][None] for t in sr}, st0, list(sr), 0.0,
                    0.0)[0].any() and torch.equal(yr, y0)
                rec.escalated = not clean
                rec.replayed = (len(stages) - (b + 1) if clean
                                else len(stages))
        records.append(rec)
    return records


def campaign_pair(torch, gate, x, tag, trials, card, launched):
    """One SER campaign on the kernel path (its chunks on the kernels'
    trial forms; the launches they make are added to ``launched``), the
    same on the plain path and the per-trial yardstick
    (:func:`campaign_yardstick`): every trial record equal to both.
    Print counts, Wilson intervals, trials/s of all three (the kernel
    path's from a second, timed run: the first also pays the caching
    allocator's first requests, printed as ``cold_seconds``), the device
    ms of a one-chunk campaign, the peak memory, and the derived audit
    set (or the silent trials)."""
    from repro_torch.core import ser
    from repro_torch.kernels import ops

    kw = dict(trials=trials, kinds=ser.CAMPAIGN_KINDS, seed=SEED,
              checkpoints=2, chunk=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    t0 = time.perf_counter()
    camp = ser.run_campaign(gate, x, **kw)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for k, n in ops.launch_counts().items():
        launched[k] = launched.get(k, 0) + n - before[k]
    t0 = time.perf_counter()
    again = ser.run_campaign(gate, x, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check("resilience", f"{tag}_campaign_repeats_its_records",
          [record_key(r) for r in again.records]
          == [record_key(r) for r in camp.records], trials=trials)
    with plain_ops():
        t0 = time.perf_counter()
        plain = ser.run_campaign(gate, x, **kw)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    yard = campaign_yardstick(torch, gate, x, trials=trials,
                              kinds=kw["kinds"], seed=SEED, checkpoints=2)
    torch.cuda.synchronize()
    yard_wall = time.perf_counter() - t0
    for other, name in ((plain.records, "plain_path"), (yard, "yardstick")):
        same = [record_key(a) == record_key(b)
                for a, b in zip(camp.records, other)]
        check("resilience", f"{tag}_campaign_records_equal_{name}",
              all(same) and len(same) == trials == len(other),
              trials=trials, differing=[i for i, v in enumerate(same)
                                        if not v],
              kinds=list(kw["kinds"]))
    one = dict(kw, trials=kw["chunk"])
    t0 = time.perf_counter()
    ser.run_campaign(gate, x, **one)
    torch.cuda.synchronize()
    one_wall = (time.perf_counter() - t0) * 1e3
    chunk_dev = device_time(torch, lambda: ser.run_campaign(gate, x, **one),
                            one_wall)
    s = camp.summary()
    emit(phase="resilience", model=tag, what="ser_campaign",
         trials=trials, chunk=kw["chunk"], counts=s["counts"],
         rates=s["rates"], mean_replayed_stages=s["mean_replayed_stages"],
         n_stages=s["n_stages"], boundaries=s["checkpoints"]["stages"],
         seconds=wall, trials_per_s=trials / wall, cold_seconds=cold,
         plain_seconds=plain_wall, plain_trials_per_s=trials / plain_wall,
         yardstick_seconds=yard_wall,
         yardstick_trials_per_s=trials / yard_wall,
         max_memory_allocated_gb=peak / 1e9,
         one_chunk_campaign_wall_ms=one_wall,
         one_chunk_campaign_device=chunk_dev, card=card)
    silent = [dict(plan=[dataclasses.asdict(f) for f in r.plan.faults],
                   flagged=r.flagged) for r in camp.records
              if r.outcome == "silent"]
    if silent:
        emit(phase="resilience", model=tag, what="silent_trials",
             trials=silent)
    else:
        pol = ser.derive_guard_policy([camp], gate.parsed)
        emit(phase="resilience", model=tag, what="derived_audit_set",
             audit_stages=list(pol.audit_stages),
             n_audited=len(pol.audit_stages),
             n_stages=len(gate.parsed.layers))
    return camp


#: The single-trial wrapper, the trial form and its plain version of each
#: kernel a campaign's chunk runs, by the recorded name of the single call.
def trial_forms():
    from repro_torch.kernels import qconv, qgemm, ref
    return {"qconv2d": (qconv.qconv2d, qconv.qconv2d_trials,
                        ref.qconv2d_trials_ref),
            "qconv2d_into": (qconv.qconv2d, qconv.qconv2d_trials,
                             ref.qconv2d_trials_ref),
            "qdwconv2d": (qconv.qdwconv2d, qconv.qdwconv2d_trials,
                          ref.qdwconv2d_trials_ref),
            "qdwconv2d_into": (qconv.qdwconv2d, qconv.qdwconv2d_trials,
                               ref.qdwconv2d_trials_ref),
            "qgconv2d": (qconv.qgconv2d, qconv.qgconv2d_trials,
                         ref.qconv2d_trials_ref),
            "qgemm": (qgemm.qgemm, qgemm.qgemm_trials, ref.qgemm_trials_ref)}


def trial_kernel_checks(torch, dev, run, x, kinds, tag, out,
                        trials: int = 32) -> None:
    """Each ``kinds`` call of one batch-1 forward of ``run`` at its shapes,
    as a campaign's chunk makes it: ``trials`` trials' inputs (random
    int8) against ``trials`` random weight images, through the kernel's
    trial form (one launch), its trial-batched plain version and the loop
    of the single-trial kernel over the trials (each with its own
    staged copy); all three ``torch.equal``.  Times the trial form and
    the loop (L2 flushed before each) and the plain version, and adds
    each call's times, bytes and int8 operations to ``out[<name>_trials]``
    (the into forms as ``<name>_into_trials``)."""
    from repro_torch.kernels import qconv, qgemm
    calls: list = []
    with recorded_calls(calls):
        run(x)
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    flush = torch.empty(96 << 20, dtype=torch.int8, device=dev).zero_
    forms = trial_forms()
    for name, a, kw in calls:
        if name not in kinds:
            continue
        single, trial_fn, plain = forms[name]
        x1, w1, b = a[0], a[1], a[2]
        n = x1.shape[0]
        xs = rand_i8(torch, (trials * n,) + tuple(x1.shape[1:]), gen, dev)
        ws = rand_i8(torch, (trials,) + tuple(w1.shape), gen, dev)
        kw = {k: v for k, v in kw.items() if k != "w_k"}
        dw = name.startswith("qdwconv2d")
        wk = (None if dw else qgemm.stage_kmajor(ws) if name == "qgemm"
              else qconv.stage_kmajor(ws, kw.get("groups", 1)))
        if kw.get("skip") is not None:
            sk = kw["skip"]
            kw["skip"] = rand_i8(torch, (trials * sk.shape[0],)
                                 + tuple(sk.shape[1:]), gen, dev)
        buf = kw.pop("out_buf", None)

        def bufs():
            if buf is None:
                return {}
            return dict(out_buf=torch.full((trials * n,) + tuple(
                buf.shape[1:]), 77, dtype=torch.int8, device=dev))

        def rows(t, extra):
            sl = slice(t * n, (t + 1) * n)
            part = {k: v[sl] for k, v in extra.items()}
            if kw.get("skip") is not None:
                part["skip"] = kw["skip"][sl]
            return sl, part

        wkw = {} if dw else {"w_k": wk}
        ob = bufs()
        y = trial_fn(xs, ws, b, **wkw, **ob, **kw)
        yp = plain(xs, ws, b, **bufs(), **kw)
        lb = bufs()

        def loop(lb=lb):
            outs = []
            for t in range(trials):
                sl, part = rows(t, lb)
                wkt = {} if dw else {"w_k": wk[t]}
                outs.append(single(xs[sl], ws[t], b, **wkt,
                                   **dict(kw, **part)))
            return lb["out_buf"] if lb else torch.cat(outs)
        yl = loop()
        torch.cuda.synchronize()
        err = max((y.int() - yp.int()).abs().max().item(),
                  (y.int() - yl.int()).abs().max().item())
        key = name + "_trials"
        r = out.setdefault(key, dict(ms=0.0, plain_ms=0.0, loop_ms=0.0,
                                     bytes=0, ops=0, calls=0, err=0,
                                     path=tag, trials=trials))
        check("resilience", f"{tag}_{key}_call{r['calls']}_equals_plain_"
              "and_the_single_kernel_loop", err == 0, max_abs_err=err,
              shapes=[list(xs.shape), list(ws.shape)])
        ms = time_ms(torch, lambda: trial_fn(xs, ws, b, **wkw, **ob, **kw),
                     flush=flush)
        loop_ms = time_ms(torch, loop, flush=flush)
        plain_ms = time_ms(torch, lambda: plain(xs, ws, b, **bufs(), **kw),
                           reps=3)
        if name == "qgemm":
            m, k = n, x1.shape[1]
            cout = w1.shape[1]
            nbytes = trials * (m * k + k * cout + m * cout) + 4 * cout
            nops = 2 * trials * m * k * cout
        else:
            hp, wp = padded_hw(x1, kw)
            kh, kw_, cin_g, cout = w1.shape
            sh, sw = kw["strides"]
            ho, wo = (hp - kh) // sh + 1, (wp - kw_) // sw + 1
            pool = kw.get("pool")
            oh, ow = ((ho - pool[0]) // pool[1] + 1,
                      (wo - pool[0]) // pool[1] + 1) if pool else (ho, wo)
            nbytes = (xs.numel() + ws.numel() + 4 * cout
                      + trials * n * oh * ow * cout)
            if kw.get("skip") is not None:
                nbytes += kw["skip"].numel()
            nops = 2 * trials * n * ho * wo * cout * kh * kw_ * cin_g
        emit(phase="trial_timing", kernel=key, path=tag, call=r["calls"],
             trials=trials, shapes=[list(xs.shape), list(ws.shape)],
             ms=ms, loop_ms=loop_ms, plain_ms=plain_ms,
             bound_ms=max(nbytes / card().hbm_bandwidth,
                          nops / card().peak_int8_ops) * 1e3)
        r["ms"] += ms
        r["loop_ms"] += loop_ms
        r["plain_ms"] += plain_ms
        r["bytes"] += nbytes
        r["ops"] += nops
        r["calls"] += 1
        r["err"] = max(r["err"], err)


def trial_records(out, launched, card_name) -> dict:
    """The ``kernels`` line's records of the trial forms: launches from
    the campaigns (``launched``), times and bounds from
    :func:`trial_kernel_checks` (``out``)."""
    recs = {}
    for key, r in out.items():
        t_bytes = r["bytes"] / card().hbm_bandwidth * 1e3
        t_ops = r["ops"] / card().peak_int8_ops * 1e3
        recs[key] = dict(
            launches=launched.get(key, 0), max_abs_err=r["err"],
            ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None,
            extra=dict(loop_ms=r["loop_ms"], trials=r["trials"],
                       calls_timed=r["calls"], path=r["path"],
                       card=card_name))
        emit(phase="resilience", what="trial_form", kernel=key,
             **{k: v for k, v in recs[key].items() if k != "extra"},
             **recs[key]["extra"])
    return recs


def phase_resilience(torch, dev, records):
    """The resilience layer and the stage-timed profile on the int8 CNN
    path: guarded VGG-16 at full width (clean, a weight flip replayed
    from a checkpoint, conv1's flip through the unfused fallback, fc6's
    flip through the GEMM's restaged weight, an activation flip),
    ResNet-18 per-channel (a shift-lane fault to the per-tensor rung),
    googlenet_tiny (faults on a concat-fused producer's slice), each
    report and output equal to the same plan's on the plain path; SER
    campaigns on VGG-16, mobilenet_tiny@224, googlenet_tiny, dw_concat
    and alexnet_2tower, each chunk on the kernels' trial forms, every
    trial record equal to the plain path's and the per-trial
    yardstick's; the trial forms held against their plain versions and
    the single kernel's loop at the campaigns' shapes; the audit's cost
    beside the unguarded executor; the stage-timed VGG-16 and
    ``profile_model`` for VGG-16 and AlexNet.  The launch counts are set
    to 0 before the phase's kernel runs and read after them; the trial
    forms' launches are those the kernel-path campaigns made."""
    from repro_torch.core import faults as F
    from repro_torch.core import pipeline as pipe
    from repro_torch.core.guard import GuardPolicy
    from repro_torch.core.synthesis import CNN2Gate
    from repro_torch.kernels import ops
    from repro_torch.launch import profile
    from repro_torch.models import cnn

    card = card_line()
    strict = GuardPolicy(margin=0.0, sat_tol=0.0)
    t0 = time.perf_counter()
    gate = CNN2Gate.from_graph(cnn.vgg16(batch=1, seed=SEED))
    rng = np.random.default_rng(SEED + 5)
    shape = gate.parsed.input_shape   # (1, 3, 224, 224)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                        device=dev)
    gate.calibrate_quantization(x)
    qm = gate.quantized
    eager = gate.build()
    emit(phase="resilience", model="vgg16",
         setup_s=time.perf_counter() - t0)
    ops.reset_launch_counts()
    golden = eager(x)

    # guards off: the same ops calls as build()
    with ops.recording() as a:
        eager(x)
    with ops.recording() as b:
        off_y = gate.build_guarded(policy=None)(x)
    check("resilience", "vgg16_guards_off_makes_the_ops_calls_of_build",
          a == b and torch.equal(off_y, golden), calls=len(a))

    t0 = time.perf_counter()
    gx = gate.build_guarded(x_cal=x, policy=strict, checkpoints=2)
    emit(phase="resilience", model="vgg16", what="guard_build",
         seconds=time.perf_counter() - t0, boundaries=list(gx._boundaries))
    guarded_run(torch, gx, x, "vgg16_clean", golden, outcome="clean")

    names = [ql.info.name for ql in qm.layers]
    convs = [i for i, ql in enumerate(qm.layers) if ql.info.kind == "conv"]
    fcs = [ql.info.name for ql in qm.layers if ql.info.kind == "fc"]
    after = next(i for i in convs if i > gx._boundaries[0])
    gxf, plan = first_upset(gx, qm, F, [F.FaultPlan((F.Fault(
        F.WEIGHT_BIT, names[after], index=i, bit=7),)) for i in range(8)])
    rep = guarded_run(torch, gxf, x, "vgg16_weight_bit_after_a_boundary",
                      golden, outcome="checkpoint_replayed")
    check("resilience", "vgg16_checkpoint_replay_reruns_fewer_stages",
          bool(rep.actions) and 0 < (rep.actions[0].replayed or 0)
          < len(names), replayed=rep.actions[0].replayed if rep.actions
          else None, stages=len(names), fault=dataclasses.asdict(
              plan.faults[0]))
    t0 = time.perf_counter()
    gx1 = gx.with_program(F.inject(qm, F.FaultPlan((F.Fault(
        F.WEIGHT_BIT, names[convs[0]], index=0, bit=6),))))
    guarded_run(torch, gx1, x, "vgg16_conv1_weight_bit_falls_back_unfused",
                golden, outcome="fell_back", recovered_by="unfused",
                actions=["reexecute", "fallback:unfused"])
    emit(phase="resilience", model="vgg16", what="unfused_rung_first_use",
         seconds=time.perf_counter() - t0)
    k = qm.layers[names.index(fcs[0])].w_q.shape[0]
    gxf, plan = first_upset(gx, qm, F, [F.FaultPlan((F.Fault(
        F.WEIGHT_BIT, fcs[0], index=int(i), bit=7),))
        for i in rng.integers(0, k * 4096, 8)])
    guarded_run(torch, gxf, x, "vgg16_fc6_weight_bit_reaches_the_gemm",
                golden, outcome="checkpoint_replayed")
    li = qm.layers[convs[1]].info
    act = F.FaultPlan((F.Fault(F.ACTIVATION_BIT, li.name, bit=6,
                               index=int(np.prod(li.out_shape)) // 3,
                               tensor=li.output),))
    gxa = gx.with_program(qm, faults=act.activation_faults())
    rep = guarded_run(torch, gxa, x, "vgg16_activation_bit_detected", golden,
                      ok=True)
    check("resilience", "vgg16_activation_bit_flags_its_stage",
          names[convs[1]] in rep.flagged, flagged=rep.flagged)

    # ResNet-18 per-channel: the restaged shift_vec, to the per-tensor rung
    rg = CNN2Gate.from_graph(cnn.resnet18(batch=1, seed=SEED))
    xr = torch.as_tensor(rng.standard_normal(rg.parsed.input_shape)
                         .astype(np.float32), device=dev)
    rg.calibrate_quantization(xr, per_channel=True)
    conv2 = [ql.info.name for ql in rg.quantized.layers
             if ql.info.kind == "conv"][1]
    gxr = rg.build_guarded(
        x_cal=xr, policy=GuardPolicy(margin=0.0, sat_tol=0.0,
                                     fallback_unfused=False),
        qm=F.inject(rg.quantized, F.FaultPlan((F.Fault(
            F.SHIFT_LANE, conv2, lane=3, delta=2),))))
    guarded_run(torch, gxr, xr, "resnet18_per_channel_shift_lane_per_tensor",
                outcome="fell_back", recovered_by="per_tensor",
                actions=["reexecute", "fallback:per_tensor"])

    # googlenet_tiny: faults on a concat-fused producer's slice
    gg = CNN2Gate.from_graph(cnn.googlenet_tiny(batch=1, seed=SEED))
    xg = torch.as_tensor(rng.standard_normal(gg.parsed.input_shape)
                         .astype(np.float32), device=dev)
    gg.calibrate_quantization(xg)
    prod = next(ql.info for ql in gg.quantized.layers
                if ql.info.concat is not None)
    gxg = gg.build_guarded(x_cal=xg, policy=strict, checkpoints=2)
    g_golden = gg.build()(xg)
    guarded_run(torch, gxg, xg, "googlenet_tiny_clean", g_golden,
                outcome="clean")
    rep = guarded_run(torch, gxg.with_program(
        gg.quantized, faults=F.FaultPlan((F.Fault(
            F.ACTIVATION_BIT, prod.name, index=5, bit=6,
            tensor=prod.output),)).activation_faults()), xg,
        "googlenet_tiny_concat_producer_activation_bit", g_golden, ok=True)
    check("resilience", "googlenet_tiny_producer_slice_flagged",
          prod.name in rep.flagged, flagged=rep.flagged, producer=prod.name)
    gxf, plan = first_upset(gxg, gg.quantized, F, [F.FaultPlan((F.Fault(
        F.WEIGHT_BIT, prod.name, index=i, bit=7),)) for i in range(8)])
    guarded_run(torch, gxf, xg, "googlenet_tiny_concat_producer_weight_bit",
                g_golden, ok=True)

    # SER campaigns, every chunk one call of the executor's trial form:
    # VGG-16 and mobilenet_tiny@224, then the nets whose chunks take the
    # other trial forms (googlenet_tiny's concat producers, dw_concat's
    # depthwise producer, alexnet_2tower's grouped convs)
    launched: dict = {}
    campaign_pair(torch, gate, x, "vgg16", 64, card, launched)
    gm = CNN2Gate.from_graph(cnn.mobilenet_tiny(batch=1, in_hw=224,
                                                seed=SEED))
    xm = torch.as_tensor(rng.standard_normal(gm.parsed.input_shape)
                         .astype(np.float32), device=dev)
    gm.calibrate_quantization(xm)
    campaign_pair(torch, gm, xm, "mobilenet_tiny_224", 32, card, launched)
    campaign_pair(torch, gg, xg, "googlenet_tiny", 32, card, launched)
    more = {}
    for name, graph in (("dw_concat", dw_concat_graph(cnn)),
                        ("alexnet_2tower", alexnet_2tower_graph(cnn))):
        gn = CNN2Gate.from_graph(graph)
        xn = torch.as_tensor(rng.standard_normal(gn.parsed.input_shape)
                             .astype(np.float32), device=dev)
        gn.calibrate_quantization(xn)
        campaign_pair(torch, gn, xn, name, 32, card, launched)
        more[name] = (gn, xn)
    counts = ops.launch_counts()
    trial_keys = [k for k in SOURCES if k.endswith("_trials")]
    check("resilience", "every_kernel_of_the_path_launched",
          all(counts[k] > 0 for k in ("qconv2d", "qconv2d_into", "qgemm",
                                      "qdwconv2d"))
          and all(launched.get(k, 0) > 0 for k in trial_keys),
          counts=counts,
          campaign_trial_launches={k: launched.get(k, 0)
                                   for k in trial_keys})

    # the trial forms at the campaigns' shapes, T = 32, N = 1
    out: dict = {}
    trial_kernel_checks(torch, dev, eager, x, ("qconv2d", "qgemm"), "vgg16",
                        out)
    trial_kernel_checks(torch, dev, gm.build(), xm, ("qdwconv2d",),
                        "mobilenet_tiny_224", out)
    trial_kernel_checks(torch, dev, gg.build(), xg, ("qconv2d_into",),
                        "googlenet_tiny", out)
    for name, kinds in (("dw_concat", ("qdwconv2d_into",)),
                        ("alexnet_2tower", ("qgconv2d",))):
        gn, xn = more[name]
        trial_kernel_checks(torch, dev, gn.build(), xn, kinds, name, out)
    records.update(trial_records(out, launched, card))

    # the audit's cost: guarded clean runs beside the unguarded executor,
    # on 8 requests near the calibration input (each one clean under the
    # default margins, so the guarded wall is the audit's, not a rung's)
    reqs = [x + 0.01 * torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32), device=dev) for _ in range(8)]
    gxt = gate.build_guarded(x_cal=x, policy=GuardPolicy(), checkpoints=2)
    outcomes = [gxt(r)[1].outcome for r in reqs]
    w = walls(torch, {"eager": eager, "guarded": lambda v: gxt(v)[0]}, reqs)
    e, g = statistics.median(w["eager"]), statistics.median(w["guarded"])
    emit(phase="resilience", model="vgg16", what="audit_overhead",
         policy="GuardPolicy() (margin 0.25, sat_tol 0.02), 2 checkpoints",
         outcomes=outcomes, all_clean=set(outcomes) == {"clean"},
         eager_median_ms=e, guarded_median_ms=g, guarded_over_eager=g / e,
         eager_ms=w["eager"], guarded_ms=w["guarded"], card=card)

    # the stage-timed executor and the attribution profile
    timed = pipe.make_executor(qm, stage_timed=True)
    yt, timings = timed(x)
    stages = [t["stage"] for t in timings]
    check("resilience", "vgg16_stage_timed_equals_the_executor",
          torch.equal(yt, golden), stages=len(stages))
    check("resilience", "vgg16_stage_timed_measures_every_stage",
          stages == ["ingress"] + names + ["egress"], stages=stages)
    for name in ("vgg16", "alexnet"):
        doc = profile.profile_model(name, device=dev)
        emit(phase="resilience", model=name, what="attribution_profile",
             summary=doc["summary"], overhead_us=doc["overhead_us"],
             rows=[{k: r[k] for k in ("stage", "kind", "wall_us",
                                      "model_us", "macs", "ddr_bytes")}
                   for r in doc["stages"]], card=card)


# ---------------------------------------------- phase 5: the dense-LM path

def bf16_ulp(torch, x):
    """The spacing of bf16 values at |x|."""
    return torch.exp2(torch.floor(torch.log2(
        x.float().abs().clamp_min(1e-30))) - 7)


def float_agreement(torch, y, yp) -> tuple:
    """(ok, max_abs_err, max_share) of a float kernel's output ``y``
    against its plain version's ``yp``; ``max_share`` is the largest
    error as a share of its element's allowance (F32_TOL, or one bf16
    ulp plus BF16_ATOL): at most 1 passes."""
    d = (y.float() - yp.float()).abs()
    if y.dtype == torch.bfloat16:
        allowance = bf16_ulp(torch, yp) + BF16_ATOL
    else:
        allowance = F32_TOL + F32_TOL * yp.float().abs()
    share = (d / allowance).max().item()
    return (share <= 1 and bool(torch.isfinite(y).all()), d.max().item(),
            share)


def visible_pairs(sq: int, skv: int, causal: bool, window, q_offset: int):
    """(query, key) pairs the masks leave visible, per (batch, head)."""
    qpos = q_offset + np.arange(sq)
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_bound_ms(q, k, causal: bool, window, q_offset: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one flash call: 4 B H D
    FLOP per visible pair at the bf16 tensor-core peak against q, k, v
    and o read or written once at the HBM rate."""
    b, h, sq, d = q.shape
    flops = 4 * b * h * d * visible_pairs(sq, k.shape[2], causal, window,
                                          q_offset)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops = flops / card().peak_bf16_flops * 1e3
    t_bytes = nbytes / card().hbm_bandwidth * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def flash_cases(rng):
    """Kernel-check cases: (name, B, H, HKV, Sq, Skv, D, dtype, causal,
    window, q_offset).  The slice's two shapes, rows that see no key,
    and a seeded sweep over dtypes, group sizes 1/2/4/6/8, ragged Skv,
    q_offset > 0, non-causal and windowed masks."""
    cases = [
        ("qwen2_1_5b_prefill", 2, 12, 2, 4096, 4096, 128, "bf16", True,
         None, 0),
        ("h2o_danube3_4b_prefill_w4096", 1, 32, 8, 6144, 6144, 120, "bf16",
         True, 4096, 0),
        ("blind_rows_probe_f32", 1, 1, 1, 8, 20, 16, "f32", True, 4, 30),
        ("blind_rows_probe_bf16", 1, 1, 1, 8, 20, 16, "bf16", True, 4, 30),
        ("blind_and_seeing_rows_one_block", 1, 4, 2, 128, 200, 64, "f32",
         True, 50, 200),
        ("blind_rows_noncausal_window", 2, 6, 1, 100, 70, 120, "bf16", False,
         9, 40),
    ]
    for i in range(40):
        group = (1, 2, 4, 6, 8)[i % 5]
        hkv = int(rng.integers(1, 3))
        skv = int(rng.integers(1, 700))
        skv += skv % 64 == 0                       # never a whole tile
        causal = bool(rng.random() < 0.7)
        window = int(rng.integers(1, 300)) if rng.random() < 0.5 else None
        cases.append((f"sweep{i}", int(rng.integers(1, 3)), group * hkv,
                      hkv, int(rng.integers(1, 300)), skv,
                      int(rng.choice([16, 64, 80, 120, 128,
                                      int(rng.integers(1, 129))])),
                      ("f32", "bf16")[i % 2], causal, window,
                      int(rng.integers(0, 500)) if rng.random() < 0.6
                      else 0))
    # the bf16 kernel's 128-row query and 128-key tiles at their edges,
    # its TMA boxes at narrower and zero-filled widths, its plain-load
    # producer (D not a multiple of 8) and a chunked-prefill shape
    cases += [
        ("bf16_sq4095_ragged_query_tile", 1, 4, 2, 4095, 4095, 128, "bf16",
         True, None, 0),
        ("bf16_sq1_one_row_query_tile", 2, 12, 2, 1, 4097, 128, "bf16", True,
         None, 4096),
        ("bf16_skv100_under_one_key_tile", 2, 4, 2, 100, 100, 128, "bf16",
         True, None, 0),
        ("bf16_d64_narrow_box", 1, 8, 2, 1000, 1000, 64, "bf16", True, None,
         0),
        ("bf16_d80_zero_filled_box", 1, 8, 1, 700, 900, 80, "bf16", True,
         None, 200),
        ("bf16_d120_zero_filled_box", 1, 8, 2, 1000, 1000, 120, "bf16", True,
         None, 0),
        ("bf16_d77_plain_load_producer", 1, 6, 2, 600, 700, 77, "bf16", True,
         None, 100),
        ("bf16_gqa6_chunked_prefill", 2, 12, 2, 1024, 4096, 128, "bf16", True,
         None, 3072),
    ]
    return cases


def flash_kernel_checks(torch, dev) -> None:
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bad, blind_rows = [], 0
    for (name, b, h, hkv, sq, skv, d, dt, causal, window,
         q_offset) in flash_cases(rng):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        y = fa.flash_attention(q, k, v, **kw)
        yp = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        ok, err, share = float_agreement(torch, y, yp)
        blind = (int(np.sum(q_offset + np.arange(sq) - window >= skv - 1))
                 if window else 0)
        blind_rows += blind
        if name.startswith("sweep"):
            if not ok:
                bad.append(dict(case=name, shape=[b, h, hkv, sq, skv, d],
                                dtype=dt, err=err, share=share, **kw))
            continue
        check("lm", f"flash_attention_{name}", ok, dtype=dt,
              shape=[b, h, hkv, sq, skv, d], max_abs_err=err,
              max_share_of_tolerance=share, blind_rows=blind, **kw)
    check("lm", "flash_attention_random_sweep_40", not bad, failures=bad[:5])
    check("lm", "flash_attention_cases_include_blind_rows", blind_rows > 0,
          blind_rows=blind_rows)
    flash_float64_distance(torch, dev, gen)


def attention_float64(torch, q, k, v):
    """Causal GQA attention of q (B, H, S, D) over k, v (B, HKV, S, D) in
    float64, one KV head's group of query heads at a time."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    future = torch.ones((s, s), dtype=torch.bool, device=q.device).triu(1)
    for i in range(b):
        for j in range(hkv):
            sc = (q[i, j * g:(j + 1) * g].double()
                  @ k[i, j].double().T) * d ** -0.5
            sc.masked_fill_(future, float("-inf"))
            out[i, j * g:(j + 1) * g] = torch.softmax(sc, -1) @ v[i, j].double()
    return out


def flash_float64_distance(torch, dev, gen) -> None:
    """The kernel's and the plain version's bf16 outputs against a float64
    run of the same bf16 inputs at qwen2-1.5b's prefill shape.  The
    kernel's largest absolute distance from float64 must be at most 1.5x
    the plain version's, and every kernel output must lie within its bf16
    allowance (one ulp plus BF16_ATOL) of the float64 value.  The first
    is set by the outputs' rounding (half an ulp of the largest, for
    both); the second guards the split P: a P multiplied as one bf16 is
    ~240x its allowance away where outputs cancel towards 0 (the CPU
    model in tests/test_torch_flash.py), hi + lo about 0.9x (the plain
    version, rounding a float32 value once, about 0.5x)."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn((2, 12, 4096, 128), generator=gen, device=dev).bfloat16()
    k = torch.randn((2, 2, 4096, 128), generator=gen, device=dev).bfloat16()
    v = torch.randn((2, 2, 4096, 128), generator=gen, device=dev).bfloat16()
    yk = fa.flash_attention(q, k, v)
    yp = fa.flash_attention_plain(q, k, v)
    y64 = attention_float64(torch, q, k, v)
    torch.cuda.synchronize()
    allowance = bf16_ulp(torch, y64) + BF16_ATOL
    d = {}
    for tag, y in (("kernel", yk), ("plain", yp)):
        dist = (y.double() - y64).abs()
        d[f"abs_{tag}"] = dist.max().item()
        d[f"share_of_allowance_{tag}"] = (dist / allowance).max().item()
    check("lm", "flash_attention_float64_distance",
          d["abs_kernel"] <= 1.5 * d["abs_plain"]
          and d["share_of_allowance_kernel"] <= 1,
          y_abs_max=y64.abs().max().item(), **d)


def build_record(torch, phase: str, lib: str, label,
                 ops=("HGMMA", "UTMALDG")) -> dict:
    """A built library's tensor-core and TMA instructions (``cuobjdump
    -sass``: HGMMA is the bf16 wgmma, IGMMA the int8 one, UTMALDG a TMA
    load) and each kernel's registers, static shared memory and spills
    from nvcc's ``-Xptxas -v`` log, keyed by ``label(mangled name)``
    (None: not recorded); checks that the library holds every one of
    ``ops``."""
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(_build._lib_path(lib))],
                         capture_output=True, text=True, timeout=300)
    sass = {op: len(re.findall(rf"\b{op}\b", out.stdout)) for op in ops}
    check(phase, f"{lib}_sass_holds_" + "_and_".join(o.lower() for o in ops),
          out.returncode == 0 and all(sass.values()), **sass,
          cuobjdump_rc=out.returncode)
    usage, fn = {}, None
    for ln in _build.build_log(lib).splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      ln)
        if m:
            fn = label(m.group(1))
            if fn:
                usage.setdefault(fn, {})
        for key, pattern in (("spill_store_bytes", r"(\d+) bytes spill st"),
                             ("registers", r"Used (\d+) registers"),
                             ("static_smem_bytes", r"(\d+) bytes smem")):
            m = re.search(pattern, ln)
            if m and fn:
                usage[fn][key] = int(m.group(1))
    return dict(sass=sass, ptxas=usage)


def qconv_label(mangled: str):
    """Every kernel of the qconv library, the wgmma instances by name (the
    narrow gather's instances marked; the grouped instances of the same
    body under their own name)."""
    inst = re.search(r"qconv_(grouped_)?wgmma_kernelILi(\d+)ELb([01])E",
                     mangled)
    if not inst:
        return mangled
    return (f"qconv_{inst.group(1) or ''}wgmma_kernel<{inst.group(2)}"
            f"{', narrow' if inst.group(3) == '1' else ''}>")


_QCONV_BUILD: dict = {}


def attach_qconv_build(torch, records, name: str) -> None:
    """Give ``records[name]`` the qconv library's design note, its IGMMA
    and UTMALDG counts and nvcc's registers, shared memory and spills
    (the check that both instructions are there runs once)."""
    if not _QCONV_BUILD:
        _QCONV_BUILD.update(build_record(torch, "vgg16", "qconv",
                                         qconv_label, ("IGMMA", "UTMALDG")))
        names = sorted(_QCONV_BUILD["ptxas"])
        check("vgg16", "qconv_library_holds_only_the_wgmma_kernel",
              names == sorted(f"{k}<{bn}{narrow}>" for k in QCONV_KERNELS
                              for bn in (64, 128)
                              for narrow in ("", ", narrow")),
              kernels=names)
    r = records.get(name)
    if r is not None:
        r["extra"] = dict(
            design="int8 wgmma (IGMMA), TMA-fed K-major weights, K split "
                   "over a cluster under one wave (DSMEM reduction)",
            plans=r.pop("plans", []), **_QCONV_BUILD)


def qgemm_label(mangled: str):
    """Every kernel of the qgemm library, the wgmma instances by name."""
    inst = re.search(r"qgemm_wgmma_kernelILi(\d+)ELi(\d+)E", mangled)
    return (f"qgemm_wgmma_kernel<{inst.group(1)}, {inst.group(2)}>" if inst
            else mangled)


def attach_qgemm_build(torch, records) -> None:
    """Check that the qgemm library's SASS holds IGMMA and UTMALDG and no
    kernel but the wgmma instances, and give ``records["qgemm"]`` its
    design note, plans, SASS counts and nvcc's registers, shared memory
    and spills."""
    build = build_record(torch, "vgg16", "qgemm", qgemm_label,
                         ("IGMMA", "UTMALDG"))
    names = sorted(build["ptxas"])
    check("vgg16", "qgemm_library_holds_only_the_wgmma_kernel",
          names == sorted(f"qgemm_wgmma_kernel<{bn}, {nw}>"
                          for bn in (64, 128) for nw in (8, 16, 32)),
          kernels=names)
    r = records["qgemm"]
    r["extra"] = dict(
        design="swap-AB int8 wgmma (IGMMA) on a TMA ring fed by a producer "
               "warp, K split over a cluster, DSMEM reduction and requant "
               "in the same launch",
        plans=r.pop("plans", []), **r.get("extra", {}), **build)


def flash_label(mangled: str):
    if "flash_bf16_kernel" in mangled:
        return "flash_bf16_kernel"
    inst = re.search(r"flash_f32_kernelILi(\d+)E", mangled)
    return f"flash_f32_kernel<{inst.group(1)}>" if inst else None


def ssd_label(mangled: str):
    for name in ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan"):
        if name in mangled:
            return name
    inst = re.search(r"ssd_kernelI(13__nv_bfloat16|f)Li(\d+)E", mangled)
    if inst:
        kind = "float" if inst.group(1) == "f" else "bf16"
        return f"ssd_kernel<{kind}, {inst.group(2)}>"
    return None


@contextlib.contextmanager
def checked_kernel(torch, calls: list, kernel: str):
    """Run every call of ``kernel`` in the block through the kernel, hold
    it against the plain version on the same inputs, and keep (inputs,
    keywords, agreement) in ``calls``."""
    agree = {"flash_attention": float_agreement,
             "ssd_scan": checked_ssd_call}[kernel]

    def make(name, fn, plain):
        if name != kernel:
            return fn

        def run(*a, **kw):
            out = fn(*a, **kw)
            calls.append((a, kw, agree(torch, out, plain(*a, **kw))))
            return out
        return run
    with patched_wrappers(make):
        yield


def timed(torch, fn) -> tuple:
    """(result, host ms) of one synchronized call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rel_l2(a, b) -> float:
    """Relative L2 distance of ``a`` from ``b``."""
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def logits_agreement(torch, got, plain, ref32) -> dict:
    """The kernel path's bf16 logits against the plain path's, with the
    same weights run in float32 on the plain attention (``ref32``) as the
    yardstick.  Both bf16 paths compute attention in float32 and differ
    in the last bf16 bit of a few elements per layer, which the later
    bf16 products carry on; bf16 rounding itself moves the plain path
    from float32.  The kernel path must stay as close to the float32
    model as the plain path, within a factor of 1.5, and pick the same
    greedy token unless the plain path's top two logits lie closer than
    the largest difference."""
    d_kernel, d_plain = rel_l2(got, ref32), rel_l2(plain, ref32)
    err = (got.float() - plain.float()).abs().max().item()
    top2 = plain[:, -1].float().topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).tolist()
    same = (got[:, -1].argmax(-1) == plain[:, -1].argmax(-1)).tolist()
    ok = d_kernel <= 1.5 * d_plain and all(s or gp <= 2 * err
                                           for s, gp in zip(same, gap))
    return dict(ok=ok and bool(torch.isfinite(got).all()),
                rel_l2_kernel_vs_float32=d_kernel,
                rel_l2_plain_vs_float32=d_plain,
                rel_l2_kernel_vs_plain=rel_l2(got, plain), max_abs_err=err,
                argmax_equal=same, plain_top2_gap=gap)


def float32_logits(torch, model, params, batch, cache_len, routes=None):
    """Prefill logits of the same weights in float32 (TF32 off) on the
    plain attention; a MoE model replays ``routes`` (see
    :func:`replayed_routing`).  The weights go to float32 in place and
    back to their own dtypes after (bf16 -> float32 -> bf16 is exact), so
    a 10 B-parameter model needs no second copy on the card."""
    from repro_torch.models.model import Model
    m32 = Model(dataclasses.replace(model.cfg, dtype="float32"),
                device=model.device)
    dtypes = {n: p.dtype for n, p in params.named_parameters()}
    torch.cuda.empty_cache()
    params.float()
    try:
        with plain_ops(), replayed_routing(routes):
            logits, _ = m32.prefill(params, batch, cache_len)
    finally:
        for n, p in params.named_parameters():
            p.data = p.data.to(dtypes[n])
        torch.cuda.empty_cache()
    return logits


def prefill_path(torch, dev, cfg, batch, cache_len, runs: int,
                 kernel: str = "flash_attention", phase: str = "lm",
                 prepare=None, per_prefill=None):
    """Prefill through ``Model.prefill``: one run with every call of
    ``kernel`` held against the plain version, ``runs`` timed runs that
    must each launch the kernel ``per_prefill`` times (default once per
    layer), and one run on the plain version.  ``prepare(params)`` edits
    the random weights first.  A MoE model's plain and float32 runs
    replay the kernel path's routing decisions (:func:`replayed_routing`)
    for the logits criterion; its own plain routing is compared with the
    kernel path's first (:func:`moe_routing_report`).  Returns (model,
    params, logits, cache, kernel calls, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    tag = cfg.name
    per_prefill = per_prefill or cfg.n_layers
    model = Model(cfg, device=dev)
    params, init_ms = timed(torch, lambda: model.init(
        torch.Generator(device=dev).manual_seed(SEED)))
    if prepare is not None:
        prepare(params)
    emit(phase=phase, model=tag, layers=cfg.n_layers, d_model=cfg.d_model,
         params=sum(p.numel() for p in params.parameters()),
         dtype=cfg.dtype, init_ms=init_ms)
    calls: list = []
    with checked_kernel(torch, calls, kernel):
        model.prefill(params, batch, cache_len)
    torch.cuda.synchronize()
    agree = [c[2] for c in calls]
    check(phase, f"{tag}_every_prefill_call_agrees_with_plain",
          len(calls) == per_prefill and all(a[0] for a in agree),
          calls=len(calls), max_abs_err=max(a[1] for a in agree),
          max_share_of_tolerance=max(a[2] for a in agree))
    times, launches, routes = [], 0, []
    for i in range(runs):
        ops.reset_launch_counts()
        routes.clear()          # the last run's routing, one a MoE layer
        with recorded_routing(routes):
            (logits, cache), ms = timed(
                torch, lambda: model.prefill(params, batch, cache_len))
        launches = ops.launch_counts()[kernel]
        check(phase, f"{tag}_prefill{i}_launches_{per_prefill}",
              launches == per_prefill, launches=launches)
        times.append(ms)
    replay = None
    if cfg.family == "moe":
        moe_routing_report(torch, cfg, phase, routes, lambda: model.prefill(
            params, batch, cache_len))
        replay = routes
    with plain_ops(), replayed_routing(replay):
        (plain_logits, _), plain_ms = timed(
            torch, lambda: model.prefill(params, batch, cache_len))
    agreement = logits_agreement(torch, logits, plain_logits, float32_logits(
        torch, model, params, batch, cache_len, replay))
    check(phase, f"{tag}_prefill_logits_match_plain_path",
          agreement.pop("ok"), shape=list(logits.shape),
          routing=None if replay is None else "kernel path's, replayed",
          **agreement)
    del routes, replay
    inputs = batch["tokens"] if "tokens" in batch else batch["embeds"][..., 0]
    tokens = inputs.numel()
    emit(phase=phase, model=tag, prefill_tokens=tokens, cache_len=cache_len,
         prefill_ms_median=statistics.median(times), prefill_ms_all=times,
         prefill_tokens_per_s=tokens / statistics.median(times) * 1e3,
         plain_path_prefill_ms=plain_ms)
    emit(phase=phase, model=tag, what="prefill", **device_time(
        torch, lambda: model.prefill(params, batch, cache_len),
        statistics.median(times)))
    return model, params, logits, cache, calls, launches


def decode_path(torch, model, params, logits, cache, start: int,
                steps: int, per_step=None, phase: str = "lm",
                feed=None, checked=False):
    """Greedy ``decode_step``s from a prefilled cache, finite logits,
    launching each kernel ``per_step[kernel]`` times a step (default: no
    flash launch); records the host ms of each synchronized step.
    ``feed(i, tok)`` gives step i's input (default: the greedy tokens).
    With ``checked``, the same steps first run on a copy of the cache
    with every flash call held against the plain version.  Returns
    (those calls, the launch counts of the timed steps)."""
    from repro_torch.kernels import ops
    per_step = per_step or {"flash_attention": 0}
    feed = feed or (lambda i, tok: {"tokens": tok})
    tag = model.cfg.name
    first = logits[:, -1].argmax(-1, keepdim=True)
    calls: list = []
    if checked:
        shadow, tok = {k: v.clone() for k, v in cache.items()}, first
        with checked_kernel(torch, calls, "flash_attention"):
            for i in range(steps):
                out, _ = model.decode_step(
                    params, {**feed(i, tok), "lengths": start + i}, shadow)
                tok = out[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        del shadow
        agree = [c[2] for c in calls]
        check(phase, f"{tag}_every_decode_call_agrees_with_plain",
              len(calls) == per_step["flash_attention"] * steps
              and all(a[0] for a in agree), calls=len(calls),
              max_abs_err=max((a[1] for a in agree), default=0.0),
              max_share_of_tolerance=max((a[2] for a in agree),
                                         default=0.0))
    tok = first
    times, finite = [], True
    ops.reset_launch_counts()
    for i in range(steps):
        (logits, cache), ms = timed(torch, lambda: model.decode_step(
            params, {**feed(i, tok), "lengths": start + i}, cache))
        finite &= bool(torch.isfinite(logits).all())
        tok = logits[:, -1].argmax(-1, keepdim=True)
        times.append(ms)
    counts = ops.launch_counts()
    check(phase, f"{tag}_{steps}_decode_steps", finite and tuple(
        logits.shape) == (tok.shape[0], 1, model.cfg.vocab_size)
        and all(counts[k] == n * steps for k, n in per_step.items()),
        launches=counts, expected_per_step=per_step)
    emit(phase=phase, model=tag, decode_batch=tok.shape[0],
         decode_cache_fill=start, decode_ms_median=statistics.median(times),
         decode_ms_all=times)
    emit(phase=phase, model=tag, what="decode_step", **device_time(
        torch, lambda: model.decode_step(
            params, {**feed(steps, tok), "lengths": start + steps}, cache),
        statistics.median(times)))
    return calls, counts


def serve_path(torch, model, params, per_call=None, phase: str = "lm") -> None:
    """``Server`` with 4 slots and a 64-token cache answers 8 requests of
    a 16-token prompt and 16 new tokens each; each of its decode calls
    launches each kernel ``per_call[kernel]`` times (default: no flash
    launch)."""
    from repro_torch.core import telemetry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    per_call = per_call or {"flash_attention": 0}
    tracer = telemetry.Tracer()
    server = serve.Server(model, params, 4, 64,
                          registry=telemetry.MetricsRegistry(), tracer=tracer)
    decodes = [0]
    decode = server._decode

    def counted(tokens):
        decodes[0] += 1
        return decode(tokens)
    server._decode = counted
    rng = np.random.default_rng(SEED + 3)
    reqs = [serve.Request(i, rng.integers(0, model.cfg.vocab_size, 16), 16)
            for i in range(8)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        server.submit(r)
    steps = 0
    while server.busy and steps < 200:
        server.step()
        steps += 1
    wall = time.perf_counter() - t0
    stats = server.stats()
    lat = sorted(e["dur"] / 1e6 for e in tracer.events()
                 if e["name"].startswith("serve.request:"))
    counts = ops.launch_counts()
    check(phase, f"{model.cfg.name}_server_answers_8_requests",
          all(r.done and len(r.output) == 16 for r in reqs)
          and all(counts[k] == n * decodes[0] for k, n in per_call.items()),
          tokens=stats["tokens"], engine_steps=steps,
          decode_calls=decodes[0], launches=counts)
    emit(phase=phase, model=model.cfg.name, server_slots=4, server_cache=64,
         requests=8, wall_s=wall, tokens_per_s=stats["tokens_per_s"],
         p50_latency_s_histogram=stats["latency_s"]["p50"],
         p50_latency_s=statistics.median(lat) if lat else None,
         latencies_s=lat)


def flash_record(torch, dev, calls, launches) -> dict:
    """Time each recorded kernel call of one prefill, its plain version
    and PyTorch's ``scaled_dot_product_attention`` on the same inputs
    (L2 flushed between calls); sum them and the bounds."""
    flush = torch.empty(96 << 20, dtype=torch.int8, device=dev).zero_
    fa = wrappers()["flash_attention"]
    r = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, by=set(),
             err=0.0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_note = "enable_gqa"
    for (q, k, v), kw, (_ok, err, _share) in calls:
        ms = time_ms(torch, lambda: fa[1](q, k, v, **kw), reps=3,
                     flush=flush)
        plain_ms = time_ms(torch, lambda: fa[2](q, k, v, **kw), reps=2,
                           flush=flush)
        # the same function in one call: causal or not, or a band mask
        # built outside the timed call for a window
        lib_kw = dict(is_causal=kw["causal"])
        if kw["window"] is not None:
            qpos = kw["q_offset"] + torch.arange(q.shape[2], device=dev)
            kpos = torch.arange(k.shape[2], device=dev)
            lib_kw = dict(attn_mask=(kpos[None] <= qpos[:, None])
                          & (kpos[None] > qpos[:, None] - kw["window"]))
            library_note = "enable_gqa, band mask"
        try:
            lib_ms = time_ms(torch, lambda: sdpa(q, k, v, enable_gqa=True,
                                                 **lib_kw),
                             reps=3, flush=flush)
        except TypeError:      # a PyTorch without enable_gqa
            g = q.shape[1] // k.shape[1]
            kr, vr = (t.repeat_interleave(g, 1) for t in (k, v))
            lib_ms = time_ms(torch, lambda: sdpa(q, kr, vr, **lib_kw),
                             reps=3, flush=flush)
            library_note = "K/V repeated"
        bound, by = flash_bound_ms(q, k, kw["causal"], kw["window"],
                                   kw["q_offset"])
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["library_ms"] += lib_ms
        r["bound_ms"] += bound
        r["by"].add(by)
        r["err"] = max(r["err"], err)
    n = len(calls)
    emit(phase="timing", kernel="flash_attention", calls=n,
         shapes=[list(t.shape) for t in calls[0][0]],
         ms_per_launch=r["ms"] / n, plain_ms_per_launch=r["plain_ms"] / n,
         library_ms_per_launch=r["library_ms"] / n,
         bound_ms_per_launch=r["bound_ms"] / n, library=library_note)
    return dict(launches=launches, calls_timed=n, max_abs_err=r["err"],
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by="operations" if "operations" in r["by"] else "bytes",
                library_ms=r["library_ms"])


def phase_lm(torch, dev, records):
    """The dense-LM serving path, bf16, random weights from the seed:
    qwen2-1.5b at full width (prefill 2 x 4096, 16 decode steps, Server),
    then h2o-danube-3-4b at full width and 2 of its 24 layers (prefill
    1 x 6144 under its 4096 window, 8 decode steps)."""
    from repro_torch import configs
    from repro_torch import device as tdevice

    rng = np.random.default_rng(SEED)
    with tdevice.full_float32():
        build = build_record(torch, "lm", "flash_attention", flash_label)
        flash_kernel_checks(torch, dev)
        cfg = dataclasses.replace(configs.get("qwen2-1.5b"),
                                  attention_impl="flash")
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (2, 4096)), device=dev)}
        model, params, logits, cache, calls, launches = prefill_path(
            torch, dev, cfg, batch, 4608, runs=3)
        decode_path(torch, model, params, logits, cache, 4096, 16)
        del cache
        serve_path(torch, model, params)
        records["flash_attention"] = flash_record(torch, dev, calls,
                                                  launches)
        records["flash_attention"]["extra"] = dict(
            design="bf16 wgmma + TMA; float32 CUDA cores", **build)
        del model, params, calls
        torch.cuda.empty_cache()

        cfg = dataclasses.replace(configs.get("h2o-danube-3-4b"), n_layers=2,
                                  attention_impl="flash")
        emit(phase="lm", model=cfg.name, reduced="n_layers 24 -> 2")
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, 6144)), device=dev)}
        model, params, logits, cache, calls, _ = prefill_path(
            torch, dev, cfg, batch, 6160, runs=2)
        seq = batch["tokens"].shape[1]
        check("lm", f"{cfg.name}_prefill_masks_its_window",
              seq > cfg.sliding_window
              and all(c[1]["window"] == cfg.sliding_window for c in calls)
              and cache["k"].shape[3] == 6160, window=cfg.sliding_window,
              visible_pairs=visible_pairs(seq, seq, True,
                                          cfg.sliding_window, 0),
              causal_pairs=visible_pairs(seq, seq, True, None, 0))
        decode_path(torch, model, params, logits, cache, 6144, 8)
        h2o = flash_record(torch, dev, calls, len(calls))
        emit(phase="lm", model=cfg.name, flash_ms_per_launch=h2o["ms"] / 2,
             plain_ms_per_launch=h2o["plain_ms"] / 2,
             library_ms_per_launch=h2o["library_ms"] / 2,
             bound_ms_per_launch=h2o["bound_ms"] / 2)


# ------------------------------------------ phase 6: the SSM serving paths

#: The SSD kernel's float32 tolerance against its plain version (y and
#: the state): the JAX package's own for the chunked decomposition
#: against the sequential oracle (atol 1e-4, rtol 1e-3,
#: tests/test_kernels.py).  The kernel walks 64-position tiles whatever
#: the chunk, the plain version the caller's chunk: the two group their
#: float32 sums differently, as two chunk lengths do.  Both lose float32
#: digits to the decay exponents, differences of cumulative sums that
#: reach hundreds within a chunk: against a float64 run at mamba2-2.7b's
#: prefill shape (dt up to 1, a down to -16) both are off by about 1e-4
#: absolute (:func:`ssd_float64_distance`).  So a bf16 y, the rounding of
#: such a float32 value, takes one bf16 ulp plus this float32 allowance,
#: not BF16_ATOL.
SSD_F32_TOL = (1e-4, 1e-3)


def ssd_agreement(torch, y, yp) -> tuple:
    """(ok, max_abs_err, max_share) of an SSD output against its plain
    version's: within ``atol + rtol |yp|`` of SSD_F32_TOL, plus one bf16
    ulp for a bf16 output; at most 1 passes."""
    d = (y.float() - yp.float()).abs()
    allowance = SSD_F32_TOL[0] + SSD_F32_TOL[1] * yp.float().abs()
    if y.dtype == torch.bfloat16:
        allowance = allowance + bf16_ulp(torch, yp)
    share = (d / allowance).max().item()
    return (share <= 1 and bool(torch.isfinite(y).all()), d.max().item(),
            share)


def checked_ssd_call(torch, out, ref) -> tuple:
    """(ok, max_abs_err, max_share) of one SSD call, y or (y, final
    state), against its plain version's."""
    if not isinstance(out, tuple):
        return ssd_agreement(torch, out, ref)
    parts = [ssd_agreement(torch, o, r) for o, r in zip(out, ref)]
    return (all(p[0] for p in parts), max(p[1] for p in parts),
            max(p[2] for p in parts))


def ssd_bound_ms(x, b, chunk: int, with_d: bool, init: bool,
                 final: bool) -> tuple:
    """(bound ms, "bytes" or "operations") of one SSD call.  Bytes: x and
    y, dt, a (and d), b and c, and the float32 state read and written,
    once each.  Operations: the chunked algorithm at the call's chunk
    with the least work it needs: C B^T once per B/C group over the
    causal pairs of each chunk (2 N FLOP a pair), and per head the masked
    product with x over the same pairs (2 P), C S_prev^T and the state
    update (2 N P a position each), at the bf16 tensor-core peak."""
    bsz, length, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, length)
    rows = [q] * (length // q) + ([length % q] if length % q else [])
    pairs = sum(r * (r + 1) // 2 for r in rows)
    flops = (bsz * g * 2 * pairs * n
             + bsz * h * (2 * pairs * p + 4 * length * n * p))
    es = x.element_size()
    nbytes = (2 * x.numel() * es + 4 * bsz * length * h
              + 4 * h * (2 if with_d else 1) + 2 * b.numel() * es
              + 4 * bsz * h * p * n * (int(init) + int(final)))
    t_ops = flops / card().peak_bf16_flops * 1e3
    t_bytes = nbytes / card().hbm_bandwidth * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def ssd_cases(rng):
    """Kernel-check cases: (name, B, L, H, P, G, N, dtype, chunk, with d,
    with an initial state, returning the state).  The slice's shapes
    (mamba2-2.7b's prefill as the path calls it, with d, from a state;
    its decode step; zamba2-2.7b's N = 64), a ragged L, G = 2, float32,
    and a seeded sweep over all of them."""
    cases = [
        ("mamba2_prefill", 2, 4096, 80, 64, 1, 128, "bf16", 256, False,
         False, True),
        ("mamba2_prefill_with_d", 2, 4096, 80, 64, 1, 128, "bf16", 256, True,
         False, False),
        ("mamba2_prefill_from_state", 2, 4096, 80, 64, 1, 128, "bf16", 256,
         False, True, True),
        ("mamba2_decode", 2, 1, 80, 64, 1, 128, "bf16", 256, False, True,
         True),
        ("zamba2_prefill", 1, 4096, 80, 64, 1, 64, "bf16", 256, False, False,
         True),
        ("ragged_L", 1, 1000, 16, 64, 1, 128, "bf16", 256, True, True, True),
        ("groups_2", 2, 300, 8, 64, 2, 64, "f32", 64, True, True, True),
        ("float32_prefill", 1, 4096, 16, 64, 1, 128, "f32", 256, True, True,
         True),
    ]
    for i in range(24):
        g = int(rng.integers(1, 4))
        h = g * int(rng.integers(1, 5))
        p = int(rng.choice([16, 32, 64, 80, 100, int(rng.integers(1, 130))]))
        cases.append((
            f"sweep{i}", int(rng.integers(1, 4)), int(rng.integers(1, 700)),
            h, p, g, int(rng.integers(1, 129)), ("f32", "bf16")[i % 2],
            int(rng.choice([16, 64, 128, 256])), bool(rng.random() < 0.5),
            bool(rng.random() < 0.5), bool(rng.random() < 0.5)))
    return cases


def ssd_inputs(torch, dev, gen, b, length, h, p, g, n, dtype, with_d, init):
    """x, dt, a, b, c, d, init_state: x normal * 0.5, dt uniform in
    (0.001, 1), a in (-16, -0.5), b and c normal * 0.3."""
    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
    return (randn((b, length, h, p), 0.5).to(dtype),
            uniform((b, length, h), 0.001, 1.0), -uniform((h,), 0.5, 16.0),
            randn((b, length, g, n), 0.3).to(dtype),
            randn((b, length, g, n), 0.3).to(dtype),
            randn((h,), 1.0) if with_d else None,
            randn((b, h, p, n), 1.0) if init else None)


def ssd_edge_cases():
    """bf16 cases at the edges of the chunk-parallel kernel's tiles, run
    with that path forced at every L (:func:`chunked_path_forced`): L
    around 64 and 256 and a ragged 4096 + 17, chunks 16 and 256, N 16, 64,
    77, 128, P 64, 80, 100, G = 2 with 3 heads a group, and an initial
    state that ``state_out`` overwrites in place (the final state aliasing
    it).  Same fields as :func:`ssd_cases`, plus the alias flag."""
    cases = [(f"bf16_L{length}", 2, length, 8, 64, 1, 128, "bf16", 256,
              True, True, True, False)
             for length in (1, 63, 64, 65, 255, 257)]
    cases += [
        ("bf16_L4113", 1, 4113, 16, 64, 1, 128, "bf16", 256, True, True,
         True, False),
        ("bf16_chunk16", 1, 1000, 8, 64, 1, 128, "bf16", 16, True, True,
         True, False),
        ("bf16_N16", 1, 700, 8, 64, 1, 16, "bf16", 256, False, True, True,
         False),
        ("bf16_N64", 1, 700, 8, 64, 1, 64, "bf16", 256, True, False, True,
         False),
        ("bf16_N77", 1, 700, 8, 64, 1, 77, "bf16", 256, True, True, True,
         False),
        ("bf16_P80", 1, 600, 8, 80, 1, 128, "bf16", 256, True, True, True,
         False),
        ("bf16_P100", 1, 600, 8, 100, 1, 128, "bf16", 128, True, True, True,
         False),
        ("bf16_groups2_3heads", 2, 500, 6, 64, 2, 128, "bf16", 256, True,
         True, True, False),
        ("bf16_state_out_aliases_init", 2, 700, 16, 64, 1, 128, "bf16", 256,
         True, True, True, True),
    ]
    return cases


@contextlib.contextmanager
def chunked_path_forced():
    """Every bf16 SSD call takes the chunk-parallel path, whatever L."""
    from repro_torch.kernels import ssd_scan as ssd
    kept = ssd.CHUNKED_MIN_LEN
    ssd.CHUNKED_MIN_LEN = 1
    try:
        yield
    finally:
        ssd.CHUNKED_MIN_LEN = kept


def ssd_kernel_checks(torch, dev) -> None:
    from repro_torch.kernels import ssd_scan as ssd
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bad = []
    cases = ([c + (False, False) for c in ssd_cases(rng)]
             + [c[:-1] + (True, c[-1]) for c in ssd_edge_cases()])
    for (name, b, length, h, p, g, n, dt, chunk, with_d, init, ret,
         forced, alias) in cases:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x, dtv, a, bm, cm, d, s0 = ssd_inputs(torch, dev, gen, b, length, h,
                                              p, g, n, dtype, with_d, init)
        kw = dict(chunk=chunk, init_state=s0, return_state=ret)
        ref = ssd.ssd_scan_plain(x, dtv, a, bm, cm, d, **kw)
        with chunked_path_forced() if forced else contextlib.nullcontext():
            out = ssd.ssd_scan(x, dtv, a, bm, cm, d, **kw,
                               state_out=s0 if alias else None)
        torch.cuda.synchronize()
        ok, err, share = checked_ssd_call(torch, out, ref)
        if alias:
            ok = ok and out[1] is s0
        shape = [b, length, h, p, g, n]
        if name.startswith("sweep"):
            if not ok:
                bad.append(dict(case=name, shape=shape, dtype=dt, err=err,
                                share=share, chunk=chunk, d=with_d,
                                init=init, ret=ret))
            continue
        check("ssm", f"ssd_scan_{name}", ok, dtype=dt, shape=shape,
              chunk=chunk, d=with_d, init_state=init, return_state=ret,
              chunked_path_forced=forced, state_out_aliases_init=alias,
              max_abs_err=err, max_share_of_tolerance=share)
    check("ssm", "ssd_scan_random_sweep_24", not bad, failures=bad[:5])
    ssd_float64_distance(torch, dev, gen)
    ssd_bf16_float64_distance(torch, dev, gen)
    ssd_path_times(torch, dev, gen)


def ssd_float64_distance(torch, dev, gen) -> None:
    """The kernel's and the plain version's float32 y and state against
    the plain version run in float64, at mamba2-2.7b's prefill shape with
    float32 inputs: the kernel must be no farther from float64 than 1.5x
    the plain version (the criterion of the logits in phase 5)."""
    from repro_torch.kernels import ssd_scan as ssd
    x, dtv, a, bm, cm, _, _ = ssd_inputs(torch, dev, gen, 2, 4096, 80, 64, 1,
                                         128, torch.float32, False, False)
    kw = dict(chunk=256, return_state=True)
    yk, sk = ssd.ssd_scan(x, dtv, a, bm, cm, **kw)
    yp, sp = ssd.ssd_scan_plain(x, dtv, a, bm, cm, **kw)
    y64, s64 = ssd.ssd_scan_plain(*(t.double() for t in (x, dtv, a, bm, cm)),
                                  **kw)
    torch.cuda.synchronize()

    def dist(u, v):
        return (u.double() - v).abs().max().item()
    d = dict(y_kernel=dist(yk, y64), y_plain=dist(yp, y64),
             state_kernel=dist(sk, s64), state_plain=dist(sp, s64))
    check("ssm", "ssd_scan_float64_distance",
          d["y_kernel"] <= 1.5 * d["y_plain"]
          and d["state_kernel"] <= 1.5 * d["state_plain"],
          y_abs_max=y64.abs().max().item(), **d)


def ssd_bf16_float64_distance(torch, dev, gen) -> None:
    """The kernel's and the plain version's bf16 y (and float32 final
    state) against the plain version run in float64 on the same bf16
    inputs, at mamba2-2.7b's prefill shape: the kernel's largest distance
    from float64 must be at most 1.5x the plain version's, and every
    kernel output within its allowance of the float64 value (SSD_F32_TOL
    plus one bf16 ulp for y).  The second guards the split float32
    factors: one bf16 rounding of any of them is 2-17x that allowance away
    from the plain version (the CPU model in tests/test_torch_ssd.py)."""
    from repro_torch.kernels import ssd_scan as ssd
    x, dtv, a, bm, cm, _, _ = ssd_inputs(torch, dev, gen, 2, 4096, 80, 64, 1,
                                         128, torch.bfloat16, False, False)
    kw = dict(chunk=256, return_state=True)
    yk, sk = ssd.ssd_scan(x, dtv, a, bm, cm, **kw)
    yp, sp = ssd.ssd_scan_plain(x, dtv, a, bm, cm, **kw)
    y64, s64 = ssd.ssd_scan_plain(*(t.double() for t in (x, dtv, a, bm, cm)),
                                  **kw)
    torch.cuda.synchronize()
    d = {}
    for part, want, ulp in (("y", y64, True), ("state", s64, False)):
        allowance = SSD_F32_TOL[0] + SSD_F32_TOL[1] * want.abs()
        if ulp:
            allowance = allowance + bf16_ulp(torch, want)
        for tag, got in (("kernel", yk if ulp else sk),
                         ("plain", yp if ulp else sp)):
            dist = (got.double() - want).abs()
            d[f"{part}_{tag}"] = dist.max().item()
            d[f"{part}_share_of_allowance_{tag}"] = (
                dist / allowance).max().item()
    check("ssm", "ssd_scan_bf16_float64_distance",
          d["y_kernel"] <= 1.5 * d["y_plain"]
          and d["state_kernel"] <= 1.5 * d["state_plain"]
          and d["y_share_of_allowance_kernel"] <= 1
          and d["state_share_of_allowance_kernel"] <= 1,
          y_abs_max=y64.abs().max().item(), **d)


def ssd_path_times(torch, dev, gen) -> None:
    """Device ms of one bf16 call at mamba2-2.7b's widths (batch 2, 80
    heads of 64, N 128, chunk 256, from a state) on each path, the
    single-launch kernel and the chunk-parallel one, over L: where the
    second starts to win sets ``CHUNKED_MIN_LEN``."""
    from repro_torch.kernels import ssd_scan as ssd
    rows = []
    for length in (1, 16, 32, 64, 128, 256, 1024):
        x, dtv, a, bm, cm, _, s0 = ssd_inputs(torch, dev, gen, 2, length, 80,
                                              64, 1, 128, torch.bfloat16,
                                              False, True)
        kw = dict(chunk=256, init_state=s0, return_state=True)
        kept = ssd.CHUNKED_MIN_LEN
        row = dict(L=length, default="chunked" if length >= kept
                   else "single_launch")
        for tag, threshold in (("single_launch_ms", 1 << 30),
                               ("chunked_ms", 1)):
            ssd.CHUNKED_MIN_LEN = threshold
            try:
                row[tag] = time_ms(torch, lambda: ssd.ssd_scan(
                    x, dtv, a, bm, cm, **kw))
            finally:
                ssd.CHUNKED_MIN_LEN = kept
        rows.append(row)
    emit(phase="ssm", what="ssd_scan_path_times", chunked_min_len=kept,
         rows=rows)


def fill_conv_bc(torch, params) -> None:
    """Draw every mamba layer's ``conv_b`` and ``conv_c`` from the seed
    (normal * 0.1, ``conv_x``'s distribution).  The reference's init
    makes them 0, and with them B = C = 0 and the SSD term 0."""
    from repro_torch.models import layers as L
    from repro_torch.models.mamba2 import Mamba2
    gen = torch.Generator(device=params.embed.device)
    gen.manual_seed(SEED + 7)
    for m in params.modules():
        if isinstance(m, Mamba2):
            L.fill_normal_(m.conv_b, 0.1, gen)
            L.fill_normal_(m.conv_c, 0.1, gen)


def ssd_record(torch, dev, calls, launches, phase: str = "ssm") -> dict:
    """Time each recorded SSD call of one prefill and its plain version
    (L2 flushed between calls); sum them and the bounds.  No PyTorch call
    computes this function, so ``library_ms`` is None."""
    flush = torch.empty(96 << 20, dtype=torch.int8, device=dev).zero_
    _mod, fn, plain = wrappers()["ssd_scan"]
    r = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, by=set(), err=0.0)
    for a, kw, (_ok, err, _share) in calls:
        r["ms"] += time_ms(torch, lambda: fn(*a, **kw), reps=3, flush=flush)
        r["plain_ms"] += time_ms(torch, lambda: plain(*a, **kw), reps=2,
                                 flush=flush)
        x, bm, d = a[0], a[3], a[5]
        bound, by = ssd_bound_ms(x, bm, kw["chunk"], d is not None,
                                 kw["init_state"] is not None,
                                 kw["return_state"])
        r["bound_ms"] += bound
        r["by"].add(by)
        r["err"] = max(r["err"], err)
    n = len(calls)
    emit(phase=phase, what="ssd_scan_timing", calls=n,
         shapes=[list(t.shape) for t in calls[0][0] if torch.is_tensor(t)],
         ms_per_launch=r["ms"] / n, plain_ms_per_launch=r["plain_ms"] / n,
         bound_ms_per_launch=r["bound_ms"] / n, library="none")
    return dict(launches=launches, calls_timed=n, max_abs_err=r["err"],
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by="operations" if "operations" in r["by"] else "bytes",
                library_ms=None)


def ssd_decode_ms(torch, dev) -> float:
    """Device ms of one bf16 SSD call at mamba2-2.7b's decode shape (batch
    2, L = 1, from a state), as the decode step launches it."""
    from repro_torch.kernels import ssd_scan as ssd
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x, dtv, a, bm, cm, _, s0 = ssd_inputs(torch, dev, gen, 2, 1, 80, 64, 1,
                                          128, torch.bfloat16, False, True)
    return time_ms(torch, lambda: ssd.ssd_scan(
        x, dtv, a, bm, cm, chunk=256, init_state=s0, return_state=True))


def ssd_kernel_split(torch, dev) -> dict:
    """Device ms of each kernel of a bf16 SSD call at mamba2-2.7b's
    prefill shape (the chunk-parallel path's three launches), from the
    profiler over 5 calls, L2 warm.  Run last: it is the phase's only
    profile of a call this short."""
    from repro_torch.kernels import ssd_scan as ssd
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x, dtv, a, bm, cm, _, _ = ssd_inputs(torch, dev, gen, 2, 4096, 80, 64, 1,
                                         128, torch.bfloat16, False, False)
    calls = 5
    prof = device_time(torch, lambda: [ssd.ssd_scan(
        x, dtv, a, bm, cm, chunk=256, return_state=True)
        for _ in range(calls)], wall_ms=1.0)
    split = {re.search(r"ssd_\w+", k).group(0): v / calls
             for k, v in prof.get("top_device_ms", {}).items()
             if re.search(r"ssd_\w+", k)}
    emit(phase="ssm", what="ssd_scan_kernel_split", per_kernel_ms=split,
         profiler_error=prof.get("profiler_error"))
    return split


def ssd_term_check(torch, calls, tag: str) -> None:
    """The SSD output of the first layer is not 0 (it would be with the
    reference's zero ``conv_b``/``conv_c``)."""
    _mod, _fn, plain = wrappers()["ssd_scan"]
    a, kw, _ = calls[0]
    y = plain(*a, **kw)[0]
    check("ssm", f"{tag}_ssd_term_is_not_zero",
          bool(y.float().abs().max() > 0), y_abs_max=y.float().abs().max()
          .item(), y_rms=y.float().pow(2).mean().sqrt().item())


def phase_ssm(torch, dev, records):
    """The Mamba-2 SSM and hybrid serving paths, bf16, random weights from
    the seed: mamba2-2.7b at full width and depth (prefill 2 x 4096, 16
    decode steps, Server), then zamba2-2.7b at full width and 12 of its
    54 layers (prefill 1 x 4096, 8 decode steps)."""
    from repro_torch import configs
    from repro_torch import device as tdevice

    rng = np.random.default_rng(SEED + 6)
    with tdevice.full_float32():
        build = build_record(torch, "ssm", "ssd_scan", ssd_label)
        ssd_kernel_checks(torch, dev)
        cfg = configs.get("mamba2-2.7b")
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (2, 4096)), device=dev)}
        model, params, logits, cache, calls, launches = prefill_path(
            torch, dev, cfg, batch, 4096, runs=3, kernel="ssd_scan",
            phase="ssm", prepare=lambda p: fill_conv_bc(torch, p))
        ssd_term_check(torch, calls, cfg.name)
        decode_path(torch, model, params, logits, cache, 4096, 16,
                    per_step={"ssd_scan": cfg.n_layers}, phase="ssm")
        del cache
        serve_path(torch, model, params, per_call={"ssd_scan": cfg.n_layers},
                   phase="ssm")
        records["ssd_scan"] = ssd_record(torch, dev, calls, launches)
        records["ssd_scan"]["extra"] = dict(
            design="bf16 chunk-parallel wgmma + TMA (3 launches) from "
                   "CHUNKED_MIN_LEN; float32 and bf16 decode CUDA cores",
            decode_ms_per_launch=ssd_decode_ms(torch, dev),
            prefill_ms_per_launch=records["ssd_scan"]["ms"]
            / records["ssd_scan"]["calls_timed"], **build)
        del model, params, calls
        torch.cuda.empty_cache()

        cfg = dataclasses.replace(configs.get("zamba2-2.7b"), n_layers=12)
        emit(phase="ssm", model=cfg.name, reduced="n_layers 54 -> 12 (two "
             "applications of the shared attention block, every 6)")
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, 4096)), device=dev)}
        model, params, logits, cache, calls, _ = prefill_path(
            torch, dev, cfg, batch, 4112, runs=2, kernel="ssd_scan",
            phase="ssm", prepare=lambda p: fill_conv_bc(torch, p))
        ssd_term_check(torch, calls, cfg.name)
        decode_path(torch, model, params, logits, cache, 4096, 8,
                    per_step={"ssd_scan": cfg.n_layers}, phase="ssm")
        z = ssd_record(torch, dev, calls, len(calls))
        n = len(calls)
        emit(phase="ssm", model=cfg.name, ssd_ms_per_launch=z["ms"] / n,
             plain_ms_per_launch=z["plain_ms"] / n,
             bound_ms_per_launch=z["bound_ms"] / n)
        del model, params, calls
        records["ssd_scan"]["extra"]["per_kernel_ms"] = ssd_kernel_split(
            torch, dev)


# ------------------------- phase 7: the MoE, VLM and enc-dec serving paths

@contextlib.contextmanager
def recorded_routing(routes: list):
    """Keep every MoE layer's ``Routing`` computed inside the block, in
    call order (one a layer)."""
    from repro_torch.models import layers
    fn = layers.moe_routing

    def rec(*a, **kw):
        r = fn(*a, **kw)
        routes.append(r)
        return r
    layers.moe_routing = rec
    try:
        yield
    finally:
        layers.moe_routing = fn


@contextlib.contextmanager
def replayed_routing(routes):
    """Inside the block, MoE layer i routes as ``routes[i]`` did: the
    same experts, queue positions and drops, with the gates taken from
    this run's own router probabilities at those experts and
    renormalised.  Every recorded layer must be replayed once.  ``None``
    changes nothing."""
    if routes is None:
        yield
        return
    from repro_torch.models import layers
    fn, it, used = layers.moe_routing, iter(routes), [0]

    def replay(cfg, router, xt):
        own, r = fn(cfg, router, xt), next(it)
        used[0] += 1
        gate = own.probs.gather(-1, r.idx)
        return r._replace(probs=own.probs, gate=gate / gate.sum(-1, True))
    layers.moe_routing = replay
    try:
        yield
    finally:
        layers.moe_routing = fn
    if used[0] != len(routes):
        raise RuntimeError(f"replayed {used[0]} of {len(routes)} MoE "
                           f"layers' routing")


def routing_recheck(torch, cfg, r) -> dict:
    """One layer's routing ``r`` held against its own router
    probabilities by means independent of ``layers.moe_routing`` (its
    stable sort, ``searchsorted`` and ``scatter_``): the chosen experts
    are distinct, their probabilities are ``torch.topk``'s k largest in
    order, ties go to the lower expert (within the chosen slots, and
    against any expert left out at the k-th value), the capacity is
    ``min(Tg k, max(1, int(cf k Tg / E)))``, and the queue positions and
    drops are the JAX package's: a cumsum over the (Tg k, E) one-hots of
    each group, token-major, kept where below the capacity.  Returns the
    count of (token, slot)s at fault under each rule."""
    g, tg, k = r.idx.shape
    e = cfg.n_experts
    hot = torch.nn.functional.one_hot(r.idx, e)              # (G, Tg, k, E)
    chosen = hot.sum(2)                                      # (G, Tg, E)
    vals = r.probs.gather(-1, r.idx)
    top = torch.topk(r.probs, k, dim=-1).values
    expert = torch.arange(e, device=r.idx.device)
    kth = vals[..., -1:]
    last_tie = torch.where(hot.bool().any(2) & (r.probs == kth), expert,
                           -1).amax(-1, keepdim=True)
    left_out_lower = ((chosen == 0) & (r.probs == kth)
                      & (expert < last_tie))
    order = vals[..., 1:] < vals[..., :-1]
    order |= (vals[..., 1:] == vals[..., :-1]) & (r.idx[..., 1:]
                                                  > r.idx[..., :-1])
    flat = hot.reshape(g, tg * k, e).int()
    pos = ((flat.cumsum(1) * flat).sum(-1) - 1).reshape(g, tg, k)
    cap = min(tg * k, max(1, int(cfg.capacity_factor * k * tg / e)))
    return dict(
        repeated_expert=int((chosen > 1).sum()),
        not_the_top_k=int((vals != top).sum()),
        slot_order=int((~order).sum()),
        tie_to_a_higher_expert=int(left_out_lower.sum()),
        capacity=int(r.capacity != cap),
        queue_position=int((r.pos != pos).sum()),
        kept=int((r.kept != (pos < cap)).sum()))


def moe_routing_report(torch, cfg, phase: str, kern: list, run) -> None:
    """The kernel path's routing against the plain path's own (``run``
    on the plain ops), layer by layer: each layer's dropped (token,
    slot)s, and the (layer, token, slot) decisions that differ: the
    expert chosen, kept or dropped, and the queue position of a slot
    both keep.  A one-ulp difference in attention can flip a top-k
    choice near a tie, and a flip moves the queue positions of every
    later token of its group (here a batch row), so the rows whose every
    decision agreed are counted too.  Both paths' routing of every layer
    is rechecked on the card (:func:`routing_recheck`), and every token
    whose chosen experts differ must sit at a near-tie: the plain path's
    gap between its k-th and (k+1)-th probabilities at most the token's
    largest probability difference between the paths (what the hidden
    states' difference does to the router's output) times two, the
    most gap that a swap of two experts can bridge."""
    tag = cfg.name
    plain: list = []
    with plain_ops(), recorded_routing(plain):
        run()
    check(phase, f"{tag}_routing_recorded_per_layer",
          len(kern) == len(plain) > 0, kernel_layers=len(kern),
          plain_layers=len(plain))
    faults: dict = {}
    for r in kern + plain:
        for rule, n in routing_recheck(torch, cfg, r).items():
            faults[rule] = faults.get(rule, 0) + n
    check(phase, f"{tag}_routing_equals_topk_and_cumsum_queues_on_card",
          not any(faults.values()), layers=len(kern) + len(plain),
          faults=faults)
    bsz = kern[0].idx.shape[0]
    same = torch.ones(bsz, dtype=torch.bool, device=kern[0].idx.device)
    experts, kept, pos, differ = 0, 0, 0, []
    flipped, far, share = 0, 0, 0.0
    for rk, rp in zip(kern, plain):
        e, k = rk.idx != rp.idx, rk.kept != rp.kept
        p = rk.kept & rp.kept & (rk.pos != rp.pos)
        d = e | k | p
        experts, kept, pos = (experts + int(e.sum()), kept + int(k.sum()),
                              pos + int(p.sum()))
        differ.append(int(d.sum()))
        same &= ~d.reshape(bsz, -1).any(-1)
        two = torch.topk(rp.probs, cfg.top_k + 1, dim=-1).values
        gap = two[..., -2] - two[..., -1]
        bound = 2 * (rk.probs - rp.probs).abs().amax(-1)
        flip = (torch.sort(rk.idx, -1).values
                != torch.sort(rp.idx, -1).values).any(-1)
        flipped += int(flip.sum())
        far += int((flip & ((gap > bound) | (bound == 0))).sum())
        if (flip & (bound > 0)).any():
            at = flip & (bound > 0)
            share = max(share, (gap[at] / bound[at]).max().item())
    check(phase, f"{tag}_every_expert_flip_is_at_a_near_tie", far == 0,
          tokens_flipped=flipped, tokens_beyond_bound=far,
          max_gap_share_of_bound=share)
    emit(phase=phase, model=tag, what="moe_routing", capacity=kern[0].capacity,
         slots_per_layer=kern[0].idx.numel(),
         dropped_per_layer=[int((~r.kept).sum()) for r in kern],
         plain_dropped_per_layer=[int((~r.kept).sum()) for r in plain],
         decisions_differing=sum(differ), differing_per_layer=differ,
         experts_differing=experts, kept_differing=kept,
         queue_positions_differing=pos,
         rows_with_equal_routing=int(same.sum()), rows=bsz)


def mrope_positions(torch, dev, bsz: int, seq: int, text: int = 512,
                    grid=(48, 64)):
    """(3, B, S) M-RoPE ids as qwen2-vl lays out a prompt: ``text`` ids
    with all three components equal, one image of ``grid`` patches at
    t = ``text`` with h and w running from ``text`` over the grid, then
    the text resuming one past the largest id."""
    gh, gw = grid
    pos = np.empty((3, seq), np.int64)
    pos[:, :text] = np.arange(text)
    end = text + gh * gw
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    pos[0, text:end] = text
    pos[1, text:end] = text + hh.ravel()
    pos[2, text:end] = text + ww.ravel()
    pos[:, end:] = pos[:, :end].max() + 1 + np.arange(seq - end)
    return torch.as_tensor(np.ascontiguousarray(
        np.broadcast_to(pos[:, None], (3, bsz, seq))), device=dev)


def mrope_sections_check(torch, dev, cfg, positions) -> None:
    """The ids take three different values at some token, and M-RoPE on
    them rotates q differently from RoPE on the temporal ids alone (an
    ``arange`` broadcast to three components would not)."""
    from repro_torch.models import layers
    pos = positions[:, :1]
    x = torch.randn((1, pos.shape[2], 1, cfg.hd), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    diff = (layers.apply_mrope(x, pos, cfg.rope_theta)
            - layers.apply_rope(x, pos[0], cfg.rope_theta)).abs().max()
    distinct = ((pos[0] != pos[1]) & (pos[1] != pos[2])).sum()
    check("families", f"{cfg.name}_positions_exercise_three_mrope_sections",
          bool(distinct > 0) and bool(diff > 0),
          tokens_with_three_distinct_ids=int(distinct),
          mrope_vs_rope_max_abs=diff.item(),
          max_id=[int(p.max()) for p in pos])


def flash_shape_time(torch, dev, label: str, call) -> dict:
    """The kernel's, the plain version's, SDPA's and the bound's ms of
    one recorded flash call (``flash_record`` on that call alone)."""
    r = flash_record(torch, dev, [call], 1)
    (q, k, _v), kw, _ = call
    row = dict(shape=label, q=list(q.shape), kv=list(k.shape),
               causal=kw["causal"], ms=r["ms"], plain_ms=r["plain_ms"],
               library_ms=r["library_ms"], bound_ms=r["bound_ms"],
               bound_by=r["bound_by"])
    emit(phase="families", what="flash_time_per_launch", **row)
    return row


def phase_families(torch, dev, records):
    """The MoE, VLM-input and encoder-decoder serving paths, bf16, flash
    attention, random weights from the seed: granite-moe-1b-a400m at full
    width and depth (prefill 2 x 4096, 16 decode steps, Server),
    llama4-scout-17b-a16e at full width and 4 of its 48 layers (prefill
    1 x 4096, 8 decode steps), qwen2-vl-2b at full width and depth
    (prefill of 2 x 4096 embeddings on M-RoPE ids of text and an image,
    16 decode steps fed embeddings), whisper-large-v3 at full width and
    depth (1500 audio frames a row, a 448-token decoder prefill of 96
    flash launches, 16 decode steps of 32).  Each path's flash launches
    are counted from 0 just before it and read just after."""
    from repro_torch import configs
    from repro_torch import device as tdevice

    rng = np.random.default_rng(SEED + 9)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    def flash(name):
        return dataclasses.replace(configs.get(name), attention_impl="flash")
    launches, shapes = {}, []
    with tdevice.full_float32():
        cfg = flash("granite-moe-1b-a400m")
        emit(phase="families", model=cfg.name,
             param_count=cfg.param_count(),
             active_param_count=cfg.active_param_count(),
             capacity_factor=cfg.capacity_factor)
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (2, 4096)), device=dev)}
        model, params, logits, cache, calls, n = prefill_path(
            torch, dev, cfg, batch, 4112, runs=2, phase="families")
        launches[f"{cfg.name} prefill"] = n
        shapes.append(flash_shape_time(torch, dev, "granite prefill, GQA "
                                       "16:8, D 64, causal", calls[0]))
        decode_path(torch, model, params, logits, cache, 4096, 16,
                    phase="families")
        del cache, calls
        torch.cuda.empty_cache()
        serve_path(torch, model, params, phase="families")
        del model, params
        torch.cuda.empty_cache()

        full = configs.get("llama4-scout-17b-a16e")
        cfg = dataclasses.replace(flash(full.name), n_layers=4)
        emit(phase="families", model=cfg.name, reduced="n_layers 48 -> 4",
             param_count=cfg.param_count(),
             full_depth_param_count=full.param_count(),
             full_depth_bf16_gb=2 * full.param_count() / 1e9)
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, 4096)), device=dev)}
        model, params, logits, cache, calls, n = prefill_path(
            torch, dev, cfg, batch, 4104, runs=2, phase="families")
        launches[f"{cfg.name} prefill (4 layers)"] = n
        shapes.append(flash_shape_time(torch, dev, "scout prefill, GQA 40:8, "
                                       "D 128, causal", calls[0]))
        decode_path(torch, model, params, logits, cache, 4096, 8,
                    phase="families")
        del model, params, cache, calls
        torch.cuda.empty_cache()

        cfg = flash("qwen2-vl-2b")
        positions = mrope_positions(torch, dev, 2, 4096)
        mrope_sections_check(torch, dev, cfg, positions)
        batch = {"embeds": (torch.randn((2, 4096, cfg.d_model), device=dev,
                                        generator=gen) * 0.02).bfloat16(),
                 "positions": positions}
        model, params, logits, cache, calls, n = prefill_path(
            torch, dev, cfg, batch, 4112, runs=2, phase="families")
        launches[f"{cfg.name} prefill"] = n
        steps = (torch.randn((16, 2, 1, cfg.d_model), device=dev,
                             generator=gen) * 0.02).bfloat16()
        decode_path(torch, model, params, logits, cache, 4096, 16,
                    phase="families",
                    feed=lambda i, tok: {"embeds": steps[min(i, 15)]})
        del model, params, cache, calls
        torch.cuda.empty_cache()

        cfg = flash("whisper-large-v3")
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (2, 448)), device=dev),
            "audio_embeds": torch.randn(
                (2, cfg.encoder_seq, cfg.d_model), device=dev,
                generator=gen).bfloat16()}
        emit(phase="families", model=cfg.name, encoder_frames=2
             * cfg.encoder_seq, decoder_tokens=2 * 448,
             flash_per_prefill=3 * cfg.n_layers,
             flash_per_decode_step=cfg.n_layers)
        model, params, logits, cache, calls, n = prefill_path(
            torch, dev, cfg, batch, 464, runs=2, phase="families",
            per_prefill=3 * cfg.n_layers)
        launches[f"{cfg.name} prefill"] = n
        kinds = {"encoder": calls[0], "decoder self": calls[cfg.n_layers],
                 "cross": calls[cfg.n_layers + 1]}
        check("families", f"{cfg.name}_prefill_calls_in_layer_order",
              [tuple(c[0][0].shape[2:3]) + tuple(c[0][1].shape[2:3])
               + (c[1]["causal"],) for c in kinds.values()]
              == [(1500, 1500, False), (448, 448, True), (448, 1500, False)],
              calls=len(calls))
        for label, call in kinds.items():
            shapes.append(flash_shape_time(torch, dev, f"whisper {label}, "
                                           "MHA 20:20, D 64", call))
        dcalls, counts = decode_path(
            torch, model, params, logits, cache, 448, 16,
            per_step={"flash_attention": cfg.n_layers}, phase="families",
            checked=True)
        launches[f"{cfg.name} 16 decode steps"] = counts["flash_attention"]
        shapes.append(flash_shape_time(torch, dev, "whisper decode cross, "
                                       "Sq 1 over 1500, D 64", dcalls[0]))
        del model, params, cache, calls, dcalls
        torch.cuda.empty_cache()
    if "flash_attention" in records:
        records["flash_attention"].setdefault("extra", {})["families"] = \
            dict(launches=launches, per_shape=shapes)


# ------------------------------------------------- phase 8: training

#: A bf16 step's gradient against a float32 run of the same weights and
#: batch on the card: whole-gradient cosine at least GRAD_COSINE, the
#: loss within LOSS_REL of the float32 loss.
GRAD_COSINE = 0.99
LOSS_REL = 0.01
#: A float32 step on the card against the port on the CPU (lm100m): the
#: CPU parity tests' tolerances (tests/test_torch_train.py): the loss
#: within 1e-5 relative, each leaf within 1e-4 of its own largest |g|
#: plus 1e-6 of the whole gradient's.
CPU_LOSS_RTOL, LEAF_RTOL, WHOLE_RTOL = 1e-5, 1e-4, 1e-6
#: Kernel kinds of a train step's profile, by name: cuBLAS float32 GEMMs
#: on the CUDA cores (the chunked attention's einsums, float32 without
#: TF32), the bf16 tensor-core products, the optimizer's multi-tensor
#: passes, reductions, copies and casts, the rest of the elementwise
#: passes.
TRAIN_KINDS = (("float32 GEMM", r"f32f32|sgemm"),
               ("bf16 GEMM", r"nvjet|bf16.*(gemm|xmma)|(gemm|xmma).*bf16"
                r"|cutlass"),
               ("optimizer foreach", r"multi_tensor_apply"),
               ("reductions", r"reduce_kernel|softmax|norm"),
               ("copies and casts", r"Memcpy|Memset|copy"),
               ("elementwise", r"elementwise|index|scatter|gather"))


def synthetic_batch(torch, dev, cfg, bsz: int, seq: int, step: int = 0):
    """``SyntheticLM`` tokens and labels of ``cfg``'s vocabulary, on the
    card."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                 global_batch=bsz, seed=SEED))
    return {k: torch.as_tensor(v, device=dev)
            for k, v in src.batch_at(step).items()}


def float32_grads(torch, model, params, batch) -> tuple:
    """The loss and gradient of the same weights and batch in float32
    (TF32 off), on the plain attention the model trains on.  The weights
    go to float32 in place and back to their own dtypes after (bf16 ->
    float32 -> bf16 is exact); the gradient stays float32."""
    from repro_torch import device as tdevice
    from repro_torch import optim
    from repro_torch.models.model import Model
    m32 = Model(dataclasses.replace(model.cfg, dtype="float32"),
                device=model.device, remat=model.remat)
    dtypes = {n: p.dtype for n, p in params.named_parameters()}
    torch.cuda.empty_cache()
    params.float()
    try:
        with tdevice.full_float32():
            return optim.value_and_grad(m32.loss, params, batch)
    finally:
        for n, p in params.named_parameters():
            p.data = p.data.to(dtypes[n])
        torch.cuda.empty_cache()


def grad_agreement(torch, got: dict, ref: dict) -> dict:
    """The whole-gradient cosine of ``got`` against ``ref`` (gradients by
    parameter name), summed in float64; the smallest per-leaf cosine and
    its leaf; the whole gradient's relative L2 distance."""
    dot = gg = rr = 0.0
    leaf_min, leaf_name = 2.0, None
    for n, r in ref.items():
        g, r = got[n].float(), r.float()
        d = (g * r).sum(dtype=torch.float64).item()
        a = (g * g).sum(dtype=torch.float64).item()
        b = (r * r).sum(dtype=torch.float64).item()
        dot, gg, rr = dot + d, gg + a, rr + b
        if a > 0 and b > 0 and d / math.sqrt(a * b) < leaf_min:
            leaf_min, leaf_name = d / math.sqrt(a * b), n
    return dict(cosine=dot / math.sqrt(gg * rr),
                rel_l2=math.sqrt(max(gg - 2 * dot + rr, 0.0) / rr),
                min_leaf_cosine=leaf_min, min_leaf=leaf_name)


def step_against_float32(torch, tag, model, params, batch) -> tuple:
    """The bf16 gradient of one batch against a float32 run of the same
    weights and batch (GRAD_COSINE, LOSS_REL).  Returns (the bf16 loss,
    the bf16 grads)."""
    from repro_torch import optim
    (loss, grads), ms = timed(torch, lambda: optim.value_and_grad(
        model.loss, params, batch))
    loss32, grads32 = float32_grads(torch, model, params, batch)
    agree = grad_agreement(torch, grads, grads32)
    del grads32
    loss, loss32 = float(loss), float(loss32)
    check("train", f"{tag}_step1_gradient_matches_float32",
          math.isfinite(loss) and agree["cosine"] >= GRAD_COSINE
          and abs(loss - loss32) <= LOSS_REL * abs(loss32),
          loss=loss, loss_float32=loss32, grad_ms=ms,
          cosine_min=GRAD_COSINE, loss_rel_max=LOSS_REL, **agree)
    return loss, grads


def refuses_a_gradient(fn) -> bool:
    """Whether ``fn`` raises the kernels' no-backward error."""
    try:
        fn()
    except RuntimeError as e:
        return "has no backward" in str(e)
    return False


def train_guards(torch, dev) -> None:
    """On the card, both kernels refuse inputs that require grad while
    grad mode is on, and launch on the same inputs with it off."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)

    def rand(*shape, dtype=torch.bfloat16, grad=False):
        return torch.randn(shape, device=dev, generator=gen, dtype=dtype
                           ).requires_grad_(grad)
    q, kv = rand(1, 4, 256, 64, grad=True), rand(1, 2, 256, 64)
    x, bc = rand(1, 256, 8, 64), rand(1, 256, 1, 128, grad=True)
    dt = torch.rand((1, 256, 8), device=dev, generator=gen) * 0.1
    a = -torch.rand(8, device=dev, generator=gen)
    ops.reset_launch_counts()
    flash = refuses_a_gradient(lambda: ops.flash_attention(q, kv, kv))
    ssd = refuses_a_gradient(lambda: ops.ssd_scan(x, dt, a, bc, bc))
    refused = ops.launch_counts()
    with torch.no_grad():
        ops.flash_attention(q, kv, kv)
        ops.ssd_scan(x, dt, a, bc, bc)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check("train", "flash_attention_refuses_a_gradient_on_the_card",
          flash and refused["flash_attention"] == 0
          and counts["flash_attention"] == 1, launches=counts)
    check("train", "ssd_scan_refuses_a_gradient_on_the_card",
          ssd and refused["ssd_scan"] == 0 and counts["ssd_scan"] == 1,
          launches=counts)


def train_qwen2(torch, dev) -> None:
    """qwen2-1.5b at full width and depth, bf16, chunked attention,
    remat "full", AdamW: step 1's gradient against float32; 4 timed steps
    on 2 x 4096 SyntheticLM tokens (flash and SSD launches counted from 0
    before them: 0 expected), a fifth and sixth under the profiler; then
    the trained weights served through ``Model.prefill`` on the flash
    kernel (1 x 4096: 28 launches, each held against the plain version,
    the logits by phase 5's criterion)."""
    from repro_torch import configs, optim
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    cfg = configs.get("qwen2-1.5b")
    tag = cfg.name
    model = Model(cfg, dev, remat="full")
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    params.requires_grad_(True)
    n_params = sum(p.numel() for p in params.parameters())
    batches = [synthetic_batch(torch, dev, cfg, 2, 4096, s)
               for s in range(5)]
    emit(phase="train", model=tag, layers=cfg.n_layers, d_model=cfg.d_model,
         params=n_params, dtype=cfg.dtype, attention=cfg.attention_impl,
         remat=model.remat, batch=[2, 4096], optimizer="adamw")
    _, grads = step_against_float32(torch, tag, model, params, batches[0])
    del grads
    torch.cuda.empty_cache()

    opt_cfg = optim.OptimizerConfig()
    state = {"params": params, "opt": optim.init_opt_state(params, opt_cfg),
             "step": 0}
    step_fn = optim.make_train_step(model, opt_cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times, losses = [], []
    for i in range(4):
        (_, m), ms = timed(torch, lambda: step_fn(state, batches[i]))
        times.append(ms)
        losses.append(float(m["loss"]))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check("train", f"{tag}_4_steps_finite_and_no_kernel_launch",
          all(math.isfinite(v) for v in losses)
          and counts["flash_attention"] == 0 and counts["ssd_scan"] == 0,
          losses=losses, launches=counts)
    step_ms = statistics.median(times[1:])
    MEASURED["qwen2_train"] = (step_ms, peak)
    tokens = 2 * 4096
    emit(phase="train", model=tag, card=card_line(),
         ms_per_step_median_2_4=step_ms, ms_per_step_all=times,
         tokens_per_s=tokens / step_ms * 1e3,
         max_memory_allocated_bytes=peak,
         model_flops_share=6 * n_params * tokens
         / (step_ms / 1e3 * card().peak_bf16_flops),
         model_flops_per_step=6 * n_params * tokens)
    emit(phase="train", model=tag, what="train_step", **device_time(
        torch, lambda: step_fn(state, batches[4]), step_ms, TRAIN_KINDS))
    del state["opt"], state, step_fn, batches
    torch.cuda.empty_cache()
    train_then_serve(torch, dev, model, params)


def train_then_serve(torch, dev, model, params) -> None:
    """The trained weights through ``Model.prefill`` on the flash kernel."""
    from repro_torch import device as tdevice
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(model.cfg, attention_impl="flash")
    tag = f"{cfg.name}_trained"
    serving = Model(cfg, dev)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(SEED + 22)
                                       .integers(0, cfg.vocab_size,
                                                 (1, 4096)), device=dev)}
    with tdevice.full_float32():
        calls: list = []
        with checked_kernel(torch, calls, "flash_attention"):
            serving.prefill(params, batch, 4096)
        torch.cuda.synchronize()
        agree = [c[2] for c in calls]
        check("train", f"{tag}_every_prefill_call_agrees_with_plain",
              len(calls) == cfg.n_layers and all(a[0] for a in agree),
              calls=len(calls), max_abs_err=max(a[1] for a in agree),
              max_share_of_tolerance=max(a[2] for a in agree))
        del calls
        ops.reset_launch_counts()
        (logits, _), ms = timed(torch, lambda: serving.prefill(
            params, batch, 4096))
        launches = ops.launch_counts()["flash_attention"]
        check("train", f"{tag}_prefill_launches_{cfg.n_layers}",
              launches == cfg.n_layers, launches=launches, prefill_ms=ms)
        with plain_ops():
            plain, _ = serving.prefill(params, batch, 4096)
        agreement = logits_agreement(torch, logits, plain, float32_logits(
            torch, serving, params, batch, 4096))
        check("train", f"{tag}_prefill_logits_match_plain_path",
              agreement.pop("ok"), shape=list(logits.shape), **agreement)


def train_remat(torch, dev) -> None:
    """qwen2-1.5b at full width and 4 of its 28 layers, 2 x 4096: the
    gradients under remat "none", "full" and "dots" equal
    (``torch.equal``) under ``torch.use_deterministic_algorithms(True)``,
    set for this check only (cuBLAS needs CUBLAS_WORKSPACE_CONFIG, set at
    the top of the script); each policy's ms (the second of two runs)
    and peak memory."""
    from repro_torch import configs, optim
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"), n_layers=4)
    emit(phase="train", model=cfg.name, reduced="n_layers 28 -> 4",
         what="remat")
    params = Model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(SEED + 23))
    params.requires_grad_(True)
    batch = synthetic_batch(torch, dev, cfg, 2, 4096)
    out, stats = {}, {}
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for remat in ("none", "full", "dots"):
            model = Model(cfg, dev, remat=remat)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            # the second of two runs is timed (the first warms up)
            runs = [timed(torch, lambda: optim.value_and_grad(
                model.loss, params, batch)) for _ in range(2)]
            out[remat] = runs[-1][0]
            stats[remat] = dict(ms=runs[-1][1], first_ms=runs[0][1],
                                peak_bytes=torch.cuda.max_memory_allocated())
    finally:
        torch.use_deterministic_algorithms(prev)
    loss0, g0 = out["none"]
    for remat in ("full", "dots"):
        loss, g = out[remat]
        differ = [n for n in g0 if not torch.equal(g[n], g0[n])]
        check("train", f"remat_{remat}_gradients_equal_none",
              torch.equal(loss, loss0) and not differ, leaves=len(g0),
              differing=differ[:8], loss=float(loss))
    emit(phase="train", model=cfg.name, what="remat_cost", **stats)


def train_lm100m(torch, dev) -> None:
    """lm100m at full width and depth (12 x 768, float32, naive
    attention) through ``launch/train.py``: 60 steps (the JAX launcher
    test's lr 5e-3, warm-up 5: the mean of the last 5 losses below 0.9x
    the first 5'), resume equivalence (6 steps against 3 + restore + 3,
    under deterministic algorithms, the JAX resume test's tolerances),
    int8 error feedback (the last loss below the first), the ms of a
    step, and step 1 in float32 against the port on the CPU."""
    import tempfile
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs, convert, optim
    from repro_torch import device as tdevice
    from repro_torch.launch import train as train_mod
    from repro_torch.models.model import Model
    args = ["--arch", "lm100m", "--preset", "full", "--seq-len", "256",
            "--global-batch", "8", "--lr", "5e-3", "--warmup", "5",
            "--log-every", "20"]
    cfg = configs.get("lm100m")

    def run(*extra):
        with tempfile.NamedTemporaryFile(suffix=".json") as f:
            rc, ms = timed(torch, lambda: train_mod.main(
                args + ["--metrics-out", f.name] + list(extra)))
            return rc, [m["loss"] for m in json.load(open(f.name))], ms

    rc, losses, ms = run("--steps", "60")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check("train", "lm100m_60_steps_loss_decreases",
          rc == 0 and last < 0.9 * first, first5=float(first),
          last5=float(last), losses=losses[::10], wall_ms=ms)

    with tempfile.TemporaryDirectory() as tmp:
        full_dir, res_dir = f"{tmp}/full", f"{tmp}/resumed"
        prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            _, full, _ = run("--steps", "6", "--ckpt-dir", full_dir)
            run("--steps", "3", "--ckpt-dir", res_dir)
            _, resumed, _ = run("--steps", "6", "--ckpt-dir", res_dir)
        finally:
            torch.use_deterministic_algorithms(prev)
        meta = Model(cfg, "meta").empty_params()
        skel = convert.train_state_to_tree(cfg, {
            "params": meta, "step": 0, "opt": optim.init_opt_state(
                meta, optim.OptimizerConfig())}, "meta")
        a, step_a, _ = ckpt.restore(full_dir, skel)
        b, step_b, _ = ckpt.restore(res_dir, skel)
        leaves_a = ckpt._flatten(a["params"])
        leaves_b = ckpt._flatten(b["params"])
        worst = max(((leaves_b[n] - t).abs()
                     - 2e-5 * t.abs()).max().item()
                    for n, t in leaves_a.items())
        equal = all(torch.equal(leaves_b[n], t) for n, t in leaves_a.items())
        check("train", "lm100m_resume_equals_uninterrupted",
              step_a == step_b == 6 and len(resumed) == 3
              and abs(full[-1] - resumed[-1]) < 1e-5 and worst <= 2e-6,
              loss_full=full[-1], loss_resumed=resumed[-1],
              params_bit_equal=equal, worst_excess_over_rtol=worst)

    rc, losses, _ = run("--steps", "30", "--grad-compression", "int8_ef")
    check("train", "lm100m_int8_ef_loss_decreases",
          rc == 0 and losses[-1] < losses[0], first=losses[0],
          last=losses[-1])

    model = Model(cfg, dev)
    opt_cfg = optim.OptimizerConfig(lr=5e-3, warmup_steps=5)
    state = optim.init_train_state(
        model, torch.Generator(device=dev).manual_seed(SEED), opt_cfg)
    step_fn = optim.make_train_step(model, opt_cfg)
    batch = synthetic_batch(torch, dev, cfg, 8, 256)
    times = [timed(torch, lambda: step_fn(state, batch))[1]
             for _ in range(6)]
    emit(phase="train", model=cfg.name, batch=[8, 256], card=card_line(),
         ms_per_step_median=statistics.median(times[1:]),
         ms_per_step_all=times)
    del state, step_fn

    params = model.init(torch.Generator(device=dev).manual_seed(SEED + 24))
    params.requires_grad_(True)
    batch = synthetic_batch(torch, dev, cfg, 2, 256, 1)
    with tdevice.full_float32():
        loss, grads = optim.value_and_grad(model.loss, params, batch)
    cpu = Model(cfg, "cpu")
    cpu_params = cpu.empty_params()
    cpu_params.load_state_dict(params.state_dict())
    cpu_params.requires_grad_(True)
    (loss_c, grads_c), cpu_ms = timed(torch, lambda: optim.value_and_grad(
        cpu.loss, cpu_params, {k: v.cpu() for k, v in batch.items()}))
    whole = max(g.abs().max().item() for g in grads_c.values())
    worst, worst_leaf = 0.0, None
    for n, gc in grads_c.items():
        share = ((grads[n].cpu() - gc).abs().max().item()
                 / (LEAF_RTOL * gc.abs().max().item() + WHOLE_RTOL * whole))
        if share > worst:
            worst, worst_leaf = share, n
    loss, loss_c = float(loss), float(loss_c)
    check("train", "lm100m_float32_step1_matches_the_cpu",
          abs(loss - loss_c) <= CPU_LOSS_RTOL * abs(loss_c) and worst <= 1,
          loss=loss, loss_cpu=loss_c, max_share_of_tolerance=worst,
          worst_leaf=worst_leaf, cpu_ms=cpu_ms)


def train_mamba2(torch, dev) -> None:
    """mamba2-2.7b at full width and 4 of its 64 layers, 1 x 2048, B/C
    convs from the seed: the bf16 gradient against float32, no
    ``ssd_scan`` launch in the gradients or the AdamW step, and the
    serving prefill afterwards launching it once a layer."""
    from repro_torch import configs, optim
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(configs.get("mamba2-2.7b"), n_layers=4)
    tag = cfg.name
    emit(phase="train", model=tag, reduced="n_layers 64 -> 4",
         batch=[1, 2048])
    model = Model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED + 25))
    fill_conv_bc(torch, params)
    params.requires_grad_(True)
    batch = synthetic_batch(torch, dev, cfg, 1, 2048)
    ops.reset_launch_counts()
    loss, grads = step_against_float32(torch, tag, model, params, batch)
    opt_cfg = optim.OptimizerConfig()
    opt_state = optim.init_opt_state(params, opt_cfg)
    _, ms = timed(torch, lambda: optim.apply_update(
        params, grads, opt_state, 0, opt_cfg))
    del grads, opt_state
    training = ops.launch_counts()
    ops.reset_launch_counts()
    with torch.no_grad():
        model.prefill(params, {"tokens": batch["tokens"]}, 2048)
    torch.cuda.synchronize()
    serving = ops.launch_counts()
    check("train", f"{tag}_trains_off_the_kernel_and_serves_on_it",
          training["ssd_scan"] == 0 and serving["ssd_scan"] == cfg.n_layers
          and all(math.isfinite(p.float().sum().item())
                  for p in params.parameters()), training=training,
          serving=serving, update_ms=ms, loss=loss)
    del params
    torch.cuda.empty_cache()


def train_families(torch, dev) -> None:
    """One AdamW step each at full width: granite-moe-1b-a400m (4 of 24
    layers, 1 x 2048 tokens), qwen2-vl-2b (4 of 28, 1 x 2048 embeddings on
    M-RoPE ids of text and an image), whisper-large-v3 (4 + 4 layers,
    1500 frames, 448 tokens).  The loss finite, and every leaf's
    gradient nonzero except the key biases, whose true gradient is 0
    (softmax ignores a per-query shift)."""
    from repro_torch import configs, optim
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    rng = np.random.default_rng(SEED + 26)
    for name, extra, seq in (("granite-moe-1b-a400m", {}, 2048),
                             ("qwen2-vl-2b", {}, 2048),
                             ("whisper-large-v3", {"encoder_layers": 4},
                              448)):
        full = configs.get(name)
        cfg = dataclasses.replace(full, n_layers=4, **extra)
        emit(phase="train", model=name, reduced=f"n_layers {full.n_layers}"
             f" -> 4" + (f", encoder_layers {full.encoder_layers} -> 4"
                         if extra else ""), seq=seq)
        model = Model(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(
            SEED + 27))
        params.requires_grad_(True)
        batch = {"labels": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, seq)), device=dev)}
        if cfg.input_embeds and cfg.family != "encdec":
            batch["embeds"] = torch.randn((1, seq, cfg.d_model), device=dev,
                                          dtype=model.dtype)
        else:
            batch["tokens"] = torch.as_tensor(
                rng.integers(0, cfg.vocab_size, (1, seq)), device=dev)
        if cfg.mrope:
            batch["positions"] = mrope_positions(torch, dev, 1, seq,
                                                 grid=(24, 32))
        if cfg.family == "encdec":
            batch["audio_embeds"] = torch.randn(
                (1, cfg.encoder_seq, cfg.d_model), device=dev,
                dtype=model.dtype)
        opt_cfg = optim.OptimizerConfig()
        ops.reset_launch_counts()
        (loss, grads), ms = timed(torch, lambda: optim.value_and_grad(
            model.loss, params, batch))
        state = optim.init_opt_state(params, opt_cfg)
        optim.apply_update(params, grads, state, 0, opt_cfg)
        zero = [n for n, g in grads.items()
                if not n.endswith(".bk") and not bool(g.any())]
        key_bias = {n: g.abs().max().item() for n, g in grads.items()
                    if n.endswith(".bk")}
        counts = ops.launch_counts()
        check("train", f"{name}_one_step_every_gradient_nonzero",
              math.isfinite(float(loss)) and not zero
              and all(math.isfinite(p.float().sum().item())
                      for p in params.parameters())
              and counts["flash_attention"] == 0, loss=float(loss),
              leaves=len(grads), zero_leaves=zero[:8], grad_ms=ms,
              key_bias_max_abs=max(key_bias.values(), default=None),
              launches=counts)
        del model, params, grads, state
        torch.cuda.empty_cache()


def phase_train(torch, dev, records):
    """Training on the card (this phase launches no kernel of the
    record: training refuses both float kernels, as ``jax.grad`` does
    the JAX package's; the train -> serve prefill launches flash)."""
    emit(phase="train", card=card_line())
    for part in (train_guards, train_qwen2, train_remat, train_lm100m,
                 train_mamba2, train_families):
        t0 = time.perf_counter()
        with guarded("train"):
            part(torch, dev)
        emit(phase="train", part=part.__name__,
             seconds=round(time.perf_counter() - t0, 3))
        torch.cuda.empty_cache()


# --------------------------------------------------- phase 9: distribution

def launches_of(torch, run) -> tuple:
    """(result, launch counts) of ``run()``, the counts set to 0 just
    before it."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, ops.launch_counts()


def dist_prefill(torch, dev, mesh, cfg, kernel, prepare=None) -> None:
    """``Model.prefill`` of 2 x 4096 tokens at full width and depth, first
    without a policy, then with the same weights distributed by a
    ``ShardingPolicy`` over the one-rank NCCL mesh: the sharded run
    launches ``kernel`` once a layer on each rank's local shards (each
    call held against the plain version) and gives the unsharded logits
    bit for bit."""
    from repro_torch.models.model import Model
    from repro_torch.sharding import ShardingPolicy
    tag = cfg.name
    plain_model = Model(cfg, dev)
    params = plain_model.init(torch.Generator(device=dev).manual_seed(SEED))
    if prepare is not None:
        prepare(params)
    batch = {"tokens": synthetic_batch(torch, dev, cfg, 2, 4096)["tokens"]}
    logits0, _ = plain_model.prefill(params, batch, 4096)
    _, plain_ms = timed(torch, lambda: plain_model.prefill(params, batch,
                                                           4096))
    policy = ShardingPolicy(mesh, cfg)
    model = Model(cfg, dev, policy=policy)
    policy.param_shardings(params)
    calls: list = []
    with checked_kernel(torch, calls, kernel):
        (logits1, cache), counts = launches_of(
            torch, lambda: model.prefill(params, batch, 4096))
    agree = [c[2] for c in calls]
    check("dist", f"{tag}_policy_prefill_launches_{kernel}_{cfg.n_layers}",
          counts[kernel] == cfg.n_layers == len(calls)
          and all(a[0] for a in agree), launches=counts[kernel],
          calls=len(calls), max_abs_err=max(a[1] for a in agree),
          max_share_of_tolerance=max(a[2] for a in agree),
          local_shapes=[list(c[0][0].shape) for c in calls[:1]])
    full = logits1.full_tensor()
    check("dist", f"{tag}_policy_prefill_logits_equal_unsharded",
          torch.equal(full, logits0), placements=str(logits1.placements),
          max_abs_err=(full.float() - logits0.float()).abs().max().item(),
          cache_placements=str(next(iter(cache.values())).placements))
    _, ms = timed(torch, lambda: model.prefill(params, batch, 4096))
    emit(phase="dist", model=tag, card=card_line(), policy_prefill_ms=ms,
         unsharded_prefill_ms=plain_ms)
    del params, cache, logits0, logits1, full
    torch.cuda.empty_cache()


def dist_train(torch, dev, mesh) -> None:
    """One qwen2-1.5b train step (bf16, remat "full", 2 x 4096) under the
    policy with ZeRO-1 at data size 1, against the same step without a
    policy, under deterministic algorithms: the loss and every updated
    weight equal."""
    from repro_torch import configs, optim
    from repro_torch.models.model import Model
    from repro_torch.sharding import ShardingPolicy
    cfg = configs.get("qwen2-1.5b")
    opt_cfg = optim.OptimizerConfig()
    batch = synthetic_batch(torch, dev, cfg, 2, 4096)
    torch.use_deterministic_algorithms(True)
    try:
        model0 = Model(cfg, dev, remat="full")
        params = model0.init(torch.Generator(device=dev).manual_seed(SEED))
        start = {n: p.detach().clone() for n, p in params.named_parameters()}
        params.requires_grad_(True)
        state = {"params": params, "opt": optim.init_opt_state(params,
                                                                opt_cfg),
                 "step": 0}
        (_, m0), ms0 = timed(torch, lambda: optim.make_train_step(
            model0, opt_cfg)(state, batch))
        loss0 = m0["loss"].clone()
        del state["opt"], state
        torch.cuda.empty_cache()
        with torch.no_grad():
            for n, p in params.named_parameters():
                start[n], p.data = p.data, start[n]
        after0 = start            # the unsharded step's weights
        policy = ShardingPolicy(mesh, cfg)
        model1 = Model(cfg, dev, remat="full", policy=policy)
        policy.param_shardings(params)
        state = {"params": params, "step": 0,
                 "opt": optim.init_opt_state_sharded(params, opt_cfg,
                                                     policy)}
        (_, m1), ms1 = timed(torch, lambda: optim.make_train_step(
            model1, opt_cfg)(state, batch))
        loss1 = m1["loss"].full_tensor()
        diff = {n: (p.to_local().float() - after0[n].float()).abs().max()
                .item() for n, p in params.named_parameters()}
        equal = all(torch.equal(p.to_local(), after0[n])
                    for n, p in params.named_parameters())
        check("dist", "qwen2-1.5b_policy_train_step_equals_unsharded",
              torch.equal(loss0, loss1) and equal, loss=loss0.item(),
              loss_policy=loss1.item(), weights_equal=equal,
              max_weight_diff=max(diff.values()),
              opt_placements=str(next(iter(state["opt"]["mu"].values()))
                                 .placements),
              step_ms=ms0, policy_step_ms=ms1)
    finally:
        torch.use_deterministic_algorithms(False)
    del state, params, after0
    torch.cuda.empty_cache()


def dist_compressed_psum(torch, dev) -> None:
    """``compressed_psum`` on the NCCL group: two NCCL all-reduces, the
    first of the int32 payload (the profiler's ``nccl:all_reduce``
    records; the dtypes from the calls themselves), and the value equals
    the dequantized input (one rank's mean is its own reconstruction).
    NCCL copies on a communicator of one rank instead of launching a
    reduction kernel, so the device side shows no NCCL kernel here; the
    two gloo ranks below reduce int32 across processes."""
    import torch.distributed as tdist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed import (compressed_psum, dequantize_int8,
                                         quantize_int8)
    x = torch.randn(1 << 20, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    want = dequantize_int8(*quantize_int8(x))
    dtypes = []
    real = tdist.all_reduce

    def spy(t, *a, **kw):
        dtypes.append(str(t.dtype))
        return real(t, *a, **kw)
    tdist.all_reduce = spy
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = compressed_psum(x)
            torch.cuda.synchronize()
    finally:
        tdist.all_reduce = real
    names = [e.name for e in prof.events()]
    nccl_host = [n for n in names if n == "nccl:all_reduce"]
    nccl_kernels = sorted({n for n in names if "nccl" in n.lower()
                           and "kernel" in n.lower()})
    check("dist", "compressed_psum_int32_all_reduce_on_nccl",
          dtypes == ["torch.int32", "torch.float32"]
          and len(nccl_host) == 2, all_reduce_dtypes=dtypes,
          nccl_all_reduce_records=len(nccl_host),
          nccl_device_kernels=nccl_kernels,
          world_size=tdist.get_world_size())
    check("dist", "compressed_psum_equals_dequantized_input",
          torch.equal(got, want),
          max_abs_err=(got - want).abs().max().item())


def _gloo_rank(rank: int, store: str, out_dir: str) -> None:
    """One of two gloo ranks on the one card (``dist_two_gloo_ranks``)."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.distributed import compressed_psum
    from repro_torch.launch import mesh as M
    from repro_torch.sharding import ShardingPolicy
    torch.cuda.set_device(0)
    M.init_world("gloo", 2, rank, store)
    result = {"backend": torch.distributed.get_backend()}
    try:
        mesh = M.make_compat_mesh((1, 2), ("data", "model"), "cuda")
        policy = ShardingPolicy(mesh, configs.get("qwen2-1.5b"))
        policy._decode_seq_axes = ("model",)
        q, kc, vc, lengths = decode_inputs(torch)
        for name, window in (("none", None), ("h2o_4096", 4096),
                             ("w1000", 1000)):
            o = policy.sharded_decode_attention(q, kc, vc, lengths, window)
            torch.save(o.to_local().cpu(),
                       os.path.join(out_dir, f"o_{name}_{rank}.pt"))
        g = torch.Generator(device="cuda").manual_seed(SEED + 2)
        xs = torch.randn(2, 4096, device="cuda", generator=g)
        got = compressed_psum(xs[rank].clone())
        result["psum_max_abs_err"] = (got - xs.mean(0)).abs().max().item()
        result["ok"] = True
    except Exception as e:  # reported by the parent as a failed check
        result["error"] = f"{type(e).__name__}: {e}"
        traceback.print_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        M.destroy_world()


def decode_inputs(torch):
    """qwen2-1.5b's decode attention at a 4096-token cache, float32, from
    the seed: q (4, 12, 1, 128), caches (4, 2, 4096, 128), lengths."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q = torch.randn(4, 12, 1, 128, device="cuda", generator=g)
    kc = torch.randn(4, 2, 4096, 128, device="cuda", generator=g)
    vc = torch.randn(4, 2, 4096, 128, device="cuda", generator=g)
    lengths = torch.tensor([4096, 2048, 3000, 7], dtype=torch.int32,
                           device="cuda")
    return q, kc, vc, lengths


def dist_two_gloo_ranks(torch, dev) -> None:
    """Two processes on the one card over gloo: flash-decoding over a
    4096-token cache split in two against ``decode_attention`` on one
    rank (the JAX test's 1e-5), with no window, h2o's 4096 and a 1000
    window; ``compressed_psum`` of two distinct shards (atol 0.05)."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.models.layers import decode_attention
    work = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, os.path.join(work, "store"), work))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        if p.is_alive():
            p.kill()
    results = []
    for r in range(2):
        path = os.path.join(work, f"rank{r}.json")
        results.append(json.load(open(path)) if os.path.exists(path)
                       else {"error": "no result"})
    emit(phase="dist", two_gloo_ranks_backend=[r.get("backend")
                                               for r in results],
         exitcodes=[p.exitcode for p in procs])
    ok = all(r.get("ok") for r in results)
    q, kc, vc, lengths = decode_inputs(torch)
    errs = {}
    for name, window in (("none", None), ("h2o_4096", 4096),
                         ("w1000", 1000)):
        want = decode_attention(q, kc, vc, lengths, window).cpu()
        for r in range(2):
            path = os.path.join(work, f"o_{name}_{r}.pt")
            if not os.path.exists(path):
                ok = False
                continue
            got = torch.load(path)
            errs[f"{name}_rank{r}"] = (got - want).abs().max().item()
            ok &= torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    check("dist", "two_gloo_ranks_flash_decoding_matches_one_rank", ok,
          max_abs_err=errs, errors=[r.get("error") for r in results])
    psum = [r.get("psum_max_abs_err") for r in results]
    check("dist", "two_gloo_ranks_compressed_psum_distinct_shards",
          all(e is not None and e <= 0.05 for e in psum),
          max_abs_err=psum)
    shutil.rmtree(work, ignore_errors=True)


def dist_dry_run(torch, dev) -> None:
    """The dry run on a fake world, on this host: qwen2-1.5b train_4k on
    the 16 x 16 mesh (extrapolated) and the multi-pod pass, then the
    one-card cell of the train phase's step (2 x 4096, bf16, remat
    "full") beside that step's measured time and peak."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.sharding import PolicyOptions
    keys = ("t_compute", "t_memory_fused", "t_collective", "dominant",
            "roofline_fraction", "collective_counts", "peak_bytes_per_dev",
            "compile_s", "t_step", "flops_per_dev")
    for multi in (False, True):
        _full, meta = lower_cell("qwen2-1.5b", "train_4k", multi_pod=multi,
                                 extrapolate=not multi)
        emit(phase="dist", dry_run=f"qwen2-1.5b|train_4k|{meta['mesh']}",
             chips=meta["chips"], **{k: meta[k] for k in keys})
        check("dist", f"dry_run_{meta['mesh']}_traced",
              meta["flops_per_dev"] > 0 and bool(meta["collective_counts"]))
    _full, meta = lower_cell(
        "qwen2-1.5b", "train_4k", batch_override=2, extrapolate=False,
        options=PolicyOptions(remat="full"),
        mesh=((1, 1), ("data", "model")))
    measured = MEASURED.get("qwen2_train")
    row = {k: meta[k] for k in keys}
    if measured is not None:
        step_ms, peak = measured
        row.update(measured_step_s=step_ms / 1e3, measured_peak_bytes=peak,
                   predicted_over_measured_step=meta["t_step"]
                   / (step_ms / 1e3),
                   predicted_over_measured_peak=meta["peak_bytes_per_dev"]
                   / peak)
    emit(phase="dist", dry_run="qwen2-1.5b|2x4096|1x1", card=card_line(),
         **row)
    check("dist", "dry_run_1x1_beside_the_measured_train_step",
          measured is not None and meta["peak_bytes_per_dev"] > 0)


def phase_dist(torch, dev, records):
    """Distribution: the sharded path on a one-rank NCCL world (flash and
    SSD on each rank's shards, a ZeRO-1 train step, compressed_psum),
    two gloo ranks on the card, and the fake-world dry run."""
    import dataclasses as dc
    from repro_torch import configs
    from repro_torch.launch import mesh as M
    import logging
    # DTensor warns at every two-axis all-reduce of a 1 x 1 mesh
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    emit(phase="dist", card=card_line())
    M.init_world("nccl", 1, 0)
    try:
        mesh = M.make_host_mesh()
        emit(phase="dist", backend=torch.distributed.get_backend(),
             mesh=str(mesh))
        for part, args in (
                (dist_prefill, (mesh, dc.replace(configs.get("qwen2-1.5b"),
                                                 attention_impl="flash"),
                                "flash_attention")),
                (dist_prefill, (mesh, configs.get("mamba2-2.7b"),
                                "ssd_scan", lambda p: fill_conv_bc(torch, p))),
                (dist_train, (mesh,)), (dist_compressed_psum, ())):
            t0 = time.perf_counter()
            with guarded("dist"):
                part(torch, dev, *args)
            emit(phase="dist", part=part.__name__,
                 seconds=round(time.perf_counter() - t0, 3))
    finally:
        M.destroy_world()
    for part in (dist_two_gloo_ranks, dist_dry_run):
        t0 = time.perf_counter()
        with guarded("dist"):
            part(torch, dev)
        emit(phase="dist", part=part.__name__,
             seconds=round(time.perf_counter() - t0, 3))


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
    # the trial forms: the same Pallas kernels under jax.vmap in an SER
    # campaign (src/repro/core/ser.py:315)
    "qgemm_trials": ("src/repro_torch/csrc/qgemm.cu",
                     "src/repro/kernels/qgemm.py:60"),
    "qconv2d_trials": ("src/repro_torch/csrc/qconv.cu",
                       "src/repro/kernels/qconv.py:493"),
    "qconv2d_into_trials": ("src/repro_torch/csrc/qconv.cu",
                            "src/repro/kernels/qconv.py:352"),
    "qdwconv2d_trials": ("src/repro_torch/csrc/qdwconv.cu",
                         "src/repro/kernels/qconv.py:654"),
    "qdwconv2d_into_trials": ("src/repro_torch/csrc/qdwconv.cu",
                              "src/repro/kernels/qconv.py:770"),
    "qgconv2d_trials": ("src/repro_torch/csrc/qconv.cu",
                        "src/repro/kernels/qconv.py:877"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:24"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:72"),
    # the JAX package's standalone pools were plain array ops
    "maxpool2d": ("src/repro_torch/csrc/pool.cu", None),
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
    # mobilenet_v2 runs after paths: run before it, on the H100, paths'
    # profiler traces lost their first kernel (ResNet-18's forward showed
    # 35 of 36, one FC call alone none) in two full runs; paths alone, or
    # right after mobilenet_v2 alone, saw every kernel
    for phase, fn in (("kernels", phase_kernels), ("vgg16", phase_vgg),
                      ("mobilenet", phase_mobilenet), ("paths", phase_paths),
                      ("mobilenet_v2", phase_mobilenet_v2),
                      ("resnext50_32x4d", phase_resnext50),
                      ("flow", phase_flow), ("resilience", phase_resilience),
                      ("lm", phase_lm),
                      ("ssm", phase_ssm), ("families", phase_families),
                      ("train", phase_train), ("dist", phase_dist)):
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
                            library_ms=r["library_ms"],
                            **r.get("extra", {})))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
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

"""Deterministic SEU-style fault injection for the int8 runtime.

The paper pitches FPGAs for "industrial and mission-critical scenarios"
(§1); the FPGA-toolflow surveys it builds on treat single-event-upset
behavior as a first-class property of a production toolflow.  This
module lets us *quantify* the int8 pipeline's resilience: a
:class:`FaultPlan` is a seedable, fully deterministic set of
:class:`Fault` records that corrupt a **built** program — the staged
int8 weights, int32 biases, per-lane shift vectors and requant scales
of a :class:`~.pipeline.QuantizedModel`, or the inter-stage
int8 activations the executor streams between kernels.

Fault classes:

  * ``weight_bit`` / ``bias_bit``   — one bit of a staged weight (int8)
    or bias (int32) word flips: configuration-RAM / weight-buffer SEU.
  * ``shift_lane``                  — one lane of a per-channel requant
    shift vector moves by ``delta``: a flipped shift-register bit.
  * ``scale``                       — a layer's output scale ``m_y``
    moves by ``delta`` (the whole requant shift is wrong): control-word
    SEU.
  * ``dropped_tile``                — a contiguous Cout slice of a
    staged weight reads back as zeros: a DMA'd tile never arrived.
  * ``activation_bit``              — one bit of a named inter-stage
    int8 activation flips in flight: line-buffer / DDR-word SEU.
  * ``activation_tile``             — a flat range of an inter-stage
    activation reads back as zeros: a lost burst.

Weight-side faults are applied host-side by :func:`inject`, which
returns a **new** corrupted :class:`QuantizedModel` (the pristine model
is never mutated — it is the golden image the guard's degradation
policy rebuilds from).  The corrupted weight goes back to the model's
device together with the copies the kernels actually read, staged anew
from it: the K-major ``w_k`` of the wgmma conv and GEMM kernels and a
per-channel spec's ``shift_vec`` (a fault that only reached ``w_q``
would change the plain versions and leave the kernels' output alone).
Activation faults are handed to ``pipeline.make_executor(faults=...)``
and applied to the stage outputs as the executor runs.

:func:`trial_weights` builds a campaign chunk's weight images at once,
on the device: each trial's image of a stage is the golden weight with
that trial's plan applied, equal to :func:`inject`'s.

Everything is derived from ``np.random.default_rng(seed)``: the same
seed over the same model yields the same plan, byte for byte — the
property the SER campaigns and the determinism tests rely on (and the
same plan as the JAX package's for the same seed over the same model).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import qconv
from . import pipeline as pipe
from .quantize import MAX_SHIFT, QuantSpec

WEIGHT_BIT = "weight_bit"
BIAS_BIT = "bias_bit"
SHIFT_LANE = "shift_lane"
SCALE = "scale"
DROPPED_TILE = "dropped_tile"
ACTIVATION_BIT = "activation_bit"
ACTIVATION_TILE = "activation_tile"

#: Fault classes applied to the staged program (host-side, inject()).
PROGRAM_KINDS = (WEIGHT_BIT, BIAS_BIT, SHIFT_LANE, SCALE, DROPPED_TILE)
#: Fault classes applied to inter-stage tensors (by the executor).
ACTIVATION_KINDS = (ACTIVATION_BIT, ACTIVATION_TILE)
ALL_KINDS = PROGRAM_KINDS + ACTIVATION_KINDS


@dataclasses.dataclass(frozen=True)
class Fault:
    """One SEU event.  ``stage`` names the pipeline stage (LayerInfo
    name); activation faults additionally carry the ``tensor`` they
    corrupt (the stage's output tensor when sampled)."""

    kind: str
    stage: str
    index: int = 0          # flat element index (weight/bias/activation)
    bit: int = 0            # bit position for *_bit kinds
    lane: int = 0           # Cout lane for shift_lane
    delta: int = 1          # exponent perturbation for shift_lane/scale
    tile: Tuple[int, int] = (0, 0)  # [start, stop) for *_tile kinds
    tensor: str = ""        # activation faults: target tensor name


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic set of faults (optionally tagged with the seed
    that sampled it, for reports)."""

    faults: Tuple[Fault, ...]
    seed: Optional[int] = None

    def __len__(self) -> int:
        return len(self.faults)

    @property
    def program_faults(self) -> Tuple[Fault, ...]:
        return tuple(f for f in self.faults if f.kind in PROGRAM_KINDS)

    @classmethod
    def sample(cls, qm: pipe.QuantizedModel, n: int,
               kinds: Sequence[str] = (WEIGHT_BIT,), seed: int = 0,
               bits: Sequence[int] = tuple(range(8))) -> "FaultPlan":
        """Draw ``n`` faults of the given kinds against the built
        program.  Deterministic in ``(qm structure, n, kinds, seed,
        bits)``; the same seed always produces the same plan."""
        for k in kinds:
            if k not in ALL_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = np.random.default_rng(seed)
        weighted = [ql for ql in qm.layers if ql.w_q is not None]
        biased = [ql for ql in weighted if ql.b_q is not None]
        per_chan = [ql for ql in weighted
                    if ql.spec is not None and ql.spec.per_channel]
        faults: List[Fault] = []
        for _ in range(n):
            kind = str(rng.choice(list(kinds)))
            if kind in (WEIGHT_BIT, DROPPED_TILE, SCALE):
                pool = weighted
            elif kind == BIAS_BIT:
                pool = biased
            elif kind == SHIFT_LANE:
                pool = per_chan
            else:  # activation faults target any stage output
                pool = list(qm.layers)
            if not pool:
                raise ValueError(
                    f"no eligible stage for fault kind {kind!r}")
            ql = pool[int(rng.integers(len(pool)))]
            li = ql.info
            if kind == WEIGHT_BIT:
                f = Fault(kind, li.name,
                          index=int(rng.integers(ql.w_q.numel())),
                          bit=int(rng.choice(list(bits))))
            elif kind == BIAS_BIT:
                f = Fault(kind, li.name,
                          index=int(rng.integers(ql.b_q.numel())),
                          bit=int(rng.integers(32)))
            elif kind == SHIFT_LANE:
                f = Fault(kind, li.name,
                          lane=int(rng.integers(len(ql.spec.m_w))),
                          delta=int(rng.choice([-2, -1, 1, 2])))
            elif kind == SCALE:
                f = Fault(kind, li.name,
                          delta=int(rng.choice([1, 2])))
            elif kind == DROPPED_TILE:
                cout = int(ql.w_q.shape[-1])
                width = int(rng.integers(1, max(2, cout // 4 + 1)))
                start = int(rng.integers(max(1, cout - width + 1)))
                f = Fault(kind, li.name, tile=(start, start + width))
            else:
                size = int(np.prod(li.out_shape))
                if kind == ACTIVATION_BIT:
                    f = Fault(kind, li.name,
                              index=int(rng.integers(size)),
                              bit=int(rng.choice(list(bits))),
                              tensor=li.output)
                else:
                    width = max(1, size // 64)
                    start = int(rng.integers(max(1, size - width + 1)))
                    f = Fault(kind, li.name, tile=(start, start + width),
                              tensor=li.output)
            faults.append(f)
        return cls(tuple(faults), seed=seed)

    # ------------------------------------------------- executor payload
    def activation_faults(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Per-tensor payload for ``pipeline.make_executor(faults=...)``:
        XOR masks for bit flips and flat index ranges to zero for
        dropped tiles, keyed by the tensor each fault targets."""
        xor: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        zero: Dict[str, List[int]] = defaultdict(list)
        for f in self.faults:
            if f.kind not in ACTIVATION_KINDS:
                continue
            if not f.tensor:
                raise ValueError(
                    f"activation fault on stage {f.stage!r} names no "
                    "tensor (set Fault.tensor)")
            if f.kind == ACTIVATION_BIT:
                mask = int(np.array(1 << (f.bit % 8), np.uint8)
                           .astype(np.int8))
                xor[f.tensor].append((f.index, mask))
            else:
                zero[f.tensor].extend(range(f.tile[0], f.tile[1]))
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for t in set(xor) | set(zero):
            entry: Dict[str, np.ndarray] = {}
            if xor.get(t):
                entry["xor_idx"] = np.asarray([i for i, _ in xor[t]],
                                              np.int32)
                entry["xor_mask"] = np.asarray([m for _, m in xor[t]],
                                               np.int8)
            if zero.get(t):
                entry["zero_idx"] = np.asarray(sorted(set(zero[t])),
                                               np.int32)
            out[t] = entry
        return out


# ------------------------------------------------------------ injection

def _flip_bit(arr: np.ndarray, index: int, bit: int) -> None:
    """Flip one bit of one element, in place, via an unsigned view
    (XOR on the signed dtype would overflow at the sign bit)."""
    flat = arr.reshape(-1)
    u = flat.view(np.uint8 if arr.dtype == np.int8 else np.uint32)
    u[index % flat.size] ^= np.asarray(
        1 << (bit % (8 * arr.dtype.itemsize)), u.dtype)


def _corrupt_scale(spec: QuantSpec, delta: int) -> QuantSpec:
    """Move the output scale ``m_y`` by ±delta — whichever direction
    keeps the requant shift representable (the fault must build)."""
    for d in (-abs(delta), abs(delta)):
        cand = dataclasses.replace(spec, m_y=spec.m_y + d)
        try:
            cand.requant_shift
        except ValueError:
            continue
        return cand
    return spec  # no representable corruption: leave untouched


def _corrupt_lane(spec: QuantSpec, lane: int, delta: int) -> QuantSpec:
    """Perturb one lane of a per-channel shift vector, clamped so the
    corrupted program still satisfies the datapath's 0..MAX_SHIFT
    range (an unrepresentable shift would refuse to build — the fault
    model is a wrong-but-running configuration)."""
    if not spec.per_channel:
        raise ValueError("shift_lane fault needs a per-channel spec")
    mw = list(spec.m_w)
    lane %= len(mw)
    lo = spec.m_y - spec.m_x                       # shift >= 0
    hi = MAX_SHIFT + spec.m_y - spec.m_x           # shift <= MAX_SHIFT
    for d in (delta, -delta):
        cand = int(np.clip(mw[lane] + d, lo, hi))
        if cand != mw[lane]:
            mw[lane] = cand
            return dataclasses.replace(spec, m_w=tuple(mw))
    return spec


def inject(qm: pipe.QuantizedModel, plan: FaultPlan) -> pipe.QuantizedModel:
    """Apply a plan's program-side faults, returning a **new** corrupted
    :class:`QuantizedModel` (fresh executor cache; the input model and
    its staged tensors are untouched — it stays the golden image).  A
    corrupted layer's ``w_k`` and ``shift_vec`` are staged anew from its
    corrupted ``w_q`` and spec.  Activation faults are not applied here;
    pass ``plan.activation_faults()`` to ``make_executor(faults=...)``."""
    by_stage: Dict[str, List[Fault]] = defaultdict(list)
    for f in plan.program_faults:
        by_stage[f.stage].append(f)
    unknown = set(by_stage) - {ql.info.name for ql in qm.layers}
    if unknown:
        raise KeyError(f"fault plan names unknown stages: {sorted(unknown)}")
    layers: List[pipe.QuantizedLayer] = []
    for ql in qm.layers:
        fs = by_stage.get(ql.info.name)
        if not fs:
            layers.append(ql)
            continue
        w = ql.w_q.cpu().numpy().copy() if ql.w_q is not None else None
        b = ql.b_q.cpu().numpy().copy() if ql.b_q is not None else None
        spec = ql.spec
        for f in fs:
            if f.kind == WEIGHT_BIT:
                if w is None:
                    raise ValueError(f"stage {f.stage!r} has no weights")
                _flip_bit(w, f.index, f.bit)
            elif f.kind == BIAS_BIT:
                if b is None:
                    raise ValueError(f"stage {f.stage!r} has no bias")
                _flip_bit(b, f.index, f.bit)
            elif f.kind == DROPPED_TILE:
                if w is None:
                    raise ValueError(f"stage {f.stage!r} has no weights")
                cout = w.shape[-1]
                t0 = min(max(f.tile[0], 0), cout)
                t1 = min(max(f.tile[1], t0), cout)
                w[..., t0:t1] = 0
            elif f.kind == SHIFT_LANE:
                spec = _corrupt_lane(spec, f.lane, f.delta)
            elif f.kind == SCALE:
                spec = _corrupt_scale(spec, f.delta)
        w_q = torch.from_numpy(w).to(qm.device) if w is not None else None
        layers.append(dataclasses.replace(
            ql, w_q=w_q,
            b_q=torch.from_numpy(b).to(qm.device) if b is not None else None,
            spec=spec,
            w_k=pipe.stage_kmajor(ql.info, w_q) if w_q is not None else None,
            shift_vec=(pipe.stage_shift_vec(w_q, spec) if w_q is not None
                       else None)))
    return pipe.QuantizedModel(
        name=qm.name, layers=layers, input_m=qm.input_m,
        output_m=qm.output_m, parsed=qm.parsed, device=qm.device)


def trial_weights(qm: pipe.QuantizedModel, plans: Sequence[FaultPlan],
                  names: Sequence[str]
                  ) -> Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """The weight images of a batch of trials, built on the model's
    device: ``{stage: (w_q, w_k)}`` for each stage in ``names``, ``w_q``
    a (T, ...) int8 stack whose image t is the golden ``w_q`` with
    ``plans[t]``'s faults on that stage applied, equal to ``inject(qm,
    plans[t])``'s ``w_q``, and ``w_k`` the stack of the K-major copies
    the kernels read, equal to ``inject``'s ``w_k`` (None for a
    depthwise conv, whose kernel reads ``w_q``).  Both start as copies of
    the build's staged weights, then each plan's dropped tiles are zeroed
    (a column range of ``w_q``, a row range of ``w_k``) and its bit flips
    XORed in by one scatter a stack, in ``w_k`` at the places the
    staging puts each element (:func:`qconv.kmajor_position`, which
    packs a grouped conv's narrow groups): no stack is transposed.  Only the
    kinds that change nothing but a weight image (weight bits, dropped
    tiles) can be batched so: every image shares the stage's bias, spec
    and ``shift_vec``.  Plans apply their faults in order, as
    :func:`inject` does: a tile dropped after a flip in its columns
    erases the flip."""
    by_name = {ql.info.name: ql for ql in qm.layers}
    unknown = set(names) - {n for n, ql in by_name.items()
                            if ql.w_q is not None}
    if unknown:
        raise KeyError(f"no staged weight for stages {sorted(unknown)}")
    trials = len(plans)
    out: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}
    for name in names:
        ql = by_name[name]
        size, cout = ql.w_q.numel(), int(ql.w_q.shape[-1])
        tiles: List[Tuple[int, int, int]] = []   # (trial, start, stop)
        flips: Dict[Tuple[int, int], int] = {}   # (trial, flat) -> bits
        for t, plan in enumerate(plans):
            for f in plan.program_faults:
                if f.stage != name:
                    continue
                if f.kind == WEIGHT_BIT:
                    key = (t, f.index % size)
                    flips[key] = flips.get(key, 0) ^ (1 << (f.bit % 8))
                elif f.kind == DROPPED_TILE:
                    t0 = min(max(f.tile[0], 0), cout)
                    t1 = min(max(f.tile[1], t0), cout)
                    tiles.append((t, t0, t1))
                    for key in [k for k in flips if k[0] == t
                                and t0 <= k[1] % cout < t1]:
                        del flips[key]
                else:
                    raise ValueError(
                        f"a {f.kind!r} fault changes more than the weight "
                        f"image of {name!r}: use inject() for its program")
        w = torch.stack([ql.w_q] * trials)
        wk = None if ql.w_k is None else torch.stack([ql.w_k] * trials)
        for t, t0, t1 in tiles:
            w[t, ..., t0:t1] = 0
            if wk is not None:
                wk[t, t0:t1] = 0
        flips = {k: m for k, m in flips.items() if m}
        if flips:
            dev = w.device
            rows = torch.as_tensor([t for t, _e in flips], device=dev)
            flat_ix = np.asarray([e for _t, e in flips], np.int64)
            bits = torch.as_tensor(
                np.asarray(list(flips.values()), np.uint8).astype(np.int8),
                device=dev)
            flat = w.view(trials, -1)
            cols = torch.as_tensor(flat_ix, device=dev)
            flat[rows, cols] = torch.bitwise_xor(flat[rows, cols], bits)
            if wk is not None:   # where the staging put each element
                nn, kk = qconv.kmajor_position(
                    cols, ql.w_q.shape[-2], cout, ql.info.group)
                wk[rows, nn, kk] = torch.bitwise_xor(wk[rows, nn, kk], bits)
        out[name] = (w, wk)
    return out

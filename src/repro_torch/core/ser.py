"""SER (soft-error-rate) campaigns + selective hardening.

A campaign pushes many sampled :class:`~.faults.FaultPlan` trials —
weight-bit flips, dropped tiles, in-flight activation flips — through
ONE executor: ``make_executor``'s ``weight_args``/``fault_args`` hooks
make the staged weights and the activation-fault payload *call-time
arguments*, so no trial rebuilds a program, and the executor's trial
form (``pipeline.vmap_trials``, the counterpart of the JAX package's
``jax.vmap(_call, in_axes=(None, 0, 0))``) runs a whole chunk of trials
in one call: every stage with a trial's weight launches its kernel's
trial form once for the chunk, each trial reading its own weight image
(``faults.trial_weights`` builds them on the device).  A zero XOR mask
is the no-op padding slot of a fixed-shape payload.

Per trial the campaign classifies the upset against the golden run on
the same input (the audit envelope is the golden run's own stats, the
guard's zero-slack configuration):

  * ``detected`` — at least one audited stage left its envelope;
  * ``masked``   — undetected and the output is bit-identical to
                   golden (the flip died inside the datapath);
  * ``silent``   — undetected and the output differs: the outcome a
                   mission-critical deployment must drive to zero.

Detected trials are then pushed through the recovery path: localize
(earliest flagged stage), group by nearest upstream checkpoint, and
replay each group's snapshots through the trial form of the golden
program's cached ``replay_from`` executor, one call a group.  A replay
whose stats re-flag (snapshot poisoned by an un-audited upstream upset)
counts as ``escalated`` — the ladder's full golden reexecution recovers
it, at full-depth cost.

Rates carry Wilson score confidence intervals — at the campaign sizes
CI bounds matter more than point estimates (3/3 detected says almost
nothing; 100/100 pins the rate above 0.96).

**Selective hardening** (:func:`derive_guard_policy`): the per-stage
audit is the guard's runtime cost, but most stages' upsets are either
masked or visible downstream.  From the campaign's trial records the
minimal audit set is a set-cover problem — choose the fewest stages
whose flagged sets cover every output-reaching trial — solved greedily
(ln-approximation, exact at these sizes), and emitted as a
ready-to-deploy :class:`~.guard.GuardPolicy` with ``audit_stages``
pinned.  The derivation refuses to harden a configuration with observed
silent corruptions: no audit subset can cover what no audit saw.

Records, counts, intervals and the derived policy equal the JAX
package's for the same model, input and seed.

    PYTHONPATH=src python -m repro_torch.core.ser --model resnet_tiny \
        --trials 64 --assert-silent [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import faults as F
from . import pipeline as pipe
from . import resources as R

#: Fault kinds a campaign can pass through one executor: kinds that only
#: move int8 payload (weights or activation XOR masks).  Spec-mutating
#: kinds (scale/shift-lane) change the requant constants the program was
#: built with and need a program of their own.
CAMPAIGN_KINDS = (F.WEIGHT_BIT, F.DROPPED_TILE, F.ACTIVATION_BIT)

SCHEMA_VERSION = 1


def wilson(k: int, n: int, z: float = 1.96) -> Tuple[float, float]:
    """Wilson score interval for a binomial rate ``k/n`` (95% default).
    Well-behaved at the boundaries (k=0, k=n) where the normal
    approximation collapses — exactly where SER campaigns live."""
    if n <= 0:
        return (0.0, 1.0)
    p = k / n
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z2 / (4 * n * n)) / denom
    return (max(0.0, center - half), min(1.0, center + half))


def _rate(k: int, n: int) -> Dict[str, float]:
    lo, hi = wilson(k, n)
    return {"count": k, "p": (k / n if n else 0.0), "lo": lo, "hi": hi}


@dataclasses.dataclass
class TrialRecord:
    """One sampled fault plan pushed through the campaign executor."""

    plan: F.FaultPlan
    stages: Tuple[str, ...]      # stages the plan faulted
    flagged: Tuple[str, ...]     # audited stages out of envelope
    outcome: str                 # detected | masked | silent
    output_differs: bool
    recovered: bool = False
    escalated: bool = False      # checkpoint replay unavailable/re-flagged
    replayed: int = 0            # stages re-run by the recovery path


@dataclasses.dataclass
class Campaign:
    """One campaign's trial records + aggregation helpers."""

    model: str
    flips: int
    kinds: Tuple[str, ...]
    seed: int
    boundaries: Tuple[int, ...]
    boundary_names: Tuple[str, ...]
    n_stages: int
    records: List[TrialRecord]

    @property
    def trials(self) -> int:
        return len(self.records)

    def counts(self) -> Dict[str, int]:
        c = {"detected": 0, "masked": 0, "silent": 0, "recovered": 0,
             "recovered_by_replay": 0, "escalated": 0}
        for r in self.records:
            c[r.outcome] += 1
            c["recovered"] += int(r.recovered)
            c["recovered_by_replay"] += int(r.recovered and not r.escalated
                                            and r.outcome == "detected")
            c["escalated"] += int(r.escalated)
        return c

    def stage_rates(self) -> Dict[str, Dict]:
        """Per-stage architectural-vulnerability table: of the trials
        that faulted a stage, how many were detected / masked / silent,
        and how many *reached the output* (the AVF estimate selective
        hardening keys on).  Multi-fault trials count under every stage
        they touched."""
        per: Dict[str, Dict[str, int]] = {}
        for r in self.records:
            for s in set(r.stages):
                d = per.setdefault(s, {"trials": 0, "detected": 0,
                                       "masked": 0, "silent": 0,
                                       "reached_output": 0})
                d["trials"] += 1
                d[r.outcome] += 1
                d["reached_output"] += int(r.output_differs)
        out: Dict[str, Dict] = {}
        for s, d in sorted(per.items()):
            n = d["trials"]
            out[s] = {
                "trials": n,
                "detected": _rate(d["detected"], n),
                "masked": _rate(d["masked"], n),
                "silent": _rate(d["silent"], n),
                "avf": _rate(d["reached_output"], n),
            }
        return out

    def summary(self) -> Dict:
        n = self.trials
        c = self.counts()
        replayed = [r.replayed for r in self.records
                    if r.outcome == "detected" and not r.escalated]
        return {
            "version": SCHEMA_VERSION,
            "model": self.model,
            "flips": self.flips,
            "trials": n,
            "kinds": list(self.kinds),
            "seed": self.seed,
            "checkpoints": {"boundaries": list(self.boundaries),
                            "stages": list(self.boundary_names)},
            "counts": c,
            "rates": {k: _rate(c[k], n)
                      for k in ("detected", "masked", "silent",
                                "recovered")},
            "mean_replayed_stages": (float(np.mean(replayed))
                                     if replayed else 0.0),
            "n_stages": self.n_stages,
            "per_stage": self.stage_rates(),
        }


# -------------------------------------------------------- the campaign

def _trial_payload(plan: F.FaultPlan, tensors: Sequence[str],
                   slots: int) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Fixed-shape ``(idx, mask)`` XOR payload per fault-arg tensor.
    Unused slots keep ``mask == 0`` — a no-op — so every trial's payload
    has the same shapes."""
    per: Dict[str, List[Tuple[int, int]]] = {t: [] for t in tensors}
    for f in plan.faults:
        if f.kind != F.ACTIVATION_BIT:
            continue
        mask = int(np.array(1 << (f.bit % 8), np.uint8).astype(np.int8))
        per[f.tensor].append((f.index, mask))
    out = {}
    for t in tensors:
        idx = np.zeros(slots, np.int32)
        msk = np.zeros(slots, np.int8)
        merged: Dict[int, int] = {}
        for i, m in per[t]:  # two flips on one element XOR-combine
            merged[i] = merged.get(i, 0) ^ m
        for s, (i, m) in enumerate(list(merged.items())[:slots]):
            idx[s], msk[s] = i, m
        out[t] = (idx, msk)
    return out


def _flag_matrix(stats: Dict[str, np.ndarray],
                 golden: Dict[str, np.ndarray],
                 order: Sequence[str],
                 margin: float, sat_tol: float) -> np.ndarray:
    """(trials, stages) bool: audited stat rows outside the golden
    envelope, the guard's rules vectorized.  The dequant scale ``2^-m``
    multiplies both sides of the max/mean comparisons and the
    saturation fraction is scale-free, so the raw int8 stats compare
    directly."""
    cols = []
    for t in order:
        g = np.asarray(golden[t], np.float64)          # (3,)
        s = np.asarray(stats[t], np.float64)           # (T, 3)
        sat = s[:, 0] > g[0] + sat_tol
        mx = s[:, 1] > g[1] * (1.0 + margin)
        mean = (s[:, 2] > g[2] * (1.0 + margin)) | \
               (s[:, 2] * (1.0 + margin) < g[2])
        cols.append(sat | mx | mean)
    return np.stack(cols, axis=1)


def _read_back(ys: torch.Tensor, stats: Dict[str, torch.Tensor],
               order: Sequence[str], y0: torch.Tensor):
    """A trial-batched call's results on the host, in one copy: the
    audited stats as ``{tensor: (T, 3)}`` over ``order`` and, per trial,
    whether its output ``ys[t]`` differs from ``y0``."""
    trials = ys.shape[0]
    diff = (ys != y0).reshape(trials, -1).any(1).to(torch.float32)
    st = torch.stack([stats[t] for t in order], dim=1).reshape(trials, -1)
    host = torch.cat([st, diff[:, None]], dim=1).cpu().numpy()
    return ({t: host[:, 3 * j:3 * j + 3] for j, t in enumerate(order)},
            host[:, -1] != 0)


def run_campaign(gate, x, *, trials: int = 100, flips: int = 1,
                 kinds: Sequence[str] = (F.WEIGHT_BIT,), seed: int = 0,
                 margin: float = 0.0, sat_tol: float = 0.0,
                 checkpoints: int = 2, chunk: int = 32,
                 n_i: int = 16, n_l: int = 32,
                 block_h: Optional[int] = None) -> Campaign:
    """Run one SER campaign: ``trials`` sampled ``flips``-fault plans
    through a single executor on the gate's device, one call a chunk.

    ``gate`` is a calibrated :class:`~.synthesis.CNN2Gate`; ``x`` the
    (float, NCHW) input the golden reference and every trial share.
    ``checkpoints`` arms the recovery path with the equal-cumulative-MAC
    plan (0 = every detected trial escalates to full reexecution).
    ``chunk`` bounds the trials of one call (memory, not correctness):
    each touched stage holds ``chunk`` weight images and their K-major
    copies.
    """
    for k in kinds:
        if k not in CAMPAIGN_KINDS:
            raise ValueError(
                f"kind {k!r} cannot be vectorized (campaign kinds: "
                f"{CAMPAIGN_KINDS}); spec-mutating kinds need a program "
                "of their own — use GuardedExecutor.with_program for those")
    qm = gate.quantized
    parsed = gate.parsed
    stages = qm.layers
    stage_names = [ql.info.name for ql in stages]
    stage_idx = {n: i for i, n in enumerate(stage_names)}

    # sample every trial up front: the union of touched stages/tensors
    # fixes the executor's argument signature for the whole campaign
    plans = [F.FaultPlan.sample(qm, flips, kinds=kinds,
                                seed=seed + 17 * t)
             for t in range(trials)]
    w_touched = sorted({f.stage for p in plans for f in p.program_faults})
    a_touched = sorted({f.tensor for p in plans for f in p.faults
                        if f.kind == F.ACTIVATION_BIT})
    slots = max([sum(1 for f in p.faults if f.kind == F.ACTIVATION_BIT)
                 for p in plans] + [1])

    boundaries = R.plan_checkpoints(parsed, checkpoints)
    bnames = tuple(stage_names[b] for b in boundaries)

    ex = pipe.make_executor(qm, n_i=n_i, n_l=n_l, block_h=block_h,
                            audit=True, checkpoints=boundaries or None,
                            weight_args=tuple(w_touched),
                            fault_args=tuple(a_touched))

    def _call(fn, xv, w, p):
        extra = []
        if w_touched:
            extra.append(w)
        if a_touched:
            extra.append(p)
        res = fn(xv, *extra)
        return res[0], res[1], (res[2] if boundaries else {})

    xt = torch.as_tensor(x, dtype=torch.float32, device=qm.device)
    # golden reference: golden weights + all-zero payload through the
    # SAME executor (also validates the no-op path end to end)
    gold_w = {n: next((ql.w_q, ql.w_k) for ql in stages
                      if ql.info.name == n)
              for n in w_touched}
    nop = {t: (np.zeros(slots, np.int32), np.zeros(slots, np.int8))
           for t in a_touched}
    y0, stats0, _ = _call(ex, xt, gold_w, nop)
    stats0 = pipe.stats_to_host(stats0)
    # the audited tensors in sorted name order: the order the JAX
    # package's jitted closure returns its stats dict in (pytree keys),
    # which orders each record's ``flagged``
    audited = sorted(stats0)
    t2s = {ql.info.output: ql.info.name for ql in stages}

    # weights/payload dicts are always passed (possibly empty — _call
    # drops what the executor was not built to take)
    vex = pipe.vmap_trials(ex)

    records: List[TrialRecord] = []
    replay_ex: Dict[int, Callable] = {}
    for lo in range(0, trials, chunk):
        batch = plans[lo:lo + chunk]
        bw = F.trial_weights(qm, batch, w_touched)
        pays = [_trial_payload(p, a_touched, slots) for p in batch]
        bp = {t: (np.stack([pp[t][0] for pp in pays]),
                  np.stack([pp[t][1] for pp in pays]))
              for t in a_touched}
        ys, sts, ckpts = _call(vex, xt, bw, bp)
        del bw   # the chunk's weight stacks go before its replays run
        sts, diff = _read_back(ys, sts, audited, y0)
        flags = _flag_matrix(sts, stats0, audited, margin, sat_tol)
        chunk_recs: List[TrialRecord] = []
        for i, p in enumerate(batch):
            flagged = tuple(t2s[t] for t, hit in zip(audited, flags[i])
                            if hit and t in t2s)
            outcome = ("detected" if flagged
                       else ("masked" if not diff[i] else "silent"))
            chunk_recs.append(TrialRecord(
                plan=p,
                stages=tuple(dict.fromkeys(f.stage for f in p.faults)),
                flagged=flagged, outcome=outcome,
                output_differs=bool(diff[i])))

        # ---- recovery for the detected trials ------------------------
        by_boundary: Dict[Optional[int], List[int]] = {}
        for i, r in enumerate(chunk_recs):
            if r.outcome != "detected":
                continue
            first = min(stage_idx[s] for s in r.flagged)
            cands = [b for b in boundaries if b < first]
            by_boundary.setdefault(max(cands) if cands else None,
                                   []).append(i)
        for b, idxs in by_boundary.items():
            if b is None:  # no upstream snapshot: full golden reexec
                for i in idxs:
                    chunk_recs[i].recovered = True
                    chunk_recs[i].escalated = True
                    chunk_recs[i].replayed = len(stages)
                continue
            if b not in replay_ex:
                replay_ex[b] = pipe.vmap_trials(pipe.make_executor(
                    qm, n_i=n_i, n_l=n_l, block_h=block_h, audit=True,
                    replay_from=b))
            sel = torch.as_tensor(idxs, device=qm.device)
            env = {t: a[sel] for t, a in ckpts[stage_names[b]].items()}
            yr, str_ = replay_ex[b](env)
            order = list(str_)
            str_, rdiff = _read_back(yr, str_, order, y0)
            rf = _flag_matrix(str_, stats0, order, margin, sat_tol)
            for j, i in enumerate(idxs):
                clean = (not rf[j].any()) and not rdiff[j]
                chunk_recs[i].recovered = True  # escalation recovers too
                chunk_recs[i].escalated = not clean
                chunk_recs[i].replayed = (len(stages) if not clean
                                          else len(stages) - (b + 1))
        records.extend(chunk_recs)

    return Campaign(model=parsed.name, flips=flips, kinds=tuple(kinds),
                    seed=seed, boundaries=boundaries,
                    boundary_names=bnames, n_stages=len(stages),
                    records=records)


# ------------------------------------------------- selective hardening

def derive_guard_policy(campaigns: Sequence[Campaign], parsed,
                        margin: float = 0.0, sat_tol: float = 0.0,
                        checkpoint_replay: bool = True):
    """Derive a selectively-hardened :class:`GuardPolicy` from campaign
    evidence: the minimal audit-stage set (greedy set cover) whose
    flagged sets cover every trial whose upset reached the output.

    The output stage is always audited (the guard certifies final
    outputs against its envelope).  Raises if any campaign observed a
    silent corruption — an audit subset derived from evidence that
    already misses upsets would launder the miss into policy."""
    from .guard import GuardPolicy

    silent = sum(c.counts()["silent"] for c in campaigns)
    if silent:
        raise ValueError(
            f"{silent} silent corruption(s) observed: no audit subset "
            "covers an upset no audit saw — fix detection first")
    out_stage = parsed.layers[-1].name
    need = [set(r.flagged) for c in campaigns for r in c.records
            if r.output_differs]
    chosen = {out_stage}
    uncovered = [s for s in need if not (s & chosen)]
    order = {li.name: i for i, li in enumerate(parsed.layers)}
    while uncovered:
        gain: Dict[str, int] = {}
        for s in uncovered:
            for st in s:
                gain[st] = gain.get(st, 0) + 1
        best = max(gain, key=lambda st: (gain[st], -order[st]))
        chosen.add(best)
        uncovered = [s for s in uncovered if best not in s]
    sel = tuple(sorted(chosen, key=lambda st: order[st]))
    return GuardPolicy(margin=margin, sat_tol=sat_tol,
                       checkpoint_replay=checkpoint_replay,
                       audit_stages=sel)


# --------------------------------------------------------------- CLI

_MODELS = ("resnet_tiny", "googlenet_tiny", "tiny_cnn", "tiny_cnn_gap",
           "mobilenet_tiny", "squeezenet_tiny")


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(
        description="SEU soft-error-rate campaign over the int8 executor")
    ap.add_argument("--model", default="resnet_tiny", choices=_MODELS)
    ap.add_argument("--trials", type=int, default=100)
    ap.add_argument("--flips", default="1",
                    help="comma-separated fault counts per trial")
    ap.add_argument("--kinds", default=F.WEIGHT_BIT,
                    help=f"comma-separated subset of {CAMPAIGN_KINDS}")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoints", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--out", default=None, help="write campaign JSON")
    ap.add_argument("--derive-policy", action="store_true",
                    help="emit the selective-hardening audit set")
    ap.add_argument("--assert-silent", action="store_true",
                    help="exit non-zero if any trial was silent "
                         "(undetected AND output-corrupting) — the CI "
                         "gate")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    from repro_torch.models import cnn

    from .synthesis import CNN2Gate

    graph = getattr(cnn, args.model)(batch=1)
    gate = CNN2Gate.from_graph(graph, device=args.device)
    rng = np.random.default_rng(args.seed)
    shape = gate.parsed.input_shape
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    gate.calibrate_quantization(x)

    kinds = tuple(k.strip() for k in args.kinds.split(",") if k.strip())
    campaigns = []
    for flips in (int(f) for f in args.flips.split(",")):
        c = run_campaign(gate, x, trials=args.trials, flips=flips,
                         kinds=kinds, seed=args.seed,
                         checkpoints=args.checkpoints, chunk=args.chunk)
        s = c.summary()
        cnt = s["counts"]
        print(f"[ser] {args.model} flips={flips} trials={c.trials}: "
              f"detected {cnt['detected']} masked {cnt['masked']} "
              f"silent {cnt['silent']} "
              f"(replay avg {s['mean_replayed_stages']:.1f}/"
              f"{s['n_stages']} stages)")
        campaigns.append(c)

    doc: Dict = {"version": SCHEMA_VERSION, "model": args.model,
                 "trials": args.trials, "seed": args.seed,
                 "kinds": list(kinds),
                 "campaigns": [c.summary() for c in campaigns]}
    if args.derive_policy:
        pol = derive_guard_policy(campaigns, gate.parsed)
        doc["derived_policy"] = {
            "audit_stages": list(pol.audit_stages),
            "n_audited": len(pol.audit_stages),
            "n_stages": len(gate.parsed.layers),
        }
        print(f"[ser] selective audit: {len(pol.audit_stages)}/"
              f"{len(gate.parsed.layers)} stages: "
              f"{list(pol.audit_stages)}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
        print(f"[ser] wrote {args.out}")
    if args.assert_silent:
        n_silent = sum(c.counts()["silent"] for c in campaigns)
        if n_silent:
            raise SystemExit(f"[ser] FAIL: {n_silent} silent "
                             "corruption(s) escaped the audit")
        print("[ser] silent == 0 across all campaigns")
    return doc


if __name__ == "__main__":
    main()

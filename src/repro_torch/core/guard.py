"""Guarded execution: per-stage audits + a declarative degradation
policy over the int8 runtime.

``make_executor(audit=True)`` makes the executor additionally return
per-stage int8 statistics (saturation fraction, max |value|, mean
|value| — computed on the device, three scalars per stage, exact
integer counts divided once; read back with one copy a run).  The guard
then performs a **host-side dequant audit**: each stage's stats are
scaled by the tensor's fixed-point position (``2^-m`` from
:func:`pipeline.thread_scales`) and compared against calibration-time
envelopes recorded from the *golden* program.  A stage outside its
envelope — saturating more than calibration ever saw, or with a mean
magnitude drifted past the margin — is flagged as a suspected upset.

Degradation ladder (in order; each rung audits its own output):

  0. ``checkpoint_replay``  — when the executor was built with
     stage-boundary checkpoints, localize the fault (the earliest
     flagged stage), take the nearest snapshot strictly upstream of it
     and replay only the downstream stages on the *golden* program.
     Bit-exact against full golden reexecution, at a cost bounded by
     the stages downstream of the fault instead of the network depth.
     A snapshot poisoned by an unflagged upstream upset re-flags on the
     replay's own audit and escalates.
  1. ``reexecute``          — run the same program again.  Recovers
     transient in-flight upsets (an SEU in a line buffer does not
     repeat); a persistent fault (corrupted staged weight) re-flags
     and escalates.
  2. ``fallback:unfused``   — rebuild from the golden graph + specs
     with ``fuse_skip=False, fuse_concat=False`` (the bit-exact
     standalone-merge program that always exists) and re-run: the
     corrupted staged image is abandoned for a freshly staged one.
  3. ``fallback:per_tensor`` — additionally degrade per-channel weight
     scales to per-tensor (``m_w := min(m_w)`` per layer, the max-abs
     rule's scalar answer).  Numerically coarser but structurally
     simpler — the last rung before giving up.  Skipped when the
     program is already per-tensor.

With guards *off* ``build_guarded`` returns the plain
``pipeline.make_executor`` closure — the same ops calls as ``build``.
Fallback programs and their envelopes are built lazily on first
escalation and cached, so a healthy guarded deployment pays only the
three-scalar audit.  Every program runs on the golden model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import parser as P
from . import pipeline as pipe
from . import telemetry as tele
from .quantize import QuantSpec


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Declarative degradation policy + audit tolerances.

    ``margin`` is the relative slack on the dequantized max/mean
    statistics (0.25 = 25% drift allowed); ``sat_tol`` is absolute
    slack on the saturation fraction.  Tight values (0.0) make the
    audit flag *any* deviation from the calibration run — what the
    deterministic fault-injection tests use."""

    margin: float = 0.25
    sat_tol: float = 0.02
    checkpoint_replay: bool = True
    retry: bool = True
    fallback_unfused: bool = True
    fallback_per_tensor: bool = True
    #: selective hardening: audit only these stages (by stage name;
    #: ``None`` audits every stage).  Derived from a SER campaign by
    #: :func:`.ser.derive_guard_policy` — the
    #: minimal stage set whose audits cover every observed
    #: output-reaching upset, closing most of the full-audit overhead.
    audit_stages: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class GuardEnvelope:
    """Calibration-time expected ranges, float (dequantized) domain:
    ``tensor -> (sat_frac, max_abs, mean_abs)``."""

    stats: Dict[str, Tuple[float, float, float]]


@dataclasses.dataclass
class StageAudit:
    """One stage's audited statistics vs. its envelope."""

    stage: str
    tensor: str
    sat: float
    max_abs: float
    mean_abs: float
    flagged: bool
    reasons: Tuple[str, ...] = ()


@dataclasses.dataclass
class ActionResult:
    """One degradation-ladder rung: which stages were still flagged
    after applying it (empty = the rung recovered the run).  The
    checkpoint-replay rung additionally records how many stages it
    re-ran (``replayed``) and from which snapshot (``boundary``)."""

    action: str
    flagged: List[str]
    replayed: Optional[int] = None
    boundary: Optional[str] = None


@dataclasses.dataclass
class GuardReport:
    """Structured outcome of one guarded inference."""

    flagged: List[str]          # stages flagged on the primary run
    audits: List[StageAudit]    # primary-run audit detail
    actions: List[ActionResult]
    recovered_by: Optional[str]
    degraded: bool              # served from a fallback program
    ok: bool                    # final output passed its audit

    @property
    def detected(self) -> bool:
        return bool(self.flagged)

    @property
    def outcome(self) -> str:
        """One-word outcome for deployment counters (launch/serve.py):
        ``clean`` (no flags), ``checkpoint_replayed`` / ``reexecuted``
        / ``fell_back`` (which ladder rung recovered), ``unrecovered``
        (every rung exhausted still out of envelope).  Upsets the audit
        never sees are *masked* — invisible here by definition; their
        rate is what the offline SER campaign (core/ser.py) measures."""
        if not self.detected:
            return "clean"
        if not self.ok:
            return "unrecovered"
        if self.recovered_by == "checkpoint_replay":
            return "checkpoint_replayed"
        if self.recovered_by == "reexecute":
            return "reexecuted"
        return "fell_back"


@dataclasses.dataclass
class _Level:
    """One executable program level: the quantized program, its audited
    executor, per-tensor fixed-point positions and the calibration
    envelope recorded from it."""

    qm: pipe.QuantizedModel
    ex: Callable
    tensor_m: Dict[str, int]
    envelope: GuardEnvelope


def _scalar_specs(specs: Dict[str, QuantSpec]) -> Dict[str, QuantSpec]:
    """Degrade per-channel specs to per-tensor: every lane quantizes at
    the minimum lane exponent (the scalar max-abs answer — the lane
    with the largest weights already pinned it)."""
    return {name: (dataclasses.replace(s, m_w=s.m_w_min)
                   if s.per_channel else s)
            for name, s in specs.items()}


class GuardedExecutor:
    """Audited executor + degradation ladder over a built program.

    ``gate`` is the golden source of truth (a
    :class:`~.synthesis.CNN2Gate` with quantization applied):
    fallback programs are rebuilt from its graph and specs, exactly as
    an FPGA would reconfigure from the golden image in flash.  ``qm``
    is the *deployed* program — pass a fault-injected model (and/or
    ``faults`` for in-flight activation faults) to exercise the guard;
    it defaults to the golden program itself.

    ``checkpoints`` arms the stage-boundary recovery rung: an int K asks
    :func:`resources.plan_checkpoints` for the equal-cumulative-MAC
    placement, a sequence pins explicit boundary indices, and
    ``None``/0 disables the rung (the primary program then snapshots
    nothing and the executor is unchanged).  Every executor runs on the
    golden model's device.

    Calling the executor returns ``(logits, GuardReport)``.
    """

    def __init__(self, gate, x_cal, policy: Optional[GuardPolicy] = None,
                 qm: Optional[pipe.QuantizedModel] = None,
                 n_i: int = 16, n_l: int = 32,
                 block_h: Optional[int] = None,
                 faults: Optional[Dict] = None,
                 checkpoints=None,
                 registry: Optional[tele.MetricsRegistry] = None,
                 tracer: Optional[tele.Tracer] = None):
        if gate.quantized is None or gate.specs is None:
            raise RuntimeError("apply_quantization() or "
                               "calibrate_quantization() first")
        self.gate = gate
        self.policy = policy or GuardPolicy()
        # telemetry: rung spans + outcome counters go to the
        # process-default sinks unless the deployment passes its own
        # (e.g. the serve loop sharing one registry per replica)
        self._registry = registry if registry is not None\
            else tele.get_registry()
        self._tracer = tracer if tracer is not None else tele.get_tracer()
        self._kw = dict(n_i=n_i, n_l=n_l, block_h=block_h)
        golden = gate.quantized
        self._stage_idx = {ql.info.name: i
                           for i, ql in enumerate(golden.layers)}
        if checkpoints is None:
            self._boundaries: Tuple[int, ...] = ()
        elif isinstance(checkpoints, int):
            from . import resources as R
            self._boundaries = R.plan_checkpoints(gate.parsed, checkpoints)
        else:
            self._boundaries = tuple(sorted({int(c) for c in checkpoints}))
        # prove the boundaries before any executor is built: deploying a
        # guard whose recovery snapshots sit at illegal boundaries would
        # only surface at the first escalation, mid-incident
        from . import verify as verify_mod
        bad = verify_mod.check_checkpoint_boundaries(gate.parsed,
                                                     self._boundaries)
        if bad:
            raise verify_mod.VerificationError(bad)
        # selective hardening: audit only the policy's stage subset
        # (translated to output-tensor names, the executor's audit key)
        if self.policy.audit_stages is None:
            self._audit = True
        else:
            sel = set(self.policy.audit_stages)
            unknown = sel - set(self._stage_idx)
            if unknown:
                raise ValueError("audit_stages name unknown stages: "
                                 f"{sorted(unknown)}")
            self._audit = tuple(ql.info.output for ql in golden.layers
                                if ql.info.name in sel)
        self.x_cal = torch.as_tensor(x_cal, dtype=torch.float32,
                                     device=golden.device)
        self._gold = self._make_level(golden, gate.specs)
        qm = golden if qm is None else qm
        if qm is golden and not faults and not self._boundaries:
            primary_ex = self._gold.ex
        else:
            primary_ex = pipe.make_executor(
                qm, audit=self._audit, faults=faults,
                checkpoints=self._boundaries or None, **self._kw)
        self._primary = (qm, primary_ex)
        self._fallbacks: Dict[str, Optional[_Level]] = {}
        #: boundary index -> golden replay executor, built lazily
        #: on first escalation and cached (like the fallback levels)
        self._replays: Dict[int, Callable] = {}

    def with_program(self, qm: pipe.QuantizedModel,
                     faults: Optional[Dict] = None) -> "GuardedExecutor":
        """Cheap re-deployment: a new guarded executor over a different
        (e.g. freshly fault-injected) program that SHARES this one's
        golden envelope and already-built fallback levels — what the
        fault-injection bench sweeps trial programs through."""
        other = object.__new__(GuardedExecutor)
        other.__dict__ = dict(self.__dict__)
        other._primary = (qm, pipe.make_executor(
            qm, audit=self._audit, faults=faults,
            checkpoints=self._boundaries or None, **self._kw))
        return other

    # ------------------------------------------------ level construction
    def _make_level(self, qm: pipe.QuantizedModel,
                    specs: Dict[str, QuantSpec]) -> _Level:
        ex = pipe.make_executor(qm, audit=self._audit, **self._kw)
        tensor_m = pipe.thread_scales(qm.parsed, specs)
        _, stats = ex(self.x_cal)
        env = {t: self._dequant(t, s, tensor_m)
               for t, s in pipe.stats_to_host(stats).items()}
        return _Level(qm, ex, tensor_m, GuardEnvelope(env))

    def _replay_ex(self, boundary: int) -> Callable:
        """The golden program's replay closure from one boundary: runs
        only stages ``boundary+1 ..`` off a snapshot environment."""
        if boundary not in self._replays:
            self._replays[boundary] = pipe.make_executor(
                self.gate.quantized, audit=self._audit,
                replay_from=boundary, **self._kw)
        return self._replays[boundary]

    @staticmethod
    def _dequant(tensor: str, s: np.ndarray,
                 tensor_m: Dict[str, int]) -> Tuple[float, float, float]:
        scale = 2.0 ** -tensor_m.get(tensor, 0)
        return (float(s[0]), float(s[1]) * scale, float(s[2]) * scale)

    def _fallback(self, name: str) -> Optional[_Level]:
        if name not in self._fallbacks:
            parsed_u = P.parse(self.gate.parsed.graph, fuse_skip=False,
                               fuse_concat=False)
            if name == "unfused":
                specs = dict(self.gate.specs)
            else:  # per_tensor (implies unfused: the simplest datapath)
                if not any(s.per_channel for s in self.gate.specs.values()):
                    self._fallbacks[name] = None
                    return None
                specs = _scalar_specs(self.gate.specs)
            qm = pipe.build_quantized(parsed_u, specs,
                                      device=self.gate.quantized.device)
            self._fallbacks[name] = self._make_level(qm, specs)
        return self._fallbacks[name]

    # ------------------------------------------------------------- audit
    def _check(self, qm: pipe.QuantizedModel, stats: Dict,
               level: _Level) -> List[StageAudit]:
        """Host-side dequant audit of one run against a level's
        calibration envelope, in schedule order.  Tensors without an
        envelope entry (extra intermediates of a fallback program) are
        skipped."""
        pol = self.policy
        stats = pipe.stats_to_host(stats)
        audits: List[StageAudit] = []
        for ql in qm.layers:
            t = ql.info.output
            if t not in stats or t not in level.envelope.stats:
                continue
            sat, mx, mean = self._dequant(t, stats[t], level.tensor_m)
            e_sat, e_max, e_mean = level.envelope.stats[t]
            reasons = []
            if sat > e_sat + pol.sat_tol:
                reasons.append(f"saturation {sat:.4f} > {e_sat:.4f}")
            if mx > e_max * (1.0 + pol.margin):
                reasons.append(f"max_abs {mx:.4g} > {e_max:.4g}")
            if mean > e_mean * (1.0 + pol.margin) or\
                    mean * (1.0 + pol.margin) < e_mean:
                reasons.append(f"mean_abs {mean:.4g} vs {e_mean:.4g}")
            audits.append(StageAudit(ql.info.name, t, sat, mx, mean,
                                     bool(reasons), tuple(reasons)))
        return audits

    # --------------------------------------------------------- inference
    def __call__(self, x) -> Tuple[torch.Tensor, GuardReport]:
        """Guarded inference: the primary run, the ladder, and the
        telemetry trail — one ``guard.infer`` span nesting a span per
        rung, plus ``guard.outcome.*`` / ``guard.rung.*`` registry
        counters."""
        with self._tracer.span("guard.infer", cat="guard",
                               args={"model": self.gate.parsed.name}):
            y, report = self._infer(x)
        self._registry.counter(f"guard.outcome.{report.outcome}").inc()
        for act in report.actions:
            self._registry.counter(f"guard.rung.{act.action}").inc()
        return y, report

    def _infer(self, x) -> Tuple[torch.Tensor, GuardReport]:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.x_cal.device)
        qm, ex = self._primary
        with self._tracer.span("guard.primary", cat="guard"):
            if self._boundaries:
                y, stats, ckpts = ex(x)
            else:
                (y, stats), ckpts = ex(x), {}
        audits = self._check(qm, stats, self._gold)
        flagged = [a.stage for a in audits if a.flagged]
        if not flagged:
            return y, GuardReport(flagged, audits, [], None, False, True)
        actions: List[ActionResult] = []
        if self._boundaries and self.policy.checkpoint_replay:
            # localize: the earliest flagged stage upper-bounds where
            # the upset entered (audits run in schedule order); replay
            # the GOLDEN program from the nearest snapshot before it —
            # bit-exact vs full golden reexecution by construction,
            # cost bounded by the downstream stage count.  A snapshot
            # poisoned by an unflagged upstream upset re-flags on the
            # replay's own audit below and the ladder escalates.
            first = min(self._stage_idx[s] for s in flagged)
            cands = [b for b in self._boundaries if b < first]
            if cands:
                b = max(cands)
                bname = self.gate.quantized.layers[b].info.name
                n_replayed = len(self.gate.quantized.layers) - (b + 1)
                with self._tracer.span("guard.rung.checkpoint_replay",
                                       cat="guard",
                                       args={"boundary": bname,
                                             "replayed": n_replayed}):
                    yr, statsr = self._replay_ex(b)(ckpts[bname])
                fr = [a.stage
                      for a in self._check(self._gold.qm, statsr,
                                           self._gold) if a.flagged]
                actions.append(ActionResult("checkpoint_replay", fr,
                                            replayed=n_replayed,
                                            boundary=bname))
                if not fr:
                    return yr, GuardReport(flagged, audits, actions,
                                           "checkpoint_replay", False,
                                           True)
        if self.policy.retry:
            with self._tracer.span("guard.rung.reexecute", cat="guard"):
                if self._boundaries:
                    y2, stats2, _ = ex(x)
                else:
                    y2, stats2 = ex(x)
            f2 = [a.stage for a in self._check(qm, stats2, self._gold)
                  if a.flagged]
            actions.append(ActionResult("reexecute", f2))
            if not f2:  # transient upset: same program now in envelope
                return y2, GuardReport(flagged, audits, actions,
                                       "reexecute", False, True)
        for name, enabled in (("unfused", self.policy.fallback_unfused),
                              ("per_tensor",
                               self.policy.fallback_per_tensor)):
            if not enabled:
                continue
            lvl = self._fallback(name)
            if lvl is None:
                continue
            with self._tracer.span(f"guard.rung.fallback:{name}",
                                   cat="guard"):
                yl, statsl = lvl.ex(x)
            fl = [a.stage for a in self._check(lvl.qm, statsl, lvl)
                  if a.flagged]
            actions.append(ActionResult(f"fallback:{name}", fl))
            y = yl
            if not fl:
                return y, GuardReport(flagged, audits, actions, name,
                                      True, True)
        return y, GuardReport(flagged, audits, actions, None, True, False)

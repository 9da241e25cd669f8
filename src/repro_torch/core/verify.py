"""qverify: static design-rule checks over quantized stage programs.

CNN2Gate's pitch is catching infeasible designs *before* paying for
synthesis — the DSE rejects candidates on modeled resources, and every
FPGA toolflow it cites runs design-rule checks ahead of the build.
This module is that DRC pass for our int8 runtime: a static analyzer
over the (Graph, stage program, QuantSpec set) triple that proves the
invariants the executor otherwise only enforces dynamically (or not at
all), emitting structured :class:`Diagnostic` records instead of
letting a bad spec/graph combination surface as a silent int32
wraparound or a wrong fused program at run time.

Rule catalog (DESIGN.md §13) — every rule is a pure function over
already-available metadata; none of them traces or runs a program:

  ========  =========================================================
  QV101     int32 accumulator overflow: worst-case weighted-stage
            magnitude ``128·Σ|w_q| + |b_q| + rounding half`` per Cout
            lane (per-lane under per-channel specs) proved < 2^31
  QV102     a requant or alignment shift exceeds ``MAX_SHIFT``
  QV103     int32 merge overflow: aligned operand bound
            ``Σ 128 << shift_i + rounding half`` proved < 2^31
  QV201     negative requant shift (``m_y`` above the ``m_w + m_x``
            cap — the shift-only datapath cannot scale up)
  QV202     negative merge alignment (an operand position below the
            common scale)
  QV203     scale-threading conflict: a tensor pinned at two
            different fixed-point positions (``thread_scales`` is
            first-set-wins and would silently drop one)
  QV204     fused/unfused threading mismatch: the fused program's
            tensor positions must agree with the standalone-merge
            program's on every shared tensor
  QV205     unresolved fixed-point position (under-specified specs)
  QV206     malformed spec (per-channel lane count vs Cout,
            per-channel merge spec, strict-mode coercion conflict)
  QV301     fused-concat producer slices do not exactly partition the
            merge buffer's Cout (overlap, gap, or offset mismatch)
  QV302     use of an undefined or liveness-released tensor
  QV303     a fused-concat producer's output escapes its merge (the
            slice only exists inside the shared buffer)
  QV304     invalid checkpoint boundary (outside the schedule, or
            inside a fused-concat group)
  QV401     a stage's VMEM working set exceeds the declared budget
  QV402     retained checkpoint bytes push on-chip memory over budget
  QV501     executor probe: standalone integer add in a skip-fused
            program (the fused epilogue should have absorbed it)
  QV502     executor probe: standalone concatenate in a concat-fused
            program
  ========  =========================================================

``verify_program`` runs the static rules (QV1xx–QV4xx);
``structural_probes`` runs the QV5xx probes (those run an executor
once, so they are opt-in — the CLI's ``--probes``).
:func:`pipeline.build_quantized` calls ``verify_program`` on every
program it stages and raises :class:`VerificationError` (a
``ValueError`` via :class:`~repro_torch.core.graph.GraphError`) when any
error-severity diagnostic fires.  Verification never rewrites the
program, so the executor makes the same op calls with the verifier on
or off.

The port's own copy of ``repro.core.verify``: rules QV101-QV402 are the
JAX package's, line for line.  Where the JAX package probes the traced
jaxpr of its executor (QV501/QV502), the port records the calls its
executor makes to the entry points of :mod:`repro_torch.kernels.ops`
(:func:`executor_trace`): a merge the kernels did not absorb shows up
there as a standalone ``qadd_nhwc`` or ``qconcat_nhwc`` call.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import parser as P
from .graph import GraphError
from .quantize import MAX_SHIFT, QuantSpec, quantize_weights, shift_lanes
from .resources import (checkpoint_bytes, concat_group_spans,
                        conv_band_working_set)

INT32_MAX = 2 ** 31 - 1
#: Worst-case |int8| operand magnitude the datapath can see (INT8_MIN).
INT8_MAG = 128

ERROR = "error"
WARNING = "warning"
INFO = "info"

#: rule id -> one-line description (CLI listing, DESIGN.md §13).
RULES: Dict[str, str] = {
    "QV101": "int32 accumulator overflow (weighted-stage worst case)",
    "QV102": "requant/alignment shift exceeds MAX_SHIFT",
    "QV103": "int32 merge overflow (aligned operand bound)",
    "QV201": "negative requant shift (m_y above the m_w+m_x cap)",
    "QV202": "negative merge alignment (operand below the common scale)",
    "QV203": "scale-threading conflict (tensor pinned twice)",
    "QV204": "fused/unfused threading mismatch",
    "QV205": "unresolved fixed-point position",
    "QV206": "malformed QuantSpec (lanes vs Cout / mode conflict)",
    "QV301": "fused-concat slices do not partition the merge buffer",
    "QV302": "use of an undefined or released tensor",
    "QV303": "fused-concat producer slice escapes its merge",
    "QV304": "invalid checkpoint boundary",
    "QV401": "stage VMEM working set over budget",
    "QV402": "retained checkpoint bytes over budget",
    "QV501": "standalone integer add in a skip-fused program",
    "QV502": "standalone concatenate in a concat-fused program",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One design-rule finding: which rule, how bad, where."""

    rule_id: str
    severity: str
    stage: str = ""
    tensor: str = ""
    detail: str = ""

    def __str__(self) -> str:
        where = " ".join(p for p in (
            f"stage={self.stage}" if self.stage else "",
            f"tensor={self.tensor}" if self.tensor else "") if p)
        msg = f"{self.rule_id} {self.severity}"
        if where:
            msg += f" [{where}]"
        if self.detail:
            msg += f": {self.detail}"
        return msg


@dataclasses.dataclass
class VerificationReport:
    """All diagnostics of one verifier run, in rule order."""

    diagnostics: List[Diagnostic]

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_rule(self, rule_id: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.rule_id == rule_id]

    @property
    def rule_ids(self) -> Tuple[str, ...]:
        return tuple(sorted({d.rule_id for d in self.diagnostics}))

    def render(self) -> str:
        if not self.diagnostics:
            return "verification clean (no diagnostics)"
        return "\n".join(str(d) for d in self.diagnostics)

    def raise_if_errors(self) -> "VerificationReport":
        if self.errors:
            raise VerificationError(self.errors)
        return self


class VerificationError(GraphError):
    """A program failed static verification.  Subclasses
    :class:`~repro_torch.core.graph.GraphError` (a ``ValueError``), so
    callers that guarded the old bare raises keep working; carries the
    machine-readable diagnostics so new callers need not parse text."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = tuple(diagnostics)
        n = len(self.diagnostics)
        msg = (f"program verification failed ({n} error"
               f"{'s' if n != 1 else ''}): "
               + "; ".join(str(d) for d in self.diagnostics))
        super().__init__(msg)


# ------------------------------------------------------ spec structure

def _known_spec_names(parsed: P.ParsedModel) -> set:
    names = {li.name for li in parsed.layers}
    names.update(li.merge.name for li in parsed.layers
                 if li.merge is not None)
    return names


def check_spec_shapes(parsed: P.ParsedModel,
                      specs: Dict[str, QuantSpec]) -> List[Diagnostic]:
    """QV206: per-channel lane counts must match Cout; merge specs must
    stay per-tensor (activations carry one position per tensor); spec
    names should resolve to a stage (or a fused merge's name)."""
    out: List[Diagnostic] = []
    merge_names = {li.merge.name for li in parsed.layers
                   if li.merge is not None}
    for li in parsed.layers:
        spec = specs.get(li.name)
        if spec is None:
            continue
        if li.kind in (P.CONV, P.FC):
            if spec.per_channel and len(spec.m_w) != li.c_out:
                out.append(Diagnostic(
                    "QV206", ERROR, stage=li.name, tensor=li.output,
                    detail=f"per-channel m_w has {len(spec.m_w)} lanes "
                           f"for Cout={li.c_out}"))
        elif spec.per_channel:
            out.append(Diagnostic(
                "QV206", ERROR, stage=li.name, tensor=li.output,
                detail="merge/pool specs are per-tensor (activations "
                       "carry one fixed-point position), got a "
                       f"{len(spec.m_w)}-lane m_w"))
    for name, spec in specs.items():
        if name in merge_names and spec.per_channel:
            out.append(Diagnostic(
                "QV206", ERROR, stage=name,
                detail="fused merge specs are per-tensor, got a "
                       f"{len(spec.m_w)}-lane m_w"))
    unknown = set(specs) - _known_spec_names(parsed)
    for name in sorted(unknown):
        out.append(Diagnostic(
            "QV206", WARNING, stage=name,
            detail="spec names no scheduled stage or fused merge"))
    return out


def check_requant_shifts(parsed: P.ParsedModel,
                         specs: Dict[str, QuantSpec],
                         max_shift: int = MAX_SHIFT) -> List[Diagnostic]:
    """QV201/QV102 on every spec'd stage (and fused merge): each lane's
    requant shift ``m_w + m_x - m_y`` proved in ``[0, max_shift]``."""
    out: List[Diagnostic] = []
    seen: set = set()

    def _check(name: str, tensor: str, spec: QuantSpec) -> None:
        if name in seen:
            return
        seen.add(name)
        lanes = shift_lanes(spec)
        lo, hi = min(lanes), max(lanes)
        if lo < 0:
            lane = "" if len(lanes) == 1 else f" (lane {lanes.index(lo)})"
            out.append(Diagnostic(
                "QV201", ERROR, stage=name, tensor=tensor,
                detail=f"negative requant shift {lo}{lane}: m_y={spec.m_y} "
                       "exceeds the m_w+m_x cap — the shift-only "
                       "datapath cannot scale up"))
        if hi > max_shift:
            lane = "" if len(lanes) == 1 else f" (lane {lanes.index(hi)})"
            out.append(Diagnostic(
                "QV102", ERROR, stage=name, tensor=tensor,
                detail=f"requant shift {hi}{lane} exceeds MAX_SHIFT="
                       f"{max_shift} (the int32 round-half-up constant "
                       "1 << (s-1) must stay representable)"))

    for li in parsed.layers:
        spec = specs.get(li.name)
        if spec is not None and li.kind in (P.CONV, P.FC, P.ADD, P.CONCAT):
            _check(li.name, li.output, spec)
        if li.merge is not None:
            mspec = specs.get(li.merge.name)
            if mspec is not None:
                _check(li.merge.name, li.merge.output, mspec)
    return out


# ------------------------------------------------- scale threading

def thread_scales_checked(
        parsed: P.ParsedModel, specs: Dict[str, QuantSpec]
) -> Tuple[Dict[str, int], List[Diagnostic]]:
    """Re-derive :func:`pipeline.thread_scales` as a *checking* pass:
    the same fixpoint over the same pinning rules, but a tensor pinned
    at two different positions is a QV203 diagnostic instead of a
    silent first-set-wins, a weighted stage without a spec is QV205
    instead of a ``KeyError``, and an unresolved graph input/output is
    QV205 instead of a raise.  Returns the (partial) positions plus the
    diagnostics, so downstream rules can keep analyzing."""
    out: List[Diagnostic] = []
    tensor_m: Dict[str, int] = {}
    conflicts: set = set()
    missing: set = set()

    for _ in range(len(parsed.layers) + 2):
        changed = False

        def _set(t: str, m: int, stage: str, why: str) -> None:
            nonlocal changed
            if t in tensor_m:
                if tensor_m[t] != m and (t, m) not in conflicts:
                    conflicts.add((t, m))
                    out.append(Diagnostic(
                        "QV203", ERROR, stage=stage, tensor=t,
                        detail=f"pinned at m={tensor_m[t]} but {why} "
                               f"implies m={m} — thread_scales would "
                               "silently keep the first"))
                return
            tensor_m[t] = m
            changed = True

        for li in parsed.layers:
            spec = specs.get(li.name)
            if li.kind in (P.CONV, P.FC):
                if spec is None:
                    if li.name not in missing:
                        missing.add(li.name)
                        out.append(Diagnostic(
                            "QV205", ERROR, stage=li.name,
                            tensor=li.output,
                            detail="weighted stage has no QuantSpec"))
                    continue
                _set(li.inputs[0], spec.m_x, li.name,
                     f"{li.name}'s m_x={spec.m_x}")
                if li.kind == P.CONV and li.merge is not None:
                    _set(li.merge_intermediate, spec.m_y, li.name,
                         f"{li.name}'s m_y={spec.m_y}")
                    mspec = specs.get(li.merge.name)
                    if mspec is not None:
                        _set(li.output, mspec.m_y, li.name,
                             f"merge {li.merge.name}'s m_y={mspec.m_y}")
                    elif li.skip_input in tensor_m:
                        m = min(spec.m_y, tensor_m[li.skip_input])
                        _set(li.output, m, li.name,
                             f"fused merge {li.merge.name}'s operand "
                             "minimum")
                else:
                    _set(li.output, spec.m_y, li.name,
                         f"{li.name}'s m_y={spec.m_y}")
            elif li.kind == P.POOL:
                if li.inputs[0] in tensor_m:
                    _set(li.output, tensor_m[li.inputs[0]], li.name,
                         "pool scale passthrough")
                elif li.output in tensor_m:
                    _set(li.inputs[0], tensor_m[li.output], li.name,
                         "pool scale passthrough (backward)")
            else:  # add / concat
                if spec is not None:
                    _set(li.output, spec.m_y, li.name,
                         f"{li.name}'s m_y={spec.m_y}")
                elif all(t in tensor_m for t in li.inputs):
                    m = min(tensor_m[t] for t in li.inputs)
                    _set(li.output, m, li.name,
                         f"{li.name}'s operand minimum")
        if not changed:
            break

    for t in (parsed.input_name, parsed.output_name):
        if t not in tensor_m:
            out.append(Diagnostic(
                "QV205", ERROR, tensor=t,
                detail="could not resolve the fixed-point position "
                       "from the given specs"))
    return tensor_m, out


def check_threading_identity(parsed: P.ParsedModel,
                             specs: Dict[str, QuantSpec]
                             ) -> List[Diagnostic]:
    """QV204: thread the same specs over the standalone-merge parse of
    the same graph and require identical positions on every tensor both
    programs name.  (The unfused program threads extra intermediates —
    e.g. pre-pool concat outputs the fused merge absorbed — which have
    no fused counterpart and are exempt by construction.)"""
    fused = any(li.merge is not None or li.concat_fused
                for li in parsed.layers)
    if not fused:
        return []
    unfused = P.parse(parsed.graph, fuse_skip=False, fuse_concat=False)
    m_f, d_f = thread_scales_checked(parsed, specs)
    m_u, d_u = thread_scales_checked(unfused, specs)
    if any(d.severity == ERROR for d in d_f + d_u):
        return []  # positions are not trustworthy; QV203/QV205 already fired
    out: List[Diagnostic] = []
    for t in sorted(set(m_f) & set(m_u)):
        if m_f[t] != m_u[t]:
            out.append(Diagnostic(
                "QV204", ERROR, tensor=t,
                detail=f"fused program threads m={m_f[t]} but the "
                       f"standalone-merge program threads m={m_u[t]} — "
                       "fusion must not move any shared tensor's scale"))
    return out


# ------------------------------------------------- overflow analysis

def _staged_lane_stats(ql) -> Tuple[np.ndarray, np.ndarray]:
    """(Σ|w_q| per Cout lane, |b_q| per lane) from a staged
    :class:`~repro_torch.core.pipeline.QuantizedLayer` — conv weights
    are HWIO (Cout last), FC weights (K, N); both reduce over every axis
    but the last.  The sums are taken where the weights are staged (on
    the card, a staged weight does not cross to the host) and are exact
    in int64 there."""
    w = ql.w_q.to(torch.int32).abs()
    sums = w.sum(dim=tuple(range(w.ndim - 1)),
                 dtype=torch.int64).cpu().numpy()
    if ql.b_q is not None:
        bias = ql.b_q.to(torch.int64).abs().reshape(-1).cpu().numpy()
    else:
        bias = np.zeros_like(sums)
    return sums, bias


def _raw_lane_stats(parsed: P.ParsedModel, li: P.LayerInfo,
                    spec: QuantSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Same lane statistics computed from the graph initializers (the
    CLI path, where no staged program exists): quantize exactly as
    ``build_quantized`` would and reduce onto the Cout axis (OIHW conv:
    axis 0; (K, N) FC: last axis)."""
    w = parsed.graph.initializers[li.weight]
    b = parsed.graph.initializers[li.bias] if li.bias else None
    w_q, b_q = quantize_weights(w, b, spec)
    w_q = np.abs(np.asarray(w_q, np.int64))
    if w_q.ndim == 4:  # OIHW
        sums = w_q.sum(axis=(1, 2, 3))
    else:  # (K, N)
        sums = w_q.sum(axis=tuple(range(w_q.ndim - 1)))
    if b_q is not None:
        bias = np.abs(np.asarray(b_q, np.int64)).reshape(-1)
    else:
        bias = np.zeros_like(sums)
    return sums, bias


def check_accumulators(parsed: P.ParsedModel, specs: Dict[str, QuantSpec],
                       quantized_layers: Optional[Sequence] = None
                       ) -> List[Diagnostic]:
    """QV101: per weighted stage, the worst-case int32 accumulator
    magnitude ``INT8_MAG * Σ_taps|w_q[c]| + |b_q[c]| + (1 << (s_c - 1))``
    per Cout lane ``c`` (the input operand bound is |INT8_MIN| = 128;
    the rounding half rides on the accumulator before the shift) must
    stay within int32.  ``quantized_layers`` reuses the staged arrays
    from :func:`pipeline.build_quantized`; without them the weights are
    re-quantized from the graph initializers (pure numpy)."""
    out: List[Diagnostic] = []
    staged = {ql.info.name: ql for ql in (quantized_layers or ())
              if ql.w_q is not None}
    for li in parsed.layers:
        if li.kind not in (P.CONV, P.FC) or not li.weight:
            continue
        spec = specs.get(li.name)
        if spec is None:
            continue  # QV205 already fired
        if spec.per_channel and len(spec.m_w) != li.c_out:
            continue  # QV206 already fired; lane math would misalign
        try:
            if li.name in staged:
                sums, bias = _staged_lane_stats(staged[li.name])
            else:
                sums, bias = _raw_lane_stats(parsed, li, spec)
        except (KeyError, ValueError):
            continue  # malformed weights: the graph layer reports it
        lanes = np.asarray(shift_lanes(spec), np.int64)
        if lanes.shape[0] not in (1, sums.shape[0]):
            continue
        halves = np.where(lanes > 0,
                          np.left_shift(1, np.maximum(lanes - 1, 0)), 0)
        bound = INT8_MAG * sums + bias + halves
        worst = int(np.argmax(bound))
        if int(bound[worst]) > INT32_MAX:
            taps = li.kernel_shape[0] * li.kernel_shape[1]\
                * (li.c_in // li.group) if li.kind == P.CONV else li.c_in
            out.append(Diagnostic(
                "QV101", ERROR, stage=li.name, tensor=li.output,
                detail=f"worst-case accumulator {int(bound[worst])} "
                       f"(lane {worst}, {taps} taps) exceeds int32 max "
                       f"{INT32_MAX} — the int32 datapath would wrap"))
    return out


def _merge_overflow(kind: str, shifts: Sequence[int],
                    out_shift: int) -> int:
    """Worst-case int32 magnitude of a shift-aligned merge: an Add sums
    every aligned operand; a Concat's slices are independent, so only
    the widest operand counts.  The output requant's rounding half
    rides on top."""
    half = (1 << (out_shift - 1)) if out_shift > 0 else 0
    aligned = [INT8_MAG << s for s in shifts if s >= 0]
    if not aligned:
        return 0
    acc = sum(aligned) if kind == P.ADD else max(aligned)
    return acc + half


def check_merge_alignment(parsed: P.ParsedModel,
                          specs: Dict[str, QuantSpec],
                          tensor_m: Dict[str, int],
                          max_shift: int = MAX_SHIFT) -> List[Diagnostic]:
    """QV202/QV102/QV103 on every merge — standalone Add/Concat stages
    and residual adds folded into a conv epilogue: each operand's
    alignment shift (its position minus the common scale) proved in
    ``[0, max_shift]``, and the aligned int32 sum proved within int32.
    """
    out: List[Diagnostic] = []

    def _check(stage: str, merge_name: str, kind: str,
               operands: Sequence[str], m_ops: Sequence[int],
               spec: Optional[QuantSpec]) -> None:
        if spec is None:
            m_common = min(m_ops)
            spec = QuantSpec(m_w=0, m_x=m_common, m_y=m_common)
        if spec.per_channel:
            return  # QV206 already fired
        shifts = [m - spec.m_x for m in m_ops]
        for t, s in zip(operands, shifts):
            if s < 0:
                out.append(Diagnostic(
                    "QV202", ERROR, stage=stage, tensor=t,
                    detail=f"merge {merge_name!r}: operand position "
                           f"m={spec.m_x + s} below the common scale "
                           f"m={spec.m_x} — shift-only alignment "
                           "cannot scale up"))
            elif s > max_shift:
                out.append(Diagnostic(
                    "QV102", ERROR, stage=stage, tensor=t,
                    detail=f"merge {merge_name!r}: alignment shift {s} "
                           f"exceeds MAX_SHIFT={max_shift}"))
        out_shift = spec.m_w + spec.m_x - spec.m_y
        bound = _merge_overflow(kind, shifts, max(out_shift, 0))
        if bound > INT32_MAX:
            out.append(Diagnostic(
                "QV103", ERROR, stage=stage,
                detail=f"merge {merge_name!r}: aligned int32 bound "
                       f"{bound} exceeds int32 max {INT32_MAX}"))

    for li in parsed.layers:
        if li.kind in (P.ADD, P.CONCAT):
            if not all(t in tensor_m for t in li.inputs):
                continue  # QV205 already fired
            _check(li.name, li.name, li.kind, li.inputs,
                   [tensor_m[t] for t in li.inputs], specs.get(li.name))
        elif li.kind == P.CONV and li.merge is not None:
            operands = (li.merge_intermediate, li.skip_input)
            if not all(t in tensor_m for t in operands):
                continue
            _check(li.name, li.merge.name, P.ADD, operands,
                   [tensor_m[t] for t in operands],
                   specs.get(li.merge.name))
    return out


# --------------------------------------------- alias & liveness rules

def check_concat_partition(parsed: P.ParsedModel) -> List[Diagnostic]:
    """QV301: for every fused concat, the producers' channel slices
    ``[offset, offset + c_out)`` must exactly partition the merge
    buffer's Cout in operand order — no overlap (a non-idempotent
    double write), no gap (uninitialized lanes), no producer-less
    operand (the slice would never be written)."""
    out: List[Diagnostic] = []
    producers: Dict[str, List[P.LayerInfo]] = {}
    for li in parsed.layers:
        if li.concat is not None:
            producers.setdefault(li.concat.name, []).append(li)
    for cc in parsed.layers:
        if cc.kind != P.CONCAT or not cc.concat_fused:
            continue
        group = producers.get(cc.name, [])
        by_out = {li.output: li for li in group}
        missing = [t for t in cc.inputs if t not in by_out]
        for t in missing:
            out.append(Diagnostic(
                "QV301", ERROR, stage=cc.name, tensor=t,
                detail="fused concat operand has no in-place producer "
                       "— its channel slice would never be written"))
        extra = sorted(set(by_out) - set(cc.inputs))
        for t in extra:
            out.append(Diagnostic(
                "QV301", ERROR, stage=cc.name, tensor=t,
                detail=f"stage {by_out[t].name!r} writes the merge "
                       "buffer but its output is not a concat operand"))
        if missing or extra:
            continue
        # operand order fixes the expected offsets
        offset = 0
        intervals = []
        for t in cc.inputs:
            li = by_out[t]
            if li.concat_offset != offset:
                out.append(Diagnostic(
                    "QV301", ERROR, stage=li.name, tensor=t,
                    detail=f"slice offset {li.concat_offset} does not "
                           f"match the operand-order offset {offset} in "
                           f"merge {cc.name!r}"))
            intervals.append((li.concat_offset,
                              li.concat_offset + li.c_out, li.name))
            offset += li.c_out
        intervals.sort()
        end = 0
        for lo, hi, name in intervals:
            if lo < end:
                out.append(Diagnostic(
                    "QV301", ERROR, stage=name,
                    detail=f"slice [{lo}, {hi}) overlaps the previous "
                           f"slice ending at {end} in merge {cc.name!r} "
                           "— overlapping epilogue writes are not "
                           "idempotent"))
            end = max(end, hi)
        if end != cc.c_out or (intervals and intervals[0][0] != 0):
            out.append(Diagnostic(
                "QV301", ERROR, stage=cc.name, tensor=cc.output,
                detail=f"slices cover [{intervals[0][0]}, {end}) of the "
                       f"merge buffer's Cout={cc.c_out} — every lane "
                       "must be written exactly once"))
    return out


def release_schedule(parsed: P.ParsedModel) -> Dict[str, int]:
    """The executor's liveness plan: tensor -> index of the stage after
    which its buffer is dropped from the environment (the graph output
    is pinned past the last stage — the egress reads it).  This is the
    exact rule :func:`pipeline.make_executor` uses to pop buffers."""
    last: Dict[str, int] = {}
    for idx, li in enumerate(parsed.layers):
        for t in li.inputs:
            last[t] = idx
    last[parsed.output_name] = len(parsed.layers)
    return last


def check_liveness(parsed: P.ParsedModel,
                   release_at: Optional[Dict[str, int]] = None
                   ) -> List[Diagnostic]:
    """QV302/QV303: interpret the schedule against an abstract tensor
    environment with the executor's exact liveness-release rule.  Every
    stage input must be live when read (produced earlier, not yet
    released); fused-concat producer outputs exist only as slices of
    the shared merge buffer, so any consumer other than their own
    Concat stage reads a tensor the environment never holds.

    ``release_at`` overrides the release plan (tensor -> drop index);
    by default it is re-derived from the schedule itself via
    :func:`release_schedule`.  Passing a journaled plan lets callers
    prove a *modified* schedule (a spliced stage, a recovery replay)
    against the buffer lifetimes the original build committed to."""
    out: List[Diagnostic] = []
    layers = parsed.layers
    last_use = release_at if release_at is not None\
        else release_schedule(parsed)

    live = {parsed.input_name}
    defined = {parsed.input_name}
    slices: Dict[str, str] = {}  # fused producer output -> its merge
    for idx, li in enumerate(layers):
        fused_cc = li.kind == P.CONCAT and li.concat_fused
        for t in dict.fromkeys(li.inputs):
            if t in slices:
                if not (fused_cc and slices[t] == li.name):
                    out.append(Diagnostic(
                        "QV303", ERROR, stage=li.name, tensor=t,
                        detail="reads a fused-concat producer slice "
                               "that only exists inside merge "
                               f"{slices[t]!r}'s shared buffer"))
                continue
            if t in live:
                continue
            if t in defined:
                out.append(Diagnostic(
                    "QV302", ERROR, stage=li.name, tensor=t,
                    detail="read after its liveness release (the last "
                           "consumer already ran and the environment "
                           "dropped the buffer)"))
            else:
                out.append(Diagnostic(
                    "QV302", ERROR, stage=li.name, tensor=t,
                    detail="read before any scheduled stage produces it"))
        for t in [t for t in live if last_use.get(t, len(layers)) == idx]:
            live.discard(t)
        if li.output in defined:
            out.append(Diagnostic(
                "QV302", ERROR, stage=li.name, tensor=li.output,
                detail="produced twice — a second write would clobber "
                       "the first product's consumers"))
        defined.add(li.output)
        if li.concat is not None:
            slices[li.output] = li.concat.name
        else:
            live.add(li.output)
    if parsed.output_name in slices:
        out.append(Diagnostic(
            "QV303", ERROR, tensor=parsed.output_name,
            detail="the graph output is a fused-concat producer slice "
                   "— it never exists as a named tensor"))
    elif parsed.output_name not in defined:
        out.append(Diagnostic(
            "QV302", ERROR, tensor=parsed.output_name,
            detail="the graph output is never produced by any "
                   "scheduled stage"))
    return out


def check_checkpoint_boundaries(parsed: P.ParsedModel,
                                boundaries: Iterable[int]
                                ) -> List[Diagnostic]:
    """QV304: every snapshot boundary must be a real stage boundary —
    inside the schedule, and not inside a fused-concat group where the
    half-built shared merge buffer is live but is not a named graph
    tensor.  (:func:`pipeline.make_executor` enforces exactly this set
    by raising :class:`VerificationError` on these diagnostics.)"""
    out: List[Diagnostic] = []
    n = len(parsed.layers)
    spans = concat_group_spans(parsed)
    for c in sorted({int(c) for c in boundaries}):
        if not 0 <= c < n:
            out.append(Diagnostic(
                "QV304", ERROR,
                detail=f"checkpoint boundary {c} outside the schedule "
                       f"[0, {n})"))
            continue
        for start, end, name in spans:
            if start <= c < end:
                out.append(Diagnostic(
                    "QV304", ERROR, stage=parsed.layers[c].name,
                    detail=f"checkpoint boundary {c} lies inside "
                           f"fused-concat group {name!r} (stages "
                           f"{start}..{end}); pick a boundary where "
                           "only named tensors are live"))
    return out


# ------------------------------------------------- resource budgets

def check_resources(parsed: P.ParsedModel, *, n_i: int = 16,
                    n_l: int = 32, block_h: Optional[int] = None,
                    per_channel: bool = False,
                    vmem_budget: Optional[int] = None,
                    checkpoints: Iterable[int] = ()
                    ) -> List[Diagnostic]:
    """QV401/QV402 against a *declared* budget (``vmem_budget=None``
    checks nothing — budgets are deployment decisions, not program
    properties): each stage's row-band working set must fit, and the
    retained checkpoint snapshots must fit alongside the peak band
    (they coexist on chip, so the charges add — same rule the DSE's
    ``CNNDesignSpace`` scores)."""
    if vmem_budget is None:
        return []
    out: List[Diagnostic] = []
    peak = 0
    for li in parsed.layers:
        ws = conv_band_working_set([li], n_l, block_h, n_i=n_i,
                                   per_channel=per_channel)
        peak = max(peak, ws)
        if ws > vmem_budget:
            out.append(Diagnostic(
                "QV401", ERROR, stage=li.name, tensor=li.output,
                detail=f"row-band working set {ws} B exceeds the "
                       f"declared budget {vmem_budget} B at (n_i={n_i}, "
                       f"n_l={n_l}, block_h={block_h})"))
    bounds = [c for c in {int(c) for c in checkpoints}
              if 0 <= c < len(parsed.layers)]
    if bounds:
        ckpt_b = checkpoint_bytes(parsed, bounds)
        if peak + ckpt_b > vmem_budget:
            out.append(Diagnostic(
                "QV402", ERROR,
                detail=f"retained checkpoint snapshots ({ckpt_b} B at "
                       f"boundaries {sorted(bounds)}) on top of the "
                       f"peak band ({peak} B) exceed the declared "
                       f"budget {vmem_budget} B"))
    return out


# ---------------------------------------------- executor structural probes

def executor_trace(qm, n_i: int = 16, n_l: int = 32,
                   block_h: Optional[int] = None, batch: int = 1,
                   **hooks) -> List[Tuple[str, int]]:
    """Run the executor of a built program once, on a zero input on the
    program's device, and return the calls it made to the entry points
    of :mod:`repro_torch.kernels.ops`, in order: ``(name, tensor
    operands)``.  The counterpart of the JAX package's
    ``executor_jaxpr``: calls are counted at the ops level, so the plain
    versions' own arithmetic (on the CPU) is not seen, as the jaxpr walk
    does not descend into ``pallas_call``.  ``hooks`` forward to
    ``make_executor``."""
    from repro_torch.kernels import ops

    from . import pipeline as pipe

    ex = pipe.make_executor(qm, n_i, n_l, block_h=block_h, **hooks)
    x = torch.zeros((batch,) + tuple(qm.parsed.input_shape[1:]),
                    dtype=torch.float32, device=qm.device)
    with ops.recording() as calls:
        ex(x)
    return list(calls)


def int_add_calls(trace: Sequence[Tuple[str, int]]) -> int:
    """Standalone residual merges in an executor trace: ``qadd_nhwc``
    calls.  A fully skip-fused program must have none."""
    return sum(1 for name, _n in trace if name == "qadd_nhwc")


def concat_calls(trace: Sequence[Tuple[str, int]]) -> int:
    """Standalone channel merges in an executor trace: ``qconcat_nhwc``
    calls.  A fully concat-fused program must have none."""
    return sum(1 for name, _n in trace if name == "qconcat_nhwc")


#: The ops entry points that launch a weighted kernel (conv or GEMM).
KERNEL_OPS = ("qconv2d_nhwc", "qgemm")


def kernel_call_arities(trace: Sequence[Tuple[str, int]]) -> List[int]:
    """Tensor operand count of every weighted kernel call in trace
    order — the per-channel program stages exactly one extra operand
    (the per-lane shift vector) on every one of them.  The counterpart
    of the JAX package's ``pallas_call_arities``."""
    return [n for name, n in trace if name in KERNEL_OPS]


def structural_probes(qm, n_i: int = 16, n_l: int = 32,
                      block_h: Optional[int] = None,
                      batch: int = 1) -> List[Diagnostic]:
    """QV501/QV502: run the executor once and prove the fusion
    annotations hold in what it calls — no standalone ``qadd_nhwc`` when
    every residual merge is folded, no ``qconcat_nhwc`` when every
    concat is epilogue-fused.  Opt-in (a run is not free): the CLI's
    ``--probes``, not the build-time pass."""
    out: List[Diagnostic] = []
    layers = qm.parsed.layers
    trace = executor_trace(qm, n_i, n_l, block_h=block_h, batch=batch)
    has_unfused_add = any(li.kind == P.ADD for li in layers)
    if not has_unfused_add and any(li.merge is not None for li in layers):
        n = int_add_calls(trace)
        if n:
            out.append(Diagnostic(
                "QV501", ERROR,
                detail=f"{n} standalone qadd_nhwc call(s) in a program "
                       "whose residual merges are all epilogue-fused"))
    ccs = [li for li in layers if li.kind == P.CONCAT]
    if ccs and all(cc.concat_fused for cc in ccs):
        n = concat_calls(trace)
        if n:
            out.append(Diagnostic(
                "QV502", ERROR,
                detail=f"{n} standalone qconcat_nhwc call(s) in a program "
                       "whose channel merges are all epilogue-fused"))
    return out


# --------------------------------------------------------- entry points

def _widen_specs(parsed: P.ParsedModel, specs: Dict[str, QuantSpec],
                 per_channel: Optional[bool]
                 ) -> Tuple[Dict[str, QuantSpec], List[Diagnostic]]:
    """The same mode coercion :func:`pipeline.build_quantized` applies,
    as a diagnostic pass: strict per-tensor mode rejects vector specs
    (QV206); ``per_channel=True`` widens scalar weighted-layer specs to
    uniform per-Cout vectors (bit-identical numerics)."""
    if per_channel is None:
        return dict(specs), []
    out: List[Diagnostic] = []
    coerced: Dict[str, QuantSpec] = {}
    for name, spec in specs.items():
        li = next((l for l in parsed.layers if l.name == name
                   or (l.merge is not None and l.merge.name == name)),
                  None)
        weighted = (li is not None and li.name == name
                    and li.kind in (P.CONV, P.FC))
        if not per_channel and spec.per_channel:
            out.append(Diagnostic(
                "QV206", ERROR, stage=name,
                detail=f"spec for {name!r} is per-channel but "
                       "per_channel=False was requested"))
        if per_channel and weighted and not spec.per_channel:
            coerced[name] = dataclasses.replace(
                spec, m_w=(spec.m_w,) * li.c_out)
    return dict(specs, **coerced), out


def verify_program(parsed: P.ParsedModel, specs: Dict[str, QuantSpec],
                   *, per_channel: Optional[bool] = None,
                   quantized_layers: Optional[Sequence] = None,
                   n_i: int = 16, n_l: int = 32,
                   block_h: Optional[int] = None,
                   vmem_budget: Optional[int] = None,
                   checkpoints: Iterable[int] = (),
                   check_identity: bool = True,
                   max_shift: int = MAX_SHIFT) -> VerificationReport:
    """Run the full static rule catalog over (stage program, specs) and
    return the :class:`VerificationReport`.  Pure analysis: nothing is
    traced, staged, or mutated — callers that want the old raise-on-bad
    behavior chain ``.raise_if_errors()``."""
    specs, diags = _widen_specs(parsed, specs, per_channel)
    diags += check_spec_shapes(parsed, specs)
    diags += check_requant_shifts(parsed, specs, max_shift=max_shift)
    tensor_m, d_thread = thread_scales_checked(parsed, specs)
    diags += d_thread
    diags += check_merge_alignment(parsed, specs, tensor_m,
                                   max_shift=max_shift)
    diags += check_accumulators(parsed, specs,
                                quantized_layers=quantized_layers)
    diags += check_concat_partition(parsed)
    diags += check_liveness(parsed)
    diags += check_checkpoint_boundaries(parsed, checkpoints)
    diags += check_resources(parsed, n_i=n_i, n_l=n_l, block_h=block_h,
                             per_channel=any(s.per_channel
                                             for s in specs.values()),
                             vmem_budget=vmem_budget,
                             checkpoints=checkpoints)
    if check_identity:
        diags += check_threading_identity(parsed, specs)
    return VerificationReport(diags)


def verify_quantized(qm, **kw) -> VerificationReport:
    """Verify a *built* program: reconstruct the effective spec set
    from the staged layers (including the default merge specs
    ``build_quantized`` materialized) and reuse the staged int8 arrays
    for the overflow bounds instead of re-quantizing."""
    specs: Dict[str, QuantSpec] = {}
    for ql in qm.layers:
        if ql.spec is not None:
            specs[ql.info.name] = ql.spec
        if ql.info.merge is not None and ql.merge_spec is not None:
            specs[ql.info.merge.name] = ql.merge_spec
    kw.setdefault("quantized_layers", qm.layers)
    return verify_program(qm.parsed, specs, **kw)

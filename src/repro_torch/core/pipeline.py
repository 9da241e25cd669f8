"""Pipelined int8 executor — the "host program" of §4.2.

Takes a parsed model + per-layer (N, m) quantization specs, quantizes
weights/biases once, and runs inference by streaming each pipeline stage
through the fused kernels (conv+ReLU+pool on the conv kernel, FC on the
GEMM kernel).

The executor is an **interpreter over the DAG stage program**: the
parser's topologically-scheduled stage list is executed against a
tensor environment of named int8 NHWC activations, with liveness-based
release (a tensor is dropped from the environment after its last
consumer runs, so a residual skip holds exactly as long as its merge
needs it).  Residual ``Add`` stages align their operands' fixed-point
positions with per-operand round-half-up shifts before the int32 add
(see :func:`thread_scales`).

Activations stay NHWC int8 from ingress to egress — one NCHW->NHWC
conversion when the float input is quantized, one back only if the
network ends in a spatial stage — and every layer's weights are staged
on the model's device in the kernel layout once, at
:func:`build_quantized` time (conv OIHW -> HWIO; FC rows permuted so
flattening an NHWC activation hits the same features the NCHW-trained
weights expect; a dense or grouped conv's weight also K-major for the
wgmma kernel, and a per-channel spec's shift vector).  PyTorch runs the
stage loop eagerly; each stage is one op of
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.kernels import ops, qconv, qgemm
from . import parser as P
from . import telemetry as tele
from . import verify as V
from .quantize import (INT8_MAX, INT8_MIN, QuantSpec, clamp_code,
                       quantize_weights)


@dataclasses.dataclass
class QuantizedLayer:
    """One stage with weights staged in the kernel layout: conv -> HWIO
    int8, FC -> (K, N) int8 in NHWC-flatten row order.  Merge stages
    carry per-operand alignment shifts instead of weights."""

    info: P.LayerInfo
    spec: Optional[QuantSpec]
    w_q: Optional[torch.Tensor]
    b_q: Optional[torch.Tensor]
    operand_shifts: Tuple[int, ...] = ()
    # conv stages with a folded residual add: the merge's own spec
    # (requant shift from the common operand position to m_y); the
    # operand_shifts then align (conv intermediate, skip) in that order
    merge_spec: Optional[QuantSpec] = None
    # the kernels' operands staged once: the weight K-major for the wgmma
    # kernels, (Cout, K_pad) for a dense or grouped conv and (N, K_pad)
    # for an FC, and a per-lane spec's int32 shift vector (conv and FC)
    w_k: Optional[torch.Tensor] = None
    shift_vec: Optional[torch.Tensor] = None
    # a fused ReLU-n's clamp code (``quantize.clamp_code`` of the conv's
    # ``clip_max`` at its spec's m_y), 127 without one: the upper end of
    # the clamp that follows the requant
    hi: int = INT8_MAX


@dataclasses.dataclass
class QuantizedModel:
    """int8-ready pipeline (weights quantized with the *given* specs and
    staged on ``device``)."""

    name: str
    layers: List[QuantizedLayer]
    input_m: int          # fixed-point exponent of the network input
    output_m: int
    parsed: P.ParsedModel
    device: torch.device
    _executors: Dict[Tuple, Callable] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def hardware_options(self):
        """The parsed model's ``hardware_options`` method, as the JAX
        package exposes it: callers write ``qm.hardware_options()``."""
        return self.parsed.hardware_options


def thread_scales(model: P.ParsedModel,
                  specs: Dict[str, QuantSpec]) -> Dict[str, int]:
    """Per-tensor fixed-point exponents implied by the per-layer specs —
    a graph pass over the DAG.

    Rules: a weighted stage pins its input tensor at ``m_x`` and its
    output at ``m_y``; pools pass the scale through unchanged (both
    directions, so a pool feeding the first conv resolves too); merge
    stages output at their spec's ``m_y``, or at the minimum operand
    position when no spec was given.  A conv with a folded residual add
    pins its *intermediate* tensor (the unfused conv output) at its own
    ``m_y`` and its stage output at the merge spec's ``m_y`` — the same
    two rules the unfused Conv + Add pair would apply.  Iterated to
    fixpoint; raises if the graph input or output never resolves
    (under-specified specs).  Per-channel specs change nothing here:
    tensor positions are activation scales, which stay per-tensor.
    """
    tensor_m: Dict[str, int] = {}
    for _ in range(len(model.layers) + 2):
        changed = False

        def _set(t: str, m: int) -> None:
            nonlocal changed
            if t not in tensor_m:
                tensor_m[t] = m
                changed = True

        for li in model.layers:
            spec = specs.get(li.name)
            if li.kind in (P.CONV, P.FC):
                if spec is None:
                    raise KeyError(f"no QuantSpec for layer {li.name!r}")
                _set(li.inputs[0], spec.m_x)
                if li.kind == P.CONV and li.merge is not None:
                    _set(li.merge_intermediate, spec.m_y)
                    mspec = specs.get(li.merge.name)
                    if mspec is not None:
                        _set(li.output, mspec.m_y)
                    elif li.skip_input in tensor_m:
                        _set(li.output,
                             min(spec.m_y, tensor_m[li.skip_input]))
                else:
                    _set(li.output, spec.m_y)
            elif li.kind == P.POOL:
                if li.inputs[0] in tensor_m:
                    _set(li.output, tensor_m[li.inputs[0]])
                elif li.output in tensor_m:
                    _set(li.inputs[0], tensor_m[li.output])
            else:  # add / concat
                if spec is not None:
                    _set(li.output, spec.m_y)
                elif all(t in tensor_m for t in li.inputs):
                    _set(li.output, min(tensor_m[t] for t in li.inputs))
        if not changed:
            break
    for t in (model.input_name, model.output_name):
        if t not in tensor_m:
            raise ValueError("could not resolve fixed-point position of "
                             f"tensor {t!r} from the given specs")
    return tensor_m


def _stage_weights(li: P.LayerInfo, prev: Optional[P.LayerInfo],
                   w_q: np.ndarray) -> np.ndarray:
    """One-time layout staging: conv OIHW -> HWIO; FC weight rows
    reordered from the exporter's NCHW-flatten order (c, h, w) to the
    executor's NHWC-flatten order (h, w, c) when the FC consumes a
    flattened spatial tensor.  ``prev`` is the stage *producing* the
    FC's input tensor (DAG producer, not list predecessor)."""
    if li.kind == P.CONV:
        return np.transpose(w_q, (2, 3, 1, 0))
    if li.kind == P.FC and prev is not None and len(prev.out_shape) == 4:
        _n, c, h, w = prev.out_shape
        k, n_out = w_q.shape
        if k == c * h * w:
            return (w_q.reshape(c, h, w, n_out)
                    .transpose(1, 2, 0, 3)
                    .reshape(k, n_out))
    return w_q


def _check_group(li: P.LayerInfo) -> None:
    """Every grouped conv must be executable *as a grouped conv* — an
    invalid group can never fall through to the dense kernel and produce
    silently wrong numerics."""
    g = li.group
    if g < 1 or li.c_in % g or li.c_out % g:
        raise NotImplementedError(
            f"conv {li.name!r}: group={g} does not divide "
            f"C_in={li.c_in}/C_out={li.c_out}; the executor cannot map "
            "this onto the grouped kernel library")


def stage_kmajor(li: P.LayerInfo,
                 w_q: torch.Tensor) -> Optional[torch.Tensor]:
    """The K-major copy of a staged weight that the wgmma kernels read
    (``QuantizedLayer.w_k``): a dense or grouped conv's
    (:func:`qconv.stage_kmajor` with its groups, packed as the grouped
    kernel packs them) and an FC's (:func:`qgemm.stage_kmajor`);
    None for a depthwise conv, whose kernel reads the HWIO weight.  Every
    copy of a weight the kernels see is staged here (the build, a fault
    injection, a call-time weight), so a kernel never reads a stale copy
    of a corrupted ``w_q``."""
    if li.kind == P.CONV and ops.conv_route(
            li.group, li.c_in, w_q.shape) != "depthwise":
        return qconv.stage_kmajor(w_q, li.group)
    if li.kind == P.FC:
        return qgemm.stage_kmajor(w_q)
    return None


def stage_shift_vec(w_q: torch.Tensor,
                    spec: QuantSpec) -> Optional[torch.Tensor]:
    """A per-channel spec's int32 per-lane shifts on the weight's device
    (``QuantizedLayer.shift_vec``), None for a per-tensor spec."""
    return qgemm.stage_shift(spec.requant_shift, w_q.shape[-1], w_q.device)


def build_quantized(model: P.ParsedModel,
                    specs: Dict[str, QuantSpec],
                    per_channel: Optional[bool] = None,
                    verify: bool = True,
                    device: _device.DeviceLike = None,
                    tracer: Optional[tele.Tracer] = None) -> QuantizedModel:
    """Apply the user-given (N, m) pairs (the paper: CNN2Gate does not
    *perform* quantization, it *applies* provided values) and stage all
    weights on ``device`` (CUDA by default) in the kernel layouts.
    Merge stages (add/concat) get per-operand alignment shifts derived
    from :func:`thread_scales`; a spec for them is optional (default:
    merge at the minimum operand position, no output requant).

    ``per_channel`` selects the weight-scale mode:
      * ``None`` (default) — honour each spec as given;
      * ``True``  — every weighted layer runs per-channel: scalar
        ``m_w`` specs are widened to uniform per-Cout vectors (bit-
        identical numerics, shift-vector datapath);
      * ``False`` — strict per-tensor: a tuple ``m_w`` raises.

    ``verify`` (default on) runs the static design-rule checks of
    :mod:`.verify` over the program — the cheap structural rules before
    staging, the overflow bounds on the staged int8 weights after — and
    raises :class:`~.verify.VerificationError` (a ``ValueError``) on any
    error-severity diagnostic, where the JAX package raises.  A merge
    whose operand sits below the common position raises it whether or
    not ``verify`` is on (rule QV202: shift-only alignment cannot scale
    up), and so does a per-channel spec under ``per_channel=False``
    (QV206).  Verification is pure analysis: the staged program is the
    same with it on or off.

    ``tracer`` (default: none) records the three parts of the work as
    spans: ``quantize.verify`` for each pass of the checks (``rules``
    ``structural`` or ``staged``), and for each weighted stage
    ``quantize.numpy`` (the host quantization and layout) and
    ``quantize.stage`` (the copy onto the device and the kernels'
    operands)."""
    dev = _device.resolve(device)
    span = (tracer.span if tracer is not None
            else lambda *a, **k: contextlib.nullcontext())
    if per_channel is not None:
        coerced = {}
        for name, spec in specs.items():
            li = next((l for l in model.layers if l.name == name
                       or (l.merge is not None and l.merge.name == name)),
                      None)
            weighted = (li is not None and li.name == name
                        and li.kind in (P.CONV, P.FC))
            if not per_channel and spec.per_channel:
                raise V.VerificationError([V.Diagnostic(
                    "QV206", V.ERROR, stage=name,
                    detail=f"spec for {name!r} is per-channel but "
                           "per_channel=False was requested")])
            if per_channel and weighted and not spec.per_channel:
                coerced[name] = dataclasses.replace(
                    spec, m_w=(spec.m_w,) * li.c_out)
        specs = dict(specs, **coerced)
    if verify:
        # cheap structural rules first — spec shapes, shift ranges,
        # threading conflicts, merge alignment — so an infeasible spec
        # set fails with structured diagnostics before any staging work
        with span("quantize.verify", cat="setup",
                  args={"rules": "structural"}):
            pre = V.check_spec_shapes(model, specs)
            pre += V.check_requant_shifts(model, specs)
            tm_chk, d_thr = V.thread_scales_checked(model, specs)
            pre += d_thr
            pre += V.check_merge_alignment(model, specs, tm_chk)
            V.VerificationReport(pre).raise_if_errors()
    tensor_m = thread_scales(model, specs)
    layers: List[QuantizedLayer] = []
    for li in model.layers:
        # pool stages carry no weights: int8 passes through at the
        # incoming fixed-point scale (no spec, no requant)
        spec = specs.get(li.name) if li.kind in (P.POOL, P.ADD, P.CONCAT)\
            else specs[li.name]
        w = model.graph.initializers[li.weight] if li.weight else None
        b = model.graph.initializers[li.bias] if li.bias else None
        w_q, b_q = (None, None)
        operand_shifts: Tuple[int, ...] = ()
        merge_spec: Optional[QuantSpec] = None
        if li.kind == P.CONV:
            _check_group(li)
        if li.kind == P.CONV and li.merge is not None:
            # folded residual add: same shift-only alignment rules as a
            # standalone merge, operands = (conv intermediate, skip)
            m_ops = (tensor_m[li.merge_intermediate],
                     tensor_m[li.skip_input])
            merge_spec = specs.get(li.merge.name)
            if merge_spec is None:
                m_common = min(m_ops)
                merge_spec = QuantSpec(m_w=0, m_x=m_common, m_y=m_common)
            operand_shifts = tuple(m - merge_spec.m_x for m in m_ops)
            if any(s < 0 for s in operand_shifts):
                raise V.VerificationError([V.Diagnostic(
                    "QV202", V.ERROR, stage=li.name,
                    tensor=li.output,
                    detail=f"fused merge {li.merge.name!r}: operand "
                           "position below the common scale "
                           f"m={merge_spec.m_x} (shifts {operand_shifts})"
                           " — shift-only alignment cannot scale up")])
        if li.kind in (P.ADD, P.CONCAT):
            m_ops = [tensor_m[t] for t in li.inputs]
            if spec is None:
                m_common = min(m_ops)
                spec = QuantSpec(m_w=0, m_x=m_common, m_y=m_common)
            operand_shifts = tuple(m - spec.m_x for m in m_ops)
            if any(s < 0 for s in operand_shifts):
                raise V.VerificationError([V.Diagnostic(
                    "QV202", V.ERROR, stage=li.name, tensor=li.output,
                    detail=f"merge {li.name!r}: operand position below "
                           f"the common scale m={spec.m_x} (shifts "
                           f"{operand_shifts}) — shift-only alignment "
                           "cannot scale up")])
        w_k = shift_vec = None
        if w is not None:
            with span("quantize.numpy", cat="setup",
                      args={"stage": li.name}):
                w_np, b_np = quantize_weights(w, b, spec)
                prev_info = model.stage_producing(li.inputs[0])
                w_np = np.ascontiguousarray(_stage_weights(li, prev_info,
                                                           w_np))
            with span("quantize.stage", cat="setup",
                      args={"stage": li.name}):
                w_q = torch.from_numpy(w_np).to(dev)
                b_q = (torch.from_numpy(b_np).to(dev) if b_np is not None
                       else None)
                w_k = stage_kmajor(li, w_q)
                shift_vec = stage_shift_vec(w_q, spec)
        hi = (INT8_MAX if li.clip_max is None
              else clamp_code(li.clip_max, spec.m_y))
        layers.append(QuantizedLayer(li, spec, w_q, b_q, operand_shifts,
                                     merge_spec, w_k, shift_vec, hi))
    if verify:
        # the deep rules run on the staged program: overflow bounds on
        # the actual int8 weights (no re-quantization), alias/liveness of
        # the schedule, fused/unfused threading identity
        with span("quantize.verify", cat="setup", args={"rules": "staged"}):
            post = V.check_accumulators(model, specs,
                                        quantized_layers=layers)
            post += V.check_concat_partition(model)
            post += V.check_liveness(model)
            post += V.check_threading_identity(model, specs)
            V.VerificationReport(post).raise_if_errors()
    return QuantizedModel(
        name=model.name,
        layers=layers,
        input_m=tensor_m[model.input_name],
        output_m=tensor_m[model.output_name],
        parsed=model,
        device=dev,
    )


def _concat_axis(axis: int, ndim: int) -> int:
    """Map an NCHW concat axis onto the executor's NHWC layout."""
    if ndim == 4:
        return {0: 0, 1: 3, 2: 1, 3: 2}[axis % 4]
    return axis


def _host(a) -> np.ndarray:
    """A host array of ``a`` (array, list or tensor on any device)."""
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _flat_index(idx, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Flat indices into ``n`` elements as the JAX package's scatter
    takes them: a negative index counts from the end, and one outside
    ``[-n, n)`` is dropped (its update never lands; a sampled flip on a
    fused concat producer's pooled slice can lie past it).  Returns the
    kept indices and the mask of the kept slots."""
    ix = _host(idx).astype(np.int64).reshape(-1)
    keep = (ix >= -n) & (ix < n)
    return np.where(ix < 0, ix + n, ix)[keep], keep


def _xor_payload(idx, mask, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host side of an activation-fault XOR into ``n`` elements, with the
    JAX package's semantics: its payload is one scatter that writes
    ``x[i] ^ mask[k]`` from the original value and keeps the last write
    of a repeated index.  So here a repeated index keeps the mask of its
    LAST slot, and an index whose last mask is zero is dropped (that slot
    writes the original back: a no-op slot after a real flip undoes it),
    and the device scatter sees each index once: ``(flat indices, int8
    masks)``.  Indices go through :func:`_flat_index`."""
    ix, kept = _flat_index(idx, n)
    merged: Dict[int, int] = {}
    for i, m in zip(ix.tolist(), _host(mask).astype(np.int8).reshape(-1)
                    [kept].tolist()):
        merged[i] = m & 0xFF
    keep = [(i, m) for i, m in merged.items() if m]
    return (np.asarray([i for i, _ in keep], np.int64),
            np.asarray([m for _, m in keep], np.uint8).astype(np.int8))


def _corrupt(h: torch.Tensor, xor, zero=None, trials: int = 1
             ) -> torch.Tensor:
    """A corrupted copy of ``h``: for each trial ``t`` of the ``trials``
    that ``h`` holds along its batch, its pair ``xor[t] = (flat indices,
    int8 masks)`` (unique indices in range, :func:`_xor_payload`) XORed
    in, then its flat indices ``zero[t]`` (in range) cleared.  Flat order
    is one trial's logical order (NHWC, its batch included).  ``h``
    itself is never written: a snapshot or the caller may hold it."""
    n = h.numel() // trials
    flat_ix = {name: [np.asarray(ix, np.int64) + t * n
                      for t, ix in enumerate(per_trial) if len(ix)]
               for name, per_trial in (("xor", [ix for ix, _m in xor]),
                                       ("zero", zero or []))}
    flat = h.reshape(-1).clone()
    if flat_ix["xor"]:
        ji = torch.as_tensor(np.concatenate(flat_ix["xor"]), device=h.device)
        masks = np.concatenate([m for ix, m in xor if len(ix)])
        flat[ji] = torch.bitwise_xor(flat[ji],
                                     torch.as_tensor(masks, device=h.device))
    if flat_ix["zero"]:
        flat[torch.as_tensor(np.concatenate(flat_ix["zero"]),
                             device=h.device)] = 0
    return flat.view(h.shape)


def _apply_tensor_faults(h: torch.Tensor, f: Dict,
                         trials: int = 1) -> torch.Tensor:
    """Apply a static activation-fault payload (``core/faults.py``:
    ``FaultPlan.activation_faults``) to one named tensor: XOR bit masks
    at flat indices (SEU bit flips) and zeroed flat ranges (dropped
    bursts); the same payload to each of the ``trials`` that ``h`` holds
    along its batch."""
    n = h.numel() // trials
    pair = (_xor_payload(f["xor_idx"], f["xor_mask"], n)
            if f.get("xor_idx") is not None
            else (np.zeros(0, np.int64), np.zeros(0, np.int8)))
    z = f.get("zero_idx")
    return _corrupt(h, [pair] * trials,
                    None if z is None else [_flat_index(z, n)[0]] * trials,
                    trials)


def _apply_arg_faults(h: torch.Tensor, entry,
                      trials: Optional[int] = None) -> torch.Tensor:
    """Apply a *call-time* activation-fault payload ``(idx, mask)`` (host
    arrays) to one tensor: XOR ``mask[k]`` into flat element ``idx[k]``,
    a repeated index keeping its last slot, an index out of range
    dropped (:func:`_xor_payload`).  A zero mask alone is the identity,
    which is how the padded slots of a campaign's fixed-shape payload
    ride along (``core/ser.py``).  With
    ``trials``, ``h`` holds that many trials along its batch and
    ``idx``/``mask`` one row of slots a trial."""
    if trials is None:
        return _corrupt(h, [_xor_payload(*entry, h.numel())])
    idx, mask = (_host(a) for a in entry)
    if idx.shape[:1] != (trials,) or mask.shape[:1] != (trials,):
        raise ValueError(f"a payload of {trials} trials needs one row of "
                         f"slots a trial, got {idx.shape} and {mask.shape}")
    n = h.numel() // trials
    return _corrupt(h, [_xor_payload(idx[t], mask[t], n)
                        for t in range(trials)], trials=trials)


def _stage_stats(h: torch.Tensor,
                 trials: Optional[int] = None) -> torch.Tensor:
    """int8-domain audit statistics of one stage output, on its device:
    ``[saturation fraction, max |value|, mean |value|]`` (float32).  The
    saturation count and ``sum |h|`` are exact integers, scaled once at
    the end by the float32 reciprocal of the element count (the product
    XLA makes of the JAX package's float32 mean), so the result does
    not depend on a reduction order: it is the same on the CPU and the
    card, and equals the JAX package's wherever that is exact (sums
    below 2^24).  The guard (``core/guard.py``) dequantizes these
    host-side with the tensor's fixed-point position.  With ``trials``,
    ``h`` holds that many trials along its batch and the result is one
    row of the three a trial, each equal to its trial's alone."""
    rows = h.reshape(1 if trials is None else trials, -1)
    inv_n = float(np.float32(1) / np.float32(rows.shape[1]))
    sat = ((rows == INT8_MAX) | (rows == INT8_MIN)).sum(1)
    a = rows.to(torch.int32).abs()
    st = torch.stack([sat.to(torch.float32) * inv_n,
                      a.amax(1).to(torch.float32),
                      a.sum(1).to(torch.float32) * inv_n], dim=1)
    return st[0] if trials is None else st


class _TrialBatch:
    """The state of one trial-batched run (:func:`vmap_trials`): the
    number of trials, and the environment keys whose tensors hold every
    trial along their batch (trial t's rows ``[t*N, (t+1)*N)``).  Every
    other tensor is shared by the trials, at the batch of one."""

    def __init__(self, n: int):
        self.n = n
        self.varying: set = set()

    def expand(self, h: torch.Tensor) -> torch.Tensor:
        """A shared tensor, repeated for every trial (a new tensor)."""
        return torch.cat([h] * self.n)

    def unfold(self, h: torch.Tensor, varying: bool) -> torch.Tensor:
        """(T*N, ...) -> (T, N, ...); a shared (N, ...) as a view."""
        if varying:
            return h.reshape((self.n, h.shape[0] // self.n)
                             + tuple(h.shape[1:]))
        return h.unsqueeze(0).expand((self.n,) + tuple(h.shape))


def _trial_count(arrays) -> int:
    """The trial axis' length that every array of a trial-batched call
    shares (their leading dimension)."""
    sizes = {int(a.shape[0]) for a in arrays}
    if len(sizes) != 1:
        raise ValueError("a trial-batched call needs its weights, payload "
                         "and environment to share one leading trial axis, "
                         f"got leading sizes {sorted(sizes) or 'none'}")
    return sizes.pop()


def stats_to_host(stats: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """An audited run's statistics on the host, read back with one copy:
    ``{tensor: [sat_frac, max_abs, mean_abs]}`` in the run's order."""
    if not stats:
        return {}
    rows = torch.stack(list(stats.values())).cpu().numpy()
    return dict(zip(stats, rows))


def make_executor(qm: QuantizedModel, n_i: int = 16, n_l: int = 32,
                  block_h: Optional[int] = None,
                  *,
                  audit=False,
                  faults: Optional[Dict[str, Dict]] = None,
                  checkpoints=None,
                  weight_args=(),
                  fault_args=(),
                  replay_from: Optional[int] = None,
                  stage_timed: bool = False,
                  tracer=None,
                  on_stage: Optional[Callable[[str, str], None]] = None
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the whole-network executor: a closure that interprets the
    DAG stage program over a tensor environment on ``qm.device``.  Its
    argument is the NCHW float input (array or tensor); the result is
    float32 logits (dequantized with the output tensor's m, softmax when
    the last stage has one).

    ``(n_i, n_l, block_h)`` is the DSE's design point (§4.2), kept on the
    closure as ``design_point``.  The CUDA kernels' tiles are fixed in
    this version, so the design point changes nothing that runs — as in
    the JAX package, the result is identical for every option.

    Conv stages with a folded residual add (``li.merge``) feed the skip
    operand straight into the kernel epilogue; every conv stage passes
    its clamp code (``ql.hi``, the kernels' ``hi``: a fused ReLU-n's, 127
    without one).  Conv stages annotated
    for concat fusion (``li.concat``) write their output into a
    channel-offset slice of the merge's shared buffer: the buffer is
    allocated at the first producer (kept in the environment under a
    reserved ``"\\x00cbuf:"`` key that no graph tensor name can take),
    each producer's kernel **updates it in place** with its own
    ``out_off``/``concat_shift``/``concat_relu`` (and the merge's
    absorbed pool, when present), and the annotated Concat stage itself
    just takes the finished buffer as the merge tensor.  The buffer key
    is released at the Concat stage, which by construction runs after
    the last contributor.

    Buffer release is liveness-based: the stage index of each tensor's
    last consumer is precomputed, and the environment drops a tensor as
    soon as the schedule passes it.

    Resilience hooks (the JAX package's, with its names, checks and
    messages; all default off, and when off the executor makes exactly
    the ops calls it makes without them):

      * ``audit`` — ``True`` makes the closure also return per-stage
        int8 audit statistics (``{tensor: [sat_frac, max_abs,
        mean_abs]}`` on the device, :func:`_stage_stats`;
        :func:`stats_to_host` reads them back with one copy); a
        *collection* of tensor names audits only those stages.
      * ``faults`` — a static in-flight activation-fault payload
        (``core/faults.py``: ``FaultPlan.activation_faults``).
      * ``checkpoints`` — stage indices at which the closure snapshots
        the live int8 tensor environment (after the liveness release:
        exactly what a replay needs).  The closure then also returns
        ``{stage_name: {tensor: int8 tensor}}``.  Boundaries inside a
        fused-concat group are rejected (verifier rule QV304).  No stage
        writes into a tensor a snapshot holds.
      * ``replay_from`` — build a *replay* closure instead: it takes a
        checkpoint environment and runs only the stages after the given
        boundary index, leaving the snapshot as it was.
      * ``weight_args`` — stage names whose weights become a call-time
        argument (``ex(x, {stage: w_q})``): a campaign runs every
        trial's corrupted weights through one executor.  The kernels'
        K-major operand is staged from the call-time weight
        (:func:`stage_kmajor`), never taken from the build, unless the
        caller passes it with the weight as a ``(w_q, w_k)`` pair.
      * ``fault_args`` — tensor names whose activation-fault payload
        ``(idx, mask)`` becomes a call-time argument (``ex(x, ...,
        {tensor: (idx, mask)})``); a zero mask is a no-op slot.

    Flat fault indices address a tensor in NHWC order with the batch
    included; a fused concat producer's output tensor is its channel
    slice of the shared buffer, which faults and audits address as if
    it stood alone (the corrupted slice is written back into the
    buffer).

    Every executor but the stage-timed one has a trial form,
    :func:`vmap_trials`: the counterpart of the JAX package's
    ``jax.vmap(ex, in_axes=(None, 0, 0))``, which runs many trials'
    weights and payloads through one call.

    ``stage_timed=True`` builds the **stage-timed executor** instead:
    ingress, every DAG stage and egress run in schedule order, with
    ``torch.cuda.synchronize()`` after each on the card, and the closure
    returns ``(logits, timings)`` where ``timings`` is a schedule-order
    list of ``{"stage", "kind", "wall_us"}`` rows (host wall time); an
    optional ``tracer`` (:class:`.telemetry.Tracer`) records each as a
    span.  It is the forward with a timing ``on_stage``
    (:func:`_stage_clock`): same stage program, same kernels, same
    logits.  Exclusive with every other hook.

    ``on_stage`` — a callback ``on_stage(stage, kind)`` that the closure
    calls after the ingress (``("ingress", "ingress")``), after each
    stage in schedule order (its name and kind) and after the egress
    (``("egress", "egress")``), once the stage's device work is
    enqueued.  The captured executor reads there how many device
    operations each stage put into the graph under capture
    (``CapturedExecutor.stage_map``).  None (the default) costs one test
    a stage.

    Return value composition (fixed order): ``logits``, then ``stats``
    when auditing, then ``ckpts`` when checkpointing."""
    stages = qm.layers
    out_name = qm.parsed.output_name
    in_name = qm.parsed.input_name
    out_stage = qm.parsed.stage_producing(out_name)
    dev = qm.device

    last_use: Dict[str, int] = {}
    for idx, ql in enumerate(stages):
        for t in ql.info.inputs:
            last_use[t] = idx
    last_use[out_name] = len(stages)  # the egress reads it

    # ---- resilience-hook configuration (all fixed at build time) ----
    audit_sel = None if isinstance(audit, bool) else frozenset(audit)
    want_stats = audit is not False
    if stage_timed and (want_stats or faults or checkpoints
                        or weight_args or fault_args
                        or replay_from is not None or on_stage is not None):
        raise ValueError(
            "stage_timed is exclusive with the audit/faults/checkpoints/"
            "weight_args/fault_args/replay_from/on_stage hooks: the "
            "stage-timed executor measures the plain program")

    def _audited(t: str) -> bool:
        return audit is True or (audit_sel is not None and t in audit_sel)

    weight_arg_set = frozenset(weight_args or ())
    weighted_names = {ql.info.name for ql in stages if ql.w_q is not None}
    unknown_w = weight_arg_set - weighted_names
    if unknown_w:
        raise ValueError("weight_args name stages without staged "
                         f"weights: {sorted(unknown_w)}")
    fault_arg_set = frozenset(fault_args or ())
    known_tensors = {ql.info.output for ql in stages} | {in_name}
    unknown_f = fault_arg_set - known_tensors
    if unknown_f:
        raise ValueError("fault_args name unknown tensors: "
                         f"{sorted(unknown_f)}")

    ckpt_idx = tuple(sorted({int(c) for c in (checkpoints or ())}))
    if ckpt_idx and replay_from is not None:
        raise ValueError("checkpoints and replay_from are exclusive: a "
                         "replay closure never snapshots")
    # boundary legality (range + never inside a fused-concat group) is
    # the verifier's QV304 rule — one shared implementation with the
    # checkpoint planner, so executor and planner can never disagree
    bad = V.check_checkpoint_boundaries(qm.parsed, ckpt_idx)
    if bad:
        raise V.VerificationError(bad)
    if replay_from is not None and not -1 <= replay_from < len(stages):
        raise ValueError(f"replay_from={replay_from} outside [-1, "
                         f"{len(stages)})")
    ckpt_set = frozenset(ckpt_idx)
    has_w_arg = bool(weight_arg_set)
    has_f_arg = bool(fault_arg_set)

    # concat fusion: producers need their merge's alignment shifts and
    # relu flag, which live on the (still-scheduled) Concat stage
    concat_ql = {ql.info.name: ql for ql in stages
                 if ql.info.kind == P.CONCAT}

    def _cbuf_key(cc: P.LayerInfo) -> str:
        return "\x00cbuf:" + cc.name

    def _extra(extra):
        """Split the optional positional tail into (weights, payload)."""
        i = 0
        weights = None
        payload = None
        if has_w_arg:
            weights = extra[i]
            i += 1
        if has_f_arg:
            payload = extra[i]
            i += 1
        if i != len(extra):
            raise TypeError(f"executor expected {i} extra argument(s) "
                            f"(weights={has_w_arg}, faults={has_f_arg}), "
                            f"got {len(extra)}")
        return weights, payload

    def _pack(logits, stats, ckpts):
        out = (logits,)
        if want_stats:
            out += (stats,)
        if ckpt_set:
            out += (ckpts,)
        return out if len(out) > 1 else logits

    def _weights(ql: QuantizedLayer, weights, tr=None):
        """(w_q, w_k) of a weighted stage: the build's, or a call-time
        weight with its K-major copy staged from it, or a call-time
        ``(w_q, w_k)`` pair staged by the caller (``faults.trial_weights``).
        In a trial-batched run, stacks of one image a trial."""
        if weights is not None and ql.info.name in weight_arg_set:
            w = weights[ql.info.name]
            w, w_k = w if isinstance(w, tuple) else (w, None)
            w = torch.as_tensor(w, device=dev)
            want = ((tr.n,) if tr is not None else ()) + tuple(ql.w_q.shape)
            if tuple(w.shape) != want:
                raise ValueError(f"weight of {ql.info.name!r}: expected "
                                 f"{want}, got {tuple(w.shape)}")
            return w, (stage_kmajor(ql.info, w) if w_k is None else w_k)
        return ql.w_q, ql.w_k

    def _conv(ql: QuantizedLayer, env: Dict[str, torch.Tensor], weights,
              tr):
        li = ql.info
        pool = None
        if li.pool is not None:
            pool = (li.pool.kernel_shape[0], li.pool.strides[0])
        epilogue = {}
        if li.merge is not None:  # residual add in the epilogue
            epilogue = dict(skip=env[li.skip_input],
                            skip_shifts=ql.operand_shifts,
                            merge_shift=ql.merge_spec.requant_shift,
                            merge_relu=li.merge.relu)
        if li.concat is not None:  # concat merge in the epilogue
            cc = li.concat
            cq = concat_ql[cc.name]
            if cc.pool is not None:  # pool absorbed by the merge
                pool = (cc.pool.kernel_shape[0], cc.pool.strides[0])
            buf = env.get(_cbuf_key(cc))
            if buf is None:  # first contributor allocates
                _nb, c_, h_, w_ = cc.out_shape
                nb = env[li.inputs[0]].shape[0]
                buf = torch.zeros((nb, h_, w_, c_), dtype=torch.int8,
                                  device=dev)
            epilogue.update(out_buf=buf, out_off=li.concat_offset,
                            concat_shift=cq.operand_shifts[
                                cc.inputs.index(li.output)],
                            concat_relu=cc.relu)
        w_q, w_k = _weights(ql, weights, tr)
        return ops.qconv2d_nhwc(
            env[li.inputs[0]], w_q, ql.b_q, strides=li.strides,
            pads=li.pads, shift=ql.spec.requant_shift, relu=li.relu,
            pool=pool, groups=li.group, w_k=w_k,
            shift_vec=ql.shift_vec, hi=ql.hi, **epilogue)

    def _stage(ql: QuantizedLayer, env: Dict[str, torch.Tensor], weights,
               tr):
        li = ql.info
        if li.kind == P.CONV:
            return _conv(ql, env, weights, tr)
        if li.kind == P.POOL:
            pool_fn = (ops.avgpool2d_nhwc if li.pool_type == "avg"
                       else ops.maxpool2d_nhwc)
            return pool_fn(env[li.inputs[0]], li.kernel_shape[0],
                           li.strides[0], li.pads)
        if li.kind == P.FC:
            h = env[li.inputs[0]]
            if h.ndim > 2:
                # NHWC flatten: rows were permuted at staging time
                h = h.reshape(h.shape[0], -1)
            w_q, w_k = _weights(ql, weights, tr)
            return ops.qgemm(h, w_q, ql.b_q, shift=ql.spec.requant_shift,
                             relu=li.relu, shift_vec=ql.shift_vec, w_k=w_k)
        if li.kind == P.ADD:
            return ops.qadd_nhwc([env[t] for t in li.inputs],
                                 ql.operand_shifts,
                                 shift=ql.spec.requant_shift, relu=li.relu)
        if li.kind == P.CONCAT:
            if li.concat_fused:
                # the producers already wrote (aligned + relu'd +
                # pooled) channel slices in place: the shared buffer IS
                # the merge tensor
                return env.pop(_cbuf_key(li))
            xs = [env[t] for t in li.inputs]
            return ops.qconcat_nhwc(xs, ql.operand_shifts,
                                    axis=_concat_axis(li.axis, xs[0].ndim),
                                    relu=li.relu)
        raise ValueError(li.kind)  # the parser only emits the five kinds

    def _resilience(h: torch.Tensor, t: str, payload, stats, tr=None):
        """The hooks on one stage output ``h`` named ``t``: static and
        call-time faults, then the audit (in a trial-batched run ``tr``,
        of each trial: a tensor the trials share is audited once)."""
        n = tr.n if tr is not None and t in tr.varying else None
        if faults and t in faults:
            h = _apply_tensor_faults(h, faults[t], n or 1)
        if t in fault_arg_set:
            h = _apply_arg_faults(h, payload[t], n)
        if _audited(t):
            st = _stage_stats(h, n)
            stats[t] = st if tr is None or n else st.expand(tr.n, 3)
        return h

    def _trial_inputs(ql: QuantizedLayer, env, weights, tr) -> bool:
        """Whether a stage of a trial-batched run varies by trial (a
        call-time weight, or an operand that varies); if so its shared
        operands are repeated for every trial first, so that it runs once
        at the batch of all trials.  A stage that does not vary runs
        once, at the batch of one, as under ``jax.vmap``."""
        li = ql.info
        keys = [t for t in li.inputs if t in env]
        if li.kind == P.CONCAT and li.concat_fused:
            keys = [_cbuf_key(li)]
        elif li.kind == P.CONV and li.concat is not None \
                and _cbuf_key(li.concat) in env:
            keys.append(_cbuf_key(li.concat))
        varying = (weights is not None and li.name in weight_arg_set) \
            or any(k in tr.varying for k in keys)
        if varying:
            for k in keys:
                if k not in tr.varying:
                    env[k] = tr.expand(env[k])
                    tr.varying.add(k)
        return varying

    def _exec_stages(env: Dict[str, torch.Tensor], weights, payload,
                     start: int, stats, ckpts, tr=None) -> None:
        """Interpret the stages from ``start`` on over a live tensor
        environment, updating ``env``/``stats``/``ckpts`` in place — the
        shared core of the forward and replay paths and of their trial
        forms (``tr``, :class:`_TrialBatch`)."""
        for idx in range(start, len(stages)):
            ql = stages[idx]
            li = ql.info
            varying = tr is not None and _trial_inputs(ql, env, weights, tr)
            h = _stage(ql, env, weights, tr)
            t = li.output
            if tr is not None and t in fault_arg_set and not varying:
                h = tr.expand(h)   # a payload varies by trial
                varying = True
            if li.kind == P.CONV and li.concat is not None:
                # h IS the shared buffer; the producer's own output
                # tensor exists only as a channel slice of it, which the
                # hooks address (a corrupted slice is written back)
                if varying:
                    tr.varying.update((_cbuf_key(li.concat), t))
                if (faults and t in faults) or t in fault_arg_set \
                        or _audited(t):
                    off = li.concat_offset
                    sl = h[..., off:off + li.c_out]
                    new = _resilience(sl, t, payload, stats, tr)
                    if new is not sl:
                        sl.copy_(new)
                env[_cbuf_key(li.concat)] = h
            else:
                if varying:
                    tr.varying.add(t)
                env[t] = _resilience(h, t, payload, stats, tr)
            for t in li.inputs:     # liveness-based buffer release
                if last_use.get(t) == idx:
                    env.pop(t, None)  # pop: an operand may repeat (x + x)
            if idx in ckpt_set:
                # snapshot AFTER the liveness release: the environment
                # holds exactly the live set — what a replay from this
                # boundary needs, and nothing more
                ckpts[li.name] = (dict(env) if tr is None else
                                  {k: tr.unfold(v, k in tr.varying)
                                   for k, v in env.items()})
            if on_stage is not None:
                on_stage(li.name, li.kind)

    def _egress(env: Dict[str, torch.Tensor]) -> torch.Tensor:
        h = env[out_name]
        if h.ndim == 4:
            h = h.permute(0, 3, 1, 2)              # single egress NHWC->NCHW
        logits = h.to(torch.float32) * (2.0 ** -qm.output_m)
        if out_stage is not None and out_stage.softmax:
            logits = torch.softmax(logits, dim=-1)
        return logits

    def _ingress(x_float, payload, tr=None) -> torch.Tensor:
        x = torch.as_tensor(x_float, dtype=torch.float32, device=dev)
        h = torch.clamp(torch.round(x * (2.0 ** qm.input_m)), -128, 127)
        h = h.to(torch.int8)
        if h.ndim == 4:
            h = h.permute(0, 2, 3, 1).contiguous()  # single ingress NCHW->NHWC
        if faults and in_name in faults:
            h = _apply_tensor_faults(h, faults[in_name])
        if in_name in fault_arg_set:
            n = None
            if tr is not None:   # the input is shared; its payload is not
                h, n = tr.expand(h), tr.n
                tr.varying.add(in_name)
            h = _apply_arg_faults(h, payload[in_name], n)
        return h

    def _run(env: Dict[str, torch.Tensor], weights, payload, start: int,
             tr=None):
        stats: Dict[str, torch.Tensor] = {}
        ckpts: Dict[str, Dict[str, torch.Tensor]] = {}
        _exec_stages(env, weights, payload, start, stats, ckpts, tr)
        logits = _egress(env)
        if tr is not None:
            logits = tr.unfold(logits, out_name in tr.varying)
        if on_stage is not None:
            on_stage("egress", "egress")
        return logits, stats, ckpts

    def _batch(weights, payload, env=None) -> _TrialBatch:
        """The trial batch of a trial-form call, from the leading axis of
        its trial-varying arguments."""
        arrays = [w[0] if isinstance(w, tuple) else w
                  for w in (weights or {}).values()]
        arrays += [a for entry in (payload or {}).values() for a in entry]
        arrays += list((env or {}).values())
        return _TrialBatch(_trial_count(arrays))

    def _entry(trial: bool) -> Callable:
        """The executor's closure: the forward from the float input, or,
        with ``replay_from``, the replay from a checkpoint environment;
        with ``trial``, its trial form (:func:`vmap_trials`)."""
        @torch.no_grad()
        def call(inp, *extra):
            weights, payload = _extra(extra)
            tr = None
            if replay_from is None:
                if trial:
                    tr = _batch(weights, payload)
                env = {in_name: _ingress(inp, payload, tr)}
                if on_stage is not None:
                    on_stage("ingress", "ingress")
                start = 0
            else:
                env = dict(inp)
                if trial:
                    tr = _batch(weights, payload, env)
                    tr.varying.update(env)
                    env = {k: torch.as_tensor(v, device=dev).reshape(
                        (-1,) + tuple(v.shape[2:])) for k, v in env.items()}
                start = replay_from + 1
            return _pack(*_run(env, weights, payload, start, tr))
        return call

    if stage_timed:
        on_stage, begin = _stage_clock(qm, tracer)
        forward = _entry(False)

        def run(x_float):
            timings = begin()
            return forward(x_float), timings
    else:
        run = _entry(False)
        run.trials = _entry(True)
    run.design_point = (n_i, n_l, block_h)
    return run


def vmap_trials(ex: Callable) -> Callable:
    """The trial form of an executor of :func:`make_executor`: the
    counterpart of the JAX package's ``jax.vmap(ex, in_axes=(None, 0,
    0))`` (``src/repro/core/ser.py``), many trials in one call.

    The forward's trial form takes ``x`` shared by every trial, then the
    executor's call-time arguments with a leading trial axis T: weights
    ``{stage: (T, ...) int8}`` (one image a trial) and a payload
    ``{tensor: (idx (T, slots), mask (T, slots))}``.  It returns the
    logits (T, N, ...), the audit stats ``{tensor: (T, 3)}`` and the
    checkpoints ``{stage: {tensor: (T, N, ...)}}``, each row equal, bit
    for bit, to the executor's own call with that trial's arguments.  A
    replay executor's trial form takes an environment ``{tensor: (T, N,
    ...)}``.

    Inside, the trials ride the batch: a stage with a call-time weight
    takes its kernel's trial form (one launch for all trials, each with
    its own weight image, ``kernels/ops.py``); a stage whose operands
    vary by trial runs once at the batch of all trials on the weight they
    share; a stage before the first that varies runs once for all, at
    the batch of one.  Each trial's flat payload indices address its own
    rows, the audit reduces each trial's rows alone."""
    fn = getattr(ex, "trials", None)
    if fn is None:
        raise TypeError("the stage-timed executor has no trial form")
    return fn


def _stage_clock(qm: QuantizedModel, tracer) -> Tuple[Callable, Callable]:
    """The stage-timed executor's clock (``make_executor(
    stage_timed=True)``): ``begin()`` starts a call's clock and returns
    its list of rows; the ``on_stage`` callback synchronizes the device
    and appends ``{"stage", "kind", "wall_us"}``, the host wall time since
    the previous mark (the first since ``begin()``), so that ingress
    (quantize + layout), each DAG stage and egress (dequant + softmax)
    are each attributed their own wall.  An optional ``tracer`` records
    each row as a span."""
    if qm.device.type == "cuda":
        def sync() -> None:
            torch.cuda.synchronize(qm.device)
    else:
        def sync() -> None:
            pass
    call: list = []     # the open call's rows, and its previous mark

    def mark() -> None:
        call[1:] = (time.perf_counter(),
                    tracer.now_us() if tracer is not None else 0.0)

    def begin() -> List[Dict[str, object]]:
        call[:] = [[]]
        mark()
        return call[0]

    def on_stage(name: str, kind: str) -> None:
        sync()
        rows, t0, ts_us = call
        dur_us = (time.perf_counter() - t0) * 1e6
        rows.append({"stage": name, "kind": kind, "wall_us": dur_us})
        if tracer is not None:
            tracer.add_span(name, ts_us, dur_us, cat="stage",
                            args={"kind": kind, "model": qm.name})
        mark()

    return on_stage, begin


def run_int8(qm: QuantizedModel, x_float, n_i: int = 16, n_l: int = 32,
             block_h: Optional[int] = None) -> torch.Tensor:
    """Full pipelined inference through the executor.  Executors are
    cached per (N_i, N_l, block_h) on the model, so repeated calls reuse
    one."""
    key = (n_i, n_l, block_h)
    ex = qm._executors.get(key)
    if ex is None:
        ex = qm._executors[key] = make_executor(qm, n_i, n_l,
                                                block_h=block_h)
    return ex(x_float)


def layer_bytes(li: P.LayerInfo) -> Tuple[int, int, int]:
    """(input, weight, output) int8 bytes of a stage — feeds the latency
    model and the memory-schedule report.  Merge stages read every
    operand."""
    if li.kind in (P.ADD, P.CONCAT):
        if li.concat_fused:
            # producer-fused concat: the producers wrote their channel
            # slices straight into the shared buffer, so the merge stage
            # itself moves nothing
            return 0, 0, 0
        if li.kind == P.ADD:
            in_b = len(li.inputs) * int(np.prod(li.in_shape))
        else:
            in_b = int(np.prod(li.out_shape))
        return in_b, 0, int(np.prod(li.out_shape))
    in_b = int(np.prod(li.in_shape))
    if li.kind == P.CONV and li.merge is not None:
        # fused residual merge: the skip operand streams in once; the
        # intermediate conv result never touches memory at all
        in_b += int(np.prod(li.conv_out_shape))
    w_b = li.weight_count()
    out_b = int(np.prod(li.out_shape))
    if li.kind == P.CONV and li.concat is not None\
            and li.concat.pool is not None:
        # concat producer with the merge's absorbed pool: the slice it
        # writes is in pooled geometry
        cc = li.concat
        out_b = int(cc.out_shape[0] * li.c_out * np.prod(cc.out_shape[2:]))
    return in_b, w_b, out_b

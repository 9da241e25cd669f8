"""CNN2Gate automated synthesis workflow (§4.2, Fig. 4a) on PyTorch.

``CNN2Gate`` is the user-facing orchestrator:

    gate = CNN2Gate.from_graph(vgg16())            # ONNX-lite front end
    gate.calibrate_quantization(x)                  # or apply_quantization
    gate.verify()                                   # static design rules
    fit  = gate.explore("ARRIA10", algo="rl")       # hardware-aware DSE
    run  = gate.build("fullflow", *fit.best)        # the int8 executor
    y    = run(x)                                   # inference
    rep  = gate.latency_report("ARRIA10", *fit.best)  # Table-1 model

Everything runs on ``device`` (CUDA unless the caller names another).
The DSE and the latency report are the JAX package's FPGA models: they
score the paper's boards, and their figures are modeled FPGA
utilizations and latencies, not times on the card.

Modes:
  * ``emulation`` — the int8 executor on the device, ready to call: the
    stage loop runs on the host, one op after another.
  * ``fullflow``  — on the card, the executor captured as one CUDA graph
    per input shape (:class:`CapturedExecutor`), the counterpart of the
    JAX package's ahead-of-time compiled executable; a call replays the
    whole network in one launch.  Building it (the stand-in for the
    bitstream build) warms the executor up and captures the batch-1
    sample; the time it took is ``synthesis_time_s``.  On the CPU, where
    there is nothing to capture, it is the executor run once on a zero
    sample.  Identical numerics in every mode.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models.cnn import collect_activations
from . import dse as dse_mod
from . import parser as P
from . import pipeline as pipe
from . import telemetry as tele
from .graph import Graph
from .quantize import (INT8_MAX, MAX_SHIFT, QuantSpec, best_pow2_exponent,
                       best_pow2_exponents_per_channel)
from .resources import FPGA_BOARDS, fpga_layer_time_s
from .spaces import CNNDesignSpace


@dataclasses.dataclass
class LayerTiming:
    name: str
    kind: str
    time_s: float
    t_compute: float
    t_memory: float
    macs: int


@dataclasses.dataclass
class LatencyReport:
    """The Table-1 FPGA latency model of one design point: modeled
    seconds on the named board, not a time on the card."""

    board: str
    n_i: int
    n_l: int
    layers: List[LayerTiming]

    @property
    def total_s(self) -> float:
        return sum(l.time_s for l in self.layers)

    @property
    def gops(self) -> float:
        total_ops = 2 * sum(l.macs for l in self.layers)
        return total_ops / self.total_s / 1e9


class CapturedExecutor:
    """The fullflow executor on the card: the eager executor ``run``
    captured as one ``torch.cuda.CUDAGraph`` per input shape.

    Capturing a shape first runs the executor once on a side stream (the
    warm-up: every kernel library is built and loaded, shared-memory
    allowances are set and the weights' TMA descriptors are encoded, all
    of which happen once), then records one forward into a graph whose
    input and output are static buffers in the graph's own memory pool.
    A call copies the request into the static input outside the graph,
    replays the graph, and returns a clone of the static output (a later
    call overwrites the static output, never a result already returned).
    A shape not seen before is captured at its first call.  A capture
    that fails raises: nothing falls back to the eager executor.

    The kernel wrappers' launch counts (``ops.launch_counts``) move at
    warm-up and capture only; a replay launches the recorded kernels
    without calling the wrappers.

    **Telemetry.**  Every capture is recorded as a ``captured.capture``
    span (warm-up and capture, ``shape`` in its args) on
    ``setup_tracer`` (default: the process tracer).  ``tracer`` is off
    (None) by default, and then a call does nothing but test it.  Set to
    a :class:`~.telemetry.Tracer`, each call records ``captured.call``
    with three children, all with the call's sequence number as request
    id: ``captured.copy_in`` (the request onto the device and into the
    static input), ``captured.replay`` (the host's enqueue of the graph
    launch) and ``captured.clone_out``.  It also counts the captures
    made inside a call (after the build, a rebuild) in the counter
    ``captured.captures`` of ``registry``, the process registry unless
    replaced before the first traced call.

    **Stage map.**  Given ``stage_ops``, the per-stage callback that the
    gate passed to ``pipeline.make_executor`` for ``run``, a capture
    also records ``stage_map[shape]``: ``[(stage, kind, n_ops)]`` in
    schedule order, with ``ingress`` and ``egress`` as pseudo-stages,
    where ``n_ops`` is the kernel, memcpy and memset nodes that the
    stage put into the graph.  The graph is one chain captured on one
    stream, so a replay runs them in that order, and the map puts each
    device operation of a replay under its stage."""

    #: the children of ``captured.call``, in order
    STEPS = ("captured.copy_in", "captured.replay", "captured.clone_out")

    def __init__(self, run: Callable, device: torch.device,
                 setup_tracer: Optional[tele.Tracer] = None,
                 stage_ops: Optional["StageOps"] = None):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph runs on CUDA, not {device}")
        self.run = run
        self.device = device
        self.design_point = run.design_point
        #: input shape -> (graph, static input, static output)
        self.graphs: Dict[Tuple[int, ...], Tuple[torch.cuda.CUDAGraph,
                                                 torch.Tensor,
                                                 torch.Tensor]] = {}
        #: input shape -> [(stage, kind, device operations)]
        self.stage_map: Dict[Tuple[int, ...],
                             List[Tuple[str, str, int]]] = {}
        #: the calls' tracer; None: off
        self.tracer: Optional[tele.Tracer] = None
        self.setup_tracer = (setup_tracer if setup_tracer is not None
                             else tele.get_tracer())
        #: where ``captured.captures`` goes (read at its first count)
        self.registry = tele.get_registry()
        self.stage_ops = stage_ops
        self._seq = 0
        self._captures = None

    def capture(self, shape: Tuple[int, ...]) -> torch.cuda.CUDAGraph:
        """Warm up and capture the executor at ``shape``; return the
        graph."""
        with self.setup_tracer.span("captured.capture", cat="setup",
                                    args={"shape": list(shape)}):
            x = torch.zeros(shape, dtype=torch.float32, device=self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.run(x)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            ops = self.stage_ops
            if ops is None:
                with torch.cuda.graph(graph):
                    y = self.run(x)
            else:
                ops.open()          # before the capture: it may build
                try:
                    with torch.cuda.graph(graph):
                        y = self.run(x)
                finally:
                    rows = ops.close()
            self.graphs[shape] = (graph, x, y)
            if ops is not None:
                self.stage_map[shape] = rows
        return graph

    @torch.no_grad()
    def __call__(self, x_float) -> torch.Tensor:
        if self.tracer is not None:
            return self._traced_call(x_float)
        x = torch.as_tensor(x_float, dtype=torch.float32, device=self.device)
        shape = tuple(x.shape)
        if shape not in self.graphs:
            self.capture(shape)
        graph, x_static, y_static = self.graphs[shape]
        x_static.copy_(x)
        graph.replay()
        return y_static.clone()

    def _traced_call(self, x_float) -> torch.Tensor:
        """A call with :attr:`tracer` set: the untraced call's work, with
        four clock readings and one record."""
        clock = time.perf_counter_ns
        t0 = clock()
        x = torch.as_tensor(x_float, dtype=torch.float32, device=self.device)
        shape = tuple(x.shape)
        if shape not in self.graphs:
            if self._captures is None:
                self._captures = self.registry.counter("captured.captures")
            self._captures.inc()
            self.capture(shape)
        graph, x_static, y_static = self.graphs[shape]
        x_static.copy_(x)
        t1 = clock()
        graph.replay()
        t2 = clock()
        y = y_static.clone()
        t3 = clock()
        self._seq += 1
        self.tracer.record("captured.call", t0, t3, self._seq, None, "", None,
                           self.STEPS, (t0, t1, t2, t3))
        return y


class StageOps:
    """The per-stage callback of a captured executor's closure
    (``make_executor(on_stage=...)``): between :meth:`open` and
    :meth:`close` of a capture, after each stage, the stage's name and
    kind and the device operations it added to the graph under capture
    (:func:`repro_torch.kernels.capture_info.captured_ops`).  Outside a
    capture it records nothing.  :meth:`open` loads the C entry, so it
    is called before the capture begins: neither nvcc nor a library
    load runs while the stream captures."""

    def __init__(self, device: torch.device):
        self.device = device
        self._rows: Optional[List[Tuple[str, str, int]]] = None
        self._seen = 0
        self._count = None

    def open(self) -> None:
        from repro_torch.kernels import capture_info
        capture_info.load()
        self._count = capture_info.captured_ops
        self._rows, self._seen = [], 0

    def close(self) -> Optional[List[Tuple[str, str, int]]]:
        rows, self._rows = self._rows, None
        return rows

    def __call__(self, stage: str, kind: str) -> None:
        if self._rows is None:
            return
        n = sum(self._count(self.device))
        self._rows.append((stage, kind, n - self._seen))
        self._seen = n


class CNN2Gate:
    """Parse -> (apply quantization) -> verify -> explore -> build -> run.

    Set-up is recorded on ``tracer`` (default: the process tracer, as the
    guard and the DSE do): ``gate.parse`` (:meth:`from_graph`),
    ``gate.quantize`` (:meth:`apply_quantization`, with the spans of
    ``pipeline.build_quantized`` inside) and ``gate.build`` (with, in
    fullflow on the card, ``captured.capture``)."""

    def __init__(self, parsed: P.ParsedModel,
                 device: _device.DeviceLike = None,
                 tracer: Optional[tele.Tracer] = None):
        self.parsed = parsed
        self.device = _device.resolve(device)
        self.tracer = tracer if tracer is not None else tele.get_tracer()
        self.quantized: Optional[pipe.QuantizedModel] = None
        self.specs: Optional[Dict[str, QuantSpec]] = None

    # ---------------------------------------------------------- front end
    @classmethod
    def from_graph(cls, graph: Graph, fuse_skip: bool = True,
                   fuse_concat: bool = True,
                   device: _device.DeviceLike = None,
                   tracer: Optional[tele.Tracer] = None) -> "CNN2Gate":
        """``fuse_skip=False`` keeps residual adds as standalone merge
        stages and ``fuse_concat=False`` keeps channel concats as
        standalone copies — the bit-exact fallback programs."""
        tracer = tracer if tracer is not None else tele.get_tracer()
        with tracer.span("gate.parse", cat="setup"):
            parsed = P.parse(graph, fuse_skip=fuse_skip,
                             fuse_concat=fuse_concat)
        return cls(parsed, device=device, tracer=tracer)

    @classmethod
    def from_file(cls, path: str,
                  device: _device.DeviceLike = None) -> "CNN2Gate":
        from . import onnx_lite
        return cls.from_graph(onnx_lite.load(path), device=device)

    # ------------------------------------------------------- quantization
    def apply_quantization(self, specs: Dict[str, QuantSpec],
                           per_channel: Optional[bool] = None) -> None:
        """Apply *given* per-layer (N, m) pairs (§4.2 Physical domain).
        ``per_channel`` is forwarded to :func:`pipeline.build_quantized`
        (None: honour the specs as given)."""
        self.specs = specs
        with self.tracer.span("gate.quantize", cat="setup"):
            self.quantized = pipe.build_quantized(
                self.parsed, specs, per_channel=per_channel,
                device=self.device, tracer=self.tracer)

    def calibrate_quantization(self, sample_input,
                               per_channel: bool = False
                               ) -> Dict[str, QuantSpec]:
        """Convenience PTQ (stand-in for the user's external tool) — a
        graph pass over the DAG stage program, the JAX package's rule
        for rule.  The float activations come from
        :func:`~repro_torch.models.cnn.collect_activations` on the
        gate's device, in full float32.

        1. *stats* — max-abs power-of-two exponent for every named
           tensor in the stage program;
        2. *branch-aware alignment* — the operands of every int8
           ``Add``/``Concat`` form a scale group pinned at the group
           minimum (shift-only arithmetic cannot scale up), iterated to
           fixpoint because groups chain through stacked residuals;
        3. *forward threading* — each weighted stage's ``m_x`` is its
           input tensor's position and ``m_y`` is capped at
           ``m_w + m_x`` (non-negative requant shift); pools pass scale
           through; merges emit a ``QuantSpec(0, m_common, m_y)``.

        ``per_channel=True`` computes per-output-channel weight
        exponents (``m_w`` a length-Cout tuple); activations stay
        per-tensor, and the non-negative-shift cap uses the minimum lane
        exponent."""
        pm = self.parsed
        sample = (sample_input.cpu().numpy() if torch.is_tensor(sample_input)
                  else np.asarray(sample_input, np.float32))
        acts = collect_activations(pm.graph, sample, device=self.device)
        acts[pm.input_name] = sample
        weights = pm.graph.initializers

        # pass 1: per-tensor desired positions from activation stats
        desired: Dict[str, int] = {}
        for li in pm.layers:
            tensors = list(li.inputs) + [li.output]
            if li.merge is not None:
                tensors += list(li.merge.inputs) + [li.merge.output]
            for t in tensors:
                if t not in desired:
                    desired[t] = best_pow2_exponent(acts[t])
        desired.setdefault(pm.input_name,
                           best_pow2_exponent(acts[pm.input_name]))

        # pass 2: merge-operand scale groups -> group minimum (fixpoint)
        changed = True
        while changed:
            changed = False
            for li in pm.layers:
                if li.kind in (P.ADD, P.CONCAT):
                    operands = li.inputs
                elif li.merge is not None:
                    operands = li.merge.inputs
                else:
                    continue
                m = min(desired[t] for t in operands)
                for t in operands:
                    if desired[t] != m:
                        desired[t] = m
                        changed = True

        # pass 3: forward threading over the schedule
        tensor_m: Dict[str, int] = {pm.input_name: desired[pm.input_name]}
        specs: Dict[str, QuantSpec] = {}
        for li in pm.layers:
            if li.kind in (P.CONV, P.FC):
                if per_channel:
                    m_w = best_pow2_exponents_per_channel(weights[li.weight])
                    m_w_cap = min(m_w)  # every lane's shift must be >= 0
                else:
                    m_w = m_w_cap = best_pow2_exponent(weights[li.weight])
                m_x = tensor_m[li.inputs[0]]

                def lane_clamp(m_w, m_y):
                    # keep every lane's shift m_w[c]+m_x-m_y inside the
                    # int32 round-half-up datapath
                    if not per_channel:
                        return m_w
                    return tuple(min(mw, MAX_SHIFT + m_y - m_x)
                                 for mw in m_w)

                if li.merge is not None:
                    # the conv's own spec scales its intermediate tensor;
                    # the folded merge gets the spec a standalone Add
                    # stage would have received
                    m_int = min(desired[li.merge_intermediate],
                                m_w_cap + m_x)
                    specs[li.name] = QuantSpec(
                        m_w=lane_clamp(m_w, m_int), m_x=m_x, m_y=m_int)
                    m_common = min(m_int, tensor_m[li.skip_input])
                    m_y = min(desired[li.merge.output], m_common)
                    specs[li.merge.name] = QuantSpec(
                        m_w=0, m_x=m_common, m_y=m_y)
                else:
                    m_y = min(desired[li.output], m_w_cap + m_x)
                    specs[li.name] = QuantSpec(
                        m_w=lane_clamp(m_w, m_y), m_x=m_x, m_y=m_y)
                tensor_m[li.output] = m_y
            elif li.kind == P.POOL:
                tensor_m[li.output] = tensor_m[li.inputs[0]]
            else:  # add / concat
                m_common = min(tensor_m[t] for t in li.inputs)
                if li.kind == P.ADD:
                    m_y = min(desired[li.output], m_common)
                else:  # concat never rescales its operands' values
                    m_y = m_common
                specs[li.name] = QuantSpec(m_w=0, m_x=m_common, m_y=m_y)
                tensor_m[li.output] = m_y
        self.apply_quantization(specs)
        return specs

    @property
    def per_channel(self) -> bool:
        """True when the *built* program runs any per-channel weight
        spec (``apply_quantization(..., per_channel=True)`` widens scalar
        specs inside ``build_quantized``, so the specs alone would
        under-report the datapath)."""
        if self.quantized is not None:
            return any(ql.spec is not None and ql.spec.per_channel
                       for ql in self.quantized.layers)
        return bool(self.specs) and any(
            s.per_channel for s in self.specs.values())

    def verify(self, **kw):
        """Run the static design-rule checks (:mod:`.verify`) over the
        current program and return the
        :class:`~.verify.VerificationReport`.  With a built program the
        staged int8 weights feed the overflow bounds; with only specs
        applied the verifier re-quantizes from the graph initializers.
        Keyword args forward to ``verify_program`` (``vmem_budget=``,
        ``checkpoints=``, ...)."""
        from . import verify as verify_mod
        if self.quantized is not None:
            return verify_mod.verify_quantized(self.quantized, **kw)
        if self.specs is None:
            raise RuntimeError("apply_quantization() or "
                               "calibrate_quantization() first")
        return verify_mod.verify_program(self.parsed, self.specs, **kw)

    def design_space(self, board: str,
                     block_h_options: Optional[List[int]] = None
                     ) -> CNNDesignSpace:
        return CNNDesignSpace(self.parsed, FPGA_BOARDS[board],
                              block_h_options=block_h_options,
                              per_channel=self.per_channel,
                              specs=self.specs)

    def explore(self, board: str, algo: str = "rl",
                thresholds: Optional[Dict[str, float]] = None,
                eval_cost_s: float = 0.0,
                block_h_options: Optional[List[int]] = None,
                **kw) -> dse_mod.DSEResult:
        """Hardware-aware DSE over the paper's board ``board``.  With
        ``block_h_options`` the space grows a third axis — the conv
        kernel's row-band height — and options whose row-band working
        set exceeds the on-chip budget are rejected by the resource
        model.  The result is an FPGA design point; the executor takes
        it (``build(mode, *best)``) and leaves its CUDA tiles to the
        kernels' shape-driven plans."""
        space = self.design_space(board, block_h_options=block_h_options)
        if algo == "bf":
            return dse_mod.brute_force(space, thresholds, eval_cost_s)
        if algo == "rl":
            return dse_mod.rl_dse(space, thresholds,
                                  eval_cost_s=eval_cost_s, **kw)
        raise ValueError(f"unknown DSE algorithm {algo!r}")

    # -------------------------------------------------------------- build
    def build(self, mode: str = "emulation", n_i: int = 16, n_l: int = 32,
              block_h: Optional[int] = None
              ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Return the whole-network int8 executor on the gate's device.

        emulation: the executor, ready to call.
        fullflow : on the card, a :class:`CapturedExecutor` with the
        batch-1 sample captured (``self.compiled`` is its graph); on the
        CPU, the executor after one run on a zero sample
        (``self.compiled`` is None).  ``synthesis_time_s`` records the
        warm-up and capture, or that run.

        Each build adds the stage program's merges, pools, clamps and
        grouped convs to five counters of the process registry:
        ``build.fused_skips`` (adds folded into a conv's epilogue),
        ``build.standalone_merges`` (add and concat stages that run as
        their own op; a concat whose producers write its buffer is not
        one), ``build.standalone_pools`` (pools that no conv epilogue
        took), ``build.clipped_stages`` (stages whose epilogue clamps
        below 127: a fused ReLU-n, ``QuantizedLayer.hi``) and
        ``build.grouped_stages`` (conv stages on the grouped route,
        ``qconv.qgconv2d``: 1 < group, not the depthwise kernel's).
        """
        if self.quantized is None:
            raise RuntimeError("apply_quantization() or "
                               "calibrate_quantization() first")
        if mode not in ("emulation", "fullflow"):
            raise ValueError(f"unknown mode {mode!r}")
        with self.tracer.span("gate.build", cat="setup",
                              args={"mode": mode}):
            self._count_stages()
            return self._build(mode, n_i, n_l, block_h)

    def _count_stages(self) -> None:
        layers = self.parsed.layers
        reg = tele.get_registry()
        reg.counter("build.fused_skips").inc(
            sum(li.merge is not None for li in layers))
        reg.counter("build.standalone_merges").inc(
            sum(li.kind == P.ADD or (li.kind == P.CONCAT
                                     and not li.concat_fused)
                for li in layers))
        reg.counter("build.standalone_pools").inc(
            sum(li.kind == P.POOL for li in layers))
        reg.counter("build.clipped_stages").inc(
            sum(ql.hi < INT8_MAX for ql in self.quantized.layers))
        reg.counter("build.grouped_stages").inc(
            sum(li.kind == P.CONV and li.group > 1 and not li.is_dw_kernel
                for li in layers))

    def _build(self, mode: str, n_i: int, n_l: int,
               block_h: Optional[int]):
        captured = mode == "fullflow" and self.device.type == "cuda"
        stage_ops = StageOps(self.device) if captured else None
        run = pipe.make_executor(self.quantized, n_i, n_l,
                                 block_h=block_h, on_stage=stage_ops)
        if mode == "emulation":
            return run
        shape = (1,) + tuple(self.parsed.input_shape[1:])
        t0 = time.perf_counter()
        if captured:
            run = CapturedExecutor(run, self.device,
                                   setup_tracer=self.tracer,
                                   stage_ops=stage_ops)
            self.compiled = run.capture(shape)
            torch.cuda.synchronize(self.device)
        else:
            run(torch.zeros(shape, dtype=torch.float32, device=self.device))
            self.compiled = None
        self.synthesis_time_s = time.perf_counter() - t0
        return run

    def build_guarded(self, x_cal=None, policy=None,
                      qm: Optional[pipe.QuantizedModel] = None,
                      faults: Optional[Dict] = None, n_i: int = 16,
                      n_l: int = 32, block_h: Optional[int] = None,
                      checkpoints=None):
        """Guarded-execution build, on the gate's device.

        With ``policy=None`` guards are OFF and this returns the plain
        :func:`pipeline.make_executor` closure — the eager executor of
        ``build("emulation")``, making the same ops calls.

        With a :class:`~.guard.GuardPolicy`, returns a
        :class:`~.guard.GuardedExecutor` whose calls yield ``(logits,
        GuardReport)``: per-stage dequant audits against envelopes
        calibrated on ``x_cal`` from the *golden* program, plus the
        checkpoint-replay → reexecute → unfused → per-tensor degradation
        ladder.  ``qm``/``faults`` deploy a fault-injected program under
        the guard (defaults: the golden program, no faults);
        ``checkpoints`` (an int K or explicit boundary indices) arms the
        stage-boundary recovery rung.  A guarded executor reads its
        audit back after every run, so it is never captured as a CUDA
        graph."""
        if self.quantized is None:
            raise RuntimeError("apply_quantization() or "
                               "calibrate_quantization() first")
        if policy is None:
            return pipe.make_executor(qm or self.quantized, n_i, n_l,
                                      block_h=block_h)
        if x_cal is None:
            raise ValueError("guarded mode needs a calibration input "
                             "(x_cal) to record audit envelopes")
        from . import guard as guard_mod
        return guard_mod.GuardedExecutor(
            self, x_cal, policy=policy, qm=qm, faults=faults,
            n_i=n_i, n_l=n_l, block_h=block_h, checkpoints=checkpoints)

    # ------------------------------------------------------ latency model
    def latency_report(self, board: str, n_i: int, n_l: int) -> LatencyReport:
        """Analytical Table-1/Fig-6 FPGA latency model (see
        resources.py): modeled seconds on ``board``, not a time on the
        card.  Walks the DAG schedule: merge stages are pure memory
        traffic (both operands stream once, zero MACs), so residual
        networks report the adder path the FPGA would pay."""
        profile = FPGA_BOARDS[board]
        rows: List[LayerTiming] = []
        for li in self.parsed.layers:
            in_b, w_b, out_b = pipe.layer_bytes(li)
            t, tc, tm = fpga_layer_time_s(profile, n_i, n_l, li.macs,
                                          in_b, w_b, out_b)
            rows.append(LayerTiming(li.name, li.kind, t, tc, tm, li.macs))
        return LatencyReport(board=board, n_i=n_i, n_l=n_l, layers=rows)

    # ------------------------------------------------------------ summary
    def summary(self) -> str:
        pm = self.parsed
        lines = [f"model {pm.name}: {len(pm.layers)} pipeline stages, "
                 f"{pm.total_ops / 1e9:.2f} GOp, "
                 f"{pm.total_weights / 1e6:.1f} M weights"]
        for li in pm.layers:
            kind = li.kind
            if li.is_depthwise:
                kind = "dwconv"
            elif li.kind == P.CONV and li.group > 1:
                kind = f"gconv[{li.group}]"
            fused = "+relu" if li.relu else ""
            fused += "+pool" if li.pool is not None else ""
            fused += "+softmax" if li.softmax else ""
            ins = (f" <- {len(li.inputs)} tensors"
                   if len(li.inputs) > 1 else "")
            lines.append(f"  {li.name:<12} {kind}{fused:<14} "
                         f"in={li.in_shape} out={li.out_shape} "
                         f"macs={li.macs / 1e6:.1f}M{ins}")
        return "\n".join(lines)

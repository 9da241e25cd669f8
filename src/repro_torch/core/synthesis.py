"""CNN2Gate automated synthesis workflow (§4.2, Fig. 4a) on PyTorch.

``CNN2Gate`` is the user-facing orchestrator:

    gate = CNN2Gate.from_graph(vgg16())            # ONNX-lite front end
    gate.calibrate_quantization(x)                  # or apply_quantization
    run  = gate.build(mode="emulation")             # int8 executor
    y    = run(x)                                   # inference

Everything runs on ``device`` (CUDA unless the caller names another).

Modes:
  * ``emulation`` — the int8 executor on the device, ready to call.
  * ``fullflow``  — the same executor, run once on a zero sample so
    the kernels are built and loaded before the first request; the
    time it took is ``synthesis_time_s`` (the stand-in for the
    bitstream build).  Identical numerics.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models.cnn import collect_activations
from . import parser as P
from . import pipeline as pipe
from .graph import Graph
from .quantize import (MAX_SHIFT, QuantSpec, best_pow2_exponent,
                       best_pow2_exponents_per_channel)


class CNN2Gate:
    """Parse -> (apply quantization) -> build -> run."""

    def __init__(self, parsed: P.ParsedModel,
                 device: _device.DeviceLike = None):
        self.parsed = parsed
        self.device = _device.resolve(device)
        self.quantized: Optional[pipe.QuantizedModel] = None
        self.specs: Optional[Dict[str, QuantSpec]] = None

    # ---------------------------------------------------------- front end
    @classmethod
    def from_graph(cls, graph: Graph, fuse_skip: bool = True,
                   fuse_concat: bool = True,
                   device: _device.DeviceLike = None) -> "CNN2Gate":
        """``fuse_skip=False`` keeps residual adds as standalone merge
        stages and ``fuse_concat=False`` keeps channel concats as
        standalone copies — the bit-exact fallback programs."""
        return cls(P.parse(graph, fuse_skip=fuse_skip,
                           fuse_concat=fuse_concat), device=device)

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
        self.quantized = pipe.build_quantized(self.parsed, specs,
                                              per_channel=per_channel,
                                              device=self.device)

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

    # -------------------------------------------------------------- build
    def build(self, mode: str = "emulation", n_i: int = 16, n_l: int = 32,
              block_h: Optional[int] = None
              ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Return the whole-network int8 executor on the gate's device.

        emulation: the executor, ready to call.
        fullflow : the executor after one run on a zero sample (kernels
        built and loaded); ``synthesis_time_s`` records that run.
        """
        if self.quantized is None:
            raise RuntimeError("apply_quantization() or "
                               "calibrate_quantization() first")
        if mode not in ("emulation", "fullflow"):
            raise ValueError(f"unknown mode {mode!r}")
        run = pipe.make_executor(self.quantized, n_i, n_l, block_h=block_h)
        if mode == "fullflow":
            sample = torch.zeros((1,) + tuple(self.parsed.input_shape[1:]),
                                 dtype=torch.float32, device=self.device)
            t0 = time.perf_counter()
            run(sample)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.synthesis_time_s = time.perf_counter() - t0
        return run

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

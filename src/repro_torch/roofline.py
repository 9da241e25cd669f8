"""Roofline analysis from a traced step (no card needed).

The counterpart of ``repro.roofline``.  Three terms per (arch × shape ×
mesh) cell, each in seconds a step, on the H100's data-sheet constants
(``core/resources.H100``: 989 TFLOP/s dense bf16, 3.35 TB/s HBM, and
NVLink 4's 450 GB/s each way per card):

  compute    = per-device FLOPs            / peak FLOP/s
  memory     = per-device bytes            / HBM bandwidth
  collective = per-device collective bytes / NVLink bandwidth

The JAX package reads these from XLA's compiled program; the port reads
them from a trace of the step on each rank's local shards
(:class:`TraceCounter`, run by ``launch/dryrun.py`` on a fake process
world under ``FakeTensorMode``):

  * FLOPs: matmul, convolution and attention FLOPs of the local ops
    (``torch.utils.flop_counter``'s formulas on the shard shapes);
  * ``bytes_per_dev``: operand plus result bytes of every local op that
    is not a view (the unfused bound);
  * ``essential_bytes_per_dev``: the same for the heavy ops only
    (matmuls, convolutions, gathers, index/scatter ops and slice copies),
    with the flash accounting of the JAX package: tensors whose last two
    dimensions are a (seq, chunk) score tile stay on chip;
  * collectives: counts and bytes per kind from the functional
    collectives DTensor issues and the explicit ones, bytes from the
    local operand shapes, an all-reduce counted twice (reduce-scatter +
    all-gather phases on a ring);
  * the peak of live local bytes.

The NVLink rate is that of one 8-card NVLink domain; a mesh larger than
a host also crosses the network, which this bound does not charge.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Set, Tuple

import torch

from repro_torch.core.resources import H100

PEAK_FLOPS = H100.peak_bf16_flops         # dense bf16 tensor-core peak
PEAK_INT8 = H100.peak_int8_ops
HBM_BW = H100.hbm_bandwidth               # bytes/s
NVLINK_BW = H100.nvlink_bandwidth         # bytes/s each way, all links

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                "all-to-all", "collective-permute")

#: aten / c10d op names (the overload packet's name) -> collective kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}

#: ops whose operands/results round-trip HBM even under perfect
#: elementwise fusion
_HEAVY_OPS = ("mm", "addmm", "bmm", "baddbmm", "convolution", "gather",
              "index", "index_select", "scatter", "scatter_add",
              "index_put", "index_add", "embedding", "slice_scatter",
              "copy", "_scaled_dot_product_flash_attention",
              "_scaled_dot_product_efficient_attention")


#: ops that allocate, alias or wait and move no bytes of their own
_NO_TRAFFIC = ("empty", "empty_strided", "new_empty", "empty_like",
               "wait_tensor", "detach", "alias", "lift_fresh",
               "_unsafe_view", "_to_copy_meta")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


class TraceCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts a step's local work, per rank, as it runs.

    A dispatch mode sees an op on DTensors before DTensor does; it
    declines those (``NotImplemented``), so DTensor propagates the
    layouts and runs the op on the local shards, which the mode then
    sees and counts with their local shapes.  DTensor's own shape
    inference runs ops on global-shape stand-ins; those are not the
    step's work and are not counted (see :meth:`shadow`).

    ``track(t)`` adds a tensor that exists before the step (parameters,
    optimizer state, the batch) to the live bytes; every output storage
    counts from its creation to its release, and ``peak_bytes`` is the
    most that was live at once."""

    def __init__(self, exclude_trailing: Optional[Set[Tuple[int, int]]] = None):
        super().__init__()
        self.exclude = exclude_trailing or set()
        self.flops = 0.0
        self.bytes = 0.0
        self.essential = 0.0
        self.counts = {k: 0 for k in _COLLECTIVES}
        self.coll_bytes = {k: 0.0 for k in _COLLECTIVES}
        self.live = 0
        self.peak_bytes = 0
        self._seen: "weakref.WeakSet" = weakref.WeakSet()
        self._shadow = 0
        self._inner = 0

    # -- live bytes
    def track(self, t: torch.Tensor) -> None:
        from repro_torch.sharding import is_dtensor
        if is_dtensor(t):
            t = t.to_local()
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    # -- DTensor's shape inference
    def shadow(self):
        """Wrap DTensor's global-shape inference so that the ops it runs
        are not counted.  Returns an undo callable."""
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        names = ("propagate", "_propagate_tensor_meta_non_cached")
        origs = {n: getattr(prop, n, None) for n in names}
        if origs["propagate"] is None:
            raise RuntimeError(
                "this torch's DTensor has no ShardingPropagator.propagate: "
                "the dry run cannot tell its sharding propagation from "
                "the step's own ops")

        def shadowed(orig):
            def wrapped(*a, **kw):
                self._shadow += 1
                try:
                    return orig(*a, **kw)
                finally:
                    self._shadow -= 1
            return wrapped
        for n, orig in origs.items():
            if orig is not None:
                setattr(prop, n, shadowed(orig))

        def undo():
            for n, orig in origs.items():
                if orig is not None:
                    setattr(prop, n, orig)
        return undo

    # -- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._inner:
            # an op run inside another op's implementation (a fake
            # tensor's decomposition, run or skipped by its cache): the
            # outer op is what the step does
            return func(*args, **kwargs)
        self._inner += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self._inner -= 1
        if not self._shadow:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils._pytree import tree_leaves
        name = func.overloadpacket.__name__
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            if name != "wait_tensor":
                b = float(sum(_nbytes(t) for t in outs[:1] or ins[:1]))
                if kind == "all-reduce":
                    b *= 2     # reduce-scatter + all-gather phases
                self.counts[kind] += 1
                self.coll_bytes[kind] += b
            return
        for o in outs:
            if o.untyped_storage() not in self._seen and not func.is_view:
                self.track(o)
        if func.is_view or name in _NO_TRAFFIC or not outs:
            return
        from torch.utils.flop_counter import flop_registry
        fl = flop_registry.get(func.overloadpacket)
        if fl is not None:
            self.flops += float(fl(*args, out_val=out, **kwargs))
        moved = float(sum(_nbytes(t) for t in ins + outs))
        self.bytes += moved
        if name.rstrip("_") in _HEAVY_OPS:
            self.essential += float(sum(
                _nbytes(t) for t in ins + outs
                if not (t.ndim >= 2 and (t.shape[-2], t.shape[-1])
                        in self.exclude)))

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.counts), dict(self.coll_bytes))


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float         # every local op's operands + results
    collective_bytes_per_dev: float
    t_compute: float
    t_memory: float              # raw bytes / HBM_bw (pessimistic)
    t_collective: float
    model_flops: float           # 6·N·D or 2·N·D_tok, whole step
    peak_bytes_per_dev: float    # live-bytes peak of the traced step
    collective_counts: Dict[str, int]
    essential_bytes_per_dev: float = 0.0   # fused-traffic bound
    t_memory_fused: float = 0.0

    @property
    def dominant(self) -> str:
        """Bottleneck under the fused-memory estimate (both memory
        bounds are reported)."""
        terms = {"compute": self.t_compute,
                 "memory": self.t_memory_fused or self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_step(self) -> float:
        """Lower-bound step time: max of the three overlapped terms
        (fused-memory estimate)."""
        return max(self.t_compute, self.t_memory_fused or self.t_memory,
                   self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (traced FLOPs × chips) — remat/redundancy waste."""
        total = self.flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the card-seconds the *useful* model FLOPs occupy —
        the MFU-style score (1.0 == roofline)."""
        denom = self.t_step * self.chips * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, t_step=self.t_step,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS per step: 6·N_active·D for training (fwd+bwd),
    2·N_active·D_tokens for inference cells (fwd only).  N excludes
    embedding tables (standard convention)."""
    n = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    tokens = shape.global_batch              # one new token per sequence
    return 2.0 * n * tokens

"""Sharding policies for the architecture fleet, on DTensor.

The counterpart of ``repro.sharding``.  A ``ShardingPolicy`` is one
option of the pod-scale design space: per parameter and activation it
decides how the ``(pod, data, model)`` mesh axes are used, under the
divisibility rules the paper applies to (N_i, N_l):

  * weights: 2-D "megatron" TP, column-parallel in and row-parallel out,
    experts on the model axis, the vocabulary padded to a shardable
    multiple;
  * activations: batch on (pod, data);
  * decode KV caches: the sequence on the model axis (plus data when the
    batch is 1), consumed by flash-decoding over the shards;
  * a dimension the axis does not divide stays replicated.

Specs are tuples with one entry per tensor dimension: None, a mesh-axis
name, or a tuple of names (that dimension sharded over several axes,
major first), entry for entry what ``jax.sharding.PartitionSpec`` holds
in the JAX package.  :func:`placements` maps a spec onto DTensor
placements (``Shard(i)`` / ``Replicate()`` per mesh dimension), and the
policy lays tensors out with ``distribute_tensor`` and ``redistribute``.

The JAX package stacks layers with a leading L dimension that its rules
pad with None; the port holds one module per layer, so the same rule
applies without the padding.  A parameter's rule is looked up by its
name in the JAX package's tree (``"stack.3.attn.wq"`` is
``stack/attn/wq``).

The model runs on DTensors under a policy (``Model(cfg, policy=...)``):
DTensor propagates the layouts through the projections, norms and the
loss, and inserts the collectives.  Attention, the SSD scan, the MoE
experts and the cache writes run on each rank's local shards
(:meth:`ShardingPolicy.local_attention`, :meth:`local_ssd`,
:meth:`local_moe`, :meth:`update_kv_cache`), so the flash and SSD
kernels see plain local tensors, as each TPU device runs the Pallas
kernel on its shard under GSPMD; a DTensor handed to a kernel wrapper
raises.
"""
from __future__ import annotations

import dataclasses
import math
import types
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig

Spec = Tuple[Any, ...]

# rule table: leaf-name -> spec builder over (model_axis,)
# a rule is a tuple pattern where "M" marks the model-sharded dim.
_PARAM_RULES: Dict[str, Tuple] = {
    # embeddings / head
    "embed": ("M", None),
    "lm_head": (None, "M"),
    "dec_pos": (None, None),
    # attention
    "wq": (None, "M"), "wk": (None, "M"), "wv": (None, "M"),
    "wo": ("M", None),
    "bq": ("M",), "bk": ("M",), "bv": ("M",),
    "q_norm": (None,), "k_norm": (None,),
    # mlp
    "w_gate": (None, "M"), "w_up": (None, "M"), "w_down": ("M", None),
    "b_up": ("M",), "b_down": (None,),
    # moe (expert-parallel on the model axis)
    "router": (None, None),
    "moe/w_gate": ("M", None, None), "moe/w_up": ("M", None, None),
    "moe/w_down": ("M", None, None),
    # norms
    "scale": (None,), "bias": (None,),
    # mamba2 (d_inner / heads on the model axis; B/C per-group replicated)
    "w_z": (None, "M"), "w_x": (None, "M"),
    "w_b": (None, None), "w_c": (None, None), "w_dt": (None, "M"),
    "conv_x": (None, "M"), "conv_b": (None, None), "conv_c": (None, None),
    "conv_bias_x": ("M",), "conv_bias_b": (None,), "conv_bias_c": (None,),
    "a_log": ("M",), "dt_bias": ("M",), "d_skip": ("M",),
    "gate_norm": ("M",), "w_out": ("M", None),
}


@dataclasses.dataclass
class PolicyOptions:
    """The DSE-explorable knobs of a sharding policy."""

    shard_model: bool = True          # use the model axis at all
    shard_activation_heads: bool = True
    seq_shard_decode: bool = True     # flash-decoding over sharded caches
    zero1: bool = True                # optimizer state sharded on data
    remat: str = "dots"
    activation_dp: bool = True        # constrain (B,S,D) batch to data axes
    # Megatron-style sequence parallelism: residual-stream activations
    # sharded (batch -> data, seq -> model); norms/elementwise go local,
    # TP all-reduces become reduce-scatter + all-gather pairs, and
    # activation residency drops by the model-axis size.
    sequence_parallel: bool = False
    n_micro: int = 1                  # gradient-accumulation microbatches
    zero2_grads: bool = False         # reduce-scatter grads (ZeRO-2)


# ------------------------------------------------------------------ meshes

class AbstractMesh:
    """A mesh's axis names and sizes and nothing else: enough for a
    policy's specs (``param_specs``, ``batch_specs``, ``cache_spec``,
    ``optimizer_spec``) without a process world, e.g. the 16 x 16
    production shape in a single process."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]):
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """(axis names, {name: size}) of a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), {n: int(s) for n, s in zip(names, mesh.shape)}
    return tuple(mesh.axis_names), {n: int(mesh.shape[n])
                                    for n in mesh.axis_names}


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension, ``Shard(i)`` where tensor dimension i's entry names it,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names, _ = mesh_axes(mesh)
    out = []
    for name in names:
        dims = [i for i, e in enumerate(spec) if name in _axes_of(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def spec_of(t) -> Spec:
    """The spec of a DTensor's placements (Partial counts as
    replicated): the inverse of :func:`placements`."""
    from torch.distributed.tensor import Shard
    names, _ = mesh_axes(t.device_mesh)
    entries: list = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e))
                 for e in entries)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    local region's gradient can come back transposed, and DTensor takes
    a shard's strides to be those of a contiguous tensor."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def to_local(t: torch.Tensor, mesh, spec: Spec,
             varying: Sequence[str] = ()) -> torch.Tensor:
    """This rank's shard of ``t`` laid out by ``spec``: a DTensor is
    redistributed (collectives where its layout differs) and taken
    ``to_local``; a plain tensor, the same global value on every rank,
    is cut without communication.

    ``varying`` names the mesh axes along which the local computation
    that reads the shard differs from rank to rank (its other inputs are
    sharded there).  Along such an axis, where ``t`` is replicated, each
    rank's gradient is only its part of the whole: the gradient comes
    back as a pending sum (``Partial``) over that axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    pl = placements(spec, mesh)
    if not isinstance(t, DTensor):
        if all(e is None for e in spec):
            return t
        t = DTensor.from_local(t, mesh, [Replicate()] * len(pl),
                               run_check=False)
    names, _ = mesh_axes(mesh)
    grad_pl = [p if isinstance(p, Shard) else
               Partial() if n in varying else Replicate()
               for n, p in zip(names, pl)]
    local = t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)
    if local.requires_grad and torch.is_grad_enabled():
        local = _ContiguousGrad.apply(local)
    return local


def _axes_in(*specs: Spec) -> Tuple[str, ...]:
    """Every mesh axis that some entry of ``specs`` shards over."""
    return tuple({a for spec in specs for e in spec for a in _axes_of(e)})


def from_local(t: torch.Tensor, mesh, spec: Spec):
    """The DTensor whose shard on this rank is ``t``, laid out by
    ``spec`` (every shard of the same shape)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements(spec, mesh),
                              run_check=False)


def _mesh_index(mesh, axes: Sequence[str]) -> int:
    """This rank's linear index over ``axes`` of ``mesh`` (the first
    axis major): its shard's position along a dimension sharded over
    them."""
    names, sizes = mesh_axes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(names.index(a))
    return idx


def _param_path(name: str) -> Tuple[str, ...]:
    """A parameter's path in the JAX package's tree: its port name
    without the layer indices."""
    return tuple(p for p in name.split(".") if not p.isdigit())


def _select_groups(t: torch.Tensor, dim: int, n_total: int, n_groups: int,
                   start: int, n_local: int) -> torch.Tensor:
    """The groups (along ``dim`` of ``t``, ``n_groups`` of them) that
    items ``start .. start + n_local`` of ``n_total`` map to, item i
    belonging to group ``i // (n_total / n_groups)``: a contiguous slice
    where the local items cover whole groups or lie in one, else one
    group per item."""
    per = n_total // n_groups
    if n_local % per == 0:
        return t.narrow(dim, start // per, n_local // per)
    if per % n_local == 0:
        return t.narrow(dim, start // per, 1)
    idx = (start + torch.arange(n_local, device=t.device)) // per
    return t.index_select(dim, idx)


# ------------------------------------------------------------------ policy

class ShardingPolicy:
    def __init__(self, mesh, cfg: ModelConfig,
                 options: Optional[PolicyOptions] = None):
        self.mesh = mesh
        self.cfg = cfg
        self.opt = options or PolicyOptions()
        axes, self.axis_sizes = mesh_axes(mesh)
        self.model_axis = "model" if "model" in axes else None
        self.dp_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in axes)
        self.model_size = (self.axis_sizes["model"]
                           if self.model_axis else 1)
        self.dp_size = (math.prod(self.axis_sizes[a] for a in self.dp_axes)
                        if self.dp_axes else 1)
        self.seq_sharded_decode = (self.opt.seq_shard_decode
                                   and self.model_axis is not None)
        self._decode_seq_axes: Optional[Tuple[str, ...]] = None

    @property
    def _dp(self):
        """The batch entry of a spec: the data axes, one or a tuple."""
        if not self.dp_axes:
            return None
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    # --------------------------------------------------------- param specs
    def _rule_for(self, path: Tuple[str, ...], ndim: int) -> Spec:
        name = path[-1]
        key = name
        if "moe" in path and name in ("w_gate", "w_up", "w_down"):
            key = f"moe/{name}"
        rule = _PARAM_RULES.get(key)
        if rule is None:
            return (None,) * ndim
        return tuple(
            (self.model_axis if (x == "M" and self.opt.shard_model
                                 and self.model_axis) else None)
            for x in rule)

    def param_specs(self, params: nn.Module) -> Dict[str, Spec]:
        """{parameter name: spec} of every parameter of ``params``."""
        return {n: self._validated(self._rule_for(_param_path(n), p.ndim),
                                   tuple(p.shape))
                for n, p in params.named_parameters()}

    def _validated(self, ps: Spec, shape: Tuple[int, ...]) -> Spec:
        """Divisibility guard: drop axes that do not divide the dim
        (the fitter's feasibility rule)."""
        fixed = []
        for dim, axis in zip(shape, tuple(ps) + (None,) * len(shape)):
            if axis is None:
                fixed.append(None)
                continue
            size = math.prod(self.axis_sizes[a] for a in _axes_of(axis))
            fixed.append(axis if dim % size == 0 else None)
        return tuple(fixed)

    def placements(self, spec: Spec) -> list:
        return placements(spec, self.mesh)

    def distribute(self, t: torch.Tensor, spec: Spec):
        """``t`` (the same full value on every rank) as a DTensor laid out
        by ``spec``: each rank keeps its own shard, no data moves.  A
        DTensor is redistributed to ``spec``."""
        from torch.distributed.tensor import DTensor, Replicate
        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, self.placements(spec))
        d = DTensor.from_local(t, self.mesh,
                               [Replicate()] * len(self.axis_sizes),
                               run_check=False)
        return d.redistribute(self.mesh, self.placements(spec))

    @torch.no_grad()
    def param_shardings(self, params: nn.Module) -> nn.Module:
        """Distribute ``params`` in place by :meth:`param_specs`: every
        parameter becomes a DTensor parameter holding this rank's shard
        (each rank holds the same full values beforehand, as every rank
        draws them from the same seed)."""
        specs = self.param_specs(params)
        for name, spec in specs.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = params.get_submodule(mod_name) if mod_name else params
            p = getattr(mod, leaf)
            mod.register_parameter(leaf, nn.Parameter(
                self.distribute(p.data, spec), requires_grad=p.requires_grad))
        return params

    # ----------------------------------------------------- batch/cache specs
    def batch_specs(self, batch: Dict[str, Any],
                    shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
        """The spec of every tensor of ``batch`` (nested dicts, a cache
        under ``"cache"``), as the JAX package's ``batch_specs``."""
        dp = self._dp

        def spec(names, leaf):
            nd = len(leaf.shape)
            shp = tuple(leaf.shape)
            if "cache" in names:
                return self._validated(self.cache_spec(names, nd, shp), shp)
            name = names[-1]
            if name == "positions" and nd == 3:   # (3, B, S) M-RoPE
                return self._validated((None, dp, None), shp)
            if name == "lengths":
                return self._validated((dp,), shp)
            if name in ("tokens", "labels"):
                return self._validated((dp, None), shp)
            if name in ("embeds", "audio_embeds"):
                return self._validated((dp, None, None), shp)
            return ()

        def walk(node, names):
            if isinstance(node, dict):
                return {k: walk(v, names + (k,)) for k, v in node.items()}
            return spec(names, node)
        return walk(batch, ())

    def cache_spec(self, names: Tuple[str, ...], ndim: int,
                   shape: Tuple[int, ...]) -> Spec:
        """Decode caches.  KV caches (…, B, KV, S, hd): batch on data,
        sequence on model (plus data when batch cannot use it).  Mamba
        states: batch on data, inner/heads on model."""
        dp = self._dp
        name = names[-1]
        if name in ("k", "v", "xk", "xv"):
            batch_dim = shape[-4]
            seq_axis: Any = None
            if self.seq_sharded_decode and name in ("k", "v"):
                seq_axis = self.model_axis
                if batch_dim == 1 and self.dp_axes:
                    seq_axis = self.dp_axes + (self.model_axis,)
                    dp = None
            lead = (None,) * (ndim - 4)
            self._decode_seq_axes = (
                seq_axis if isinstance(seq_axis, tuple)
                else ((seq_axis,) if seq_axis else None))
            return (*lead, dp if shape[-4] > 1 else None, None,
                    seq_axis, None)
        if name == "ssm":               # (L, B, H, P, N)
            lead = (None,) * (ndim - 4)
            return (*lead, dp if shape[-4] > 1 else None,
                    self.model_axis, None, None)
        if name.startswith("conv"):     # (L, B, K-1, C)
            lead = (None,) * (ndim - 3)
            return (*lead, dp if shape[-3] > 1 else None, None,
                    self.model_axis if name.endswith("x") else None)
        return ()

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """``batch`` (tensors or arrays, the same global values on every
        rank) as DTensors laid out by :meth:`batch_specs`; a ``cache``
        entry is left as it is (see :meth:`distribute_cache`)."""
        out = {k: v for k, v in batch.items()}
        tensors = {k: torch.as_tensor(v) for k, v in out.items()
                   if k != "cache" and not is_dtensor(v)}
        for k, s in self.batch_specs(tensors).items():
            out[k] = self.distribute(tensors[k], s)
        return out

    def distribute_cache(self, cache: Dict[str, Any]) -> Dict[str, Any]:
        """A cache (nested dicts of full tensors) laid out by
        :meth:`cache_spec`.  As in the JAX package, laying out a KV cache
        records the axes its sequence is sharded over, which
        :meth:`sharded_decode_attention` reads."""
        specs = self.batch_specs({"cache": cache})["cache"]

        def walk(node, spec):
            if isinstance(node, dict):
                return {k: walk(v, spec[k]) for k, v in node.items()}
            return self.distribute(node, spec)
        return walk(cache, specs)

    # ------------------------------------------------ activation constraints
    def _constrain(self, x, spec: Spec):
        if not is_dtensor(x):
            return x
        return x.redistribute(self.mesh, self.placements(spec))

    def act(self, x):
        """(B, S, D) residual-stream constraint: batch over data axes,
        plus sequence over the model axis when sequence_parallel."""
        if not self.opt.activation_dp or not self.dp_axes:
            return x
        dp = self._dp
        if x.shape[0] % self.dp_size != 0:
            return x
        if (self.opt.sequence_parallel and self.model_axis and x.ndim >= 3
                and x.shape[1] % self.model_size == 0):
            return self._constrain(
                x, (dp, self.model_axis, *(None,) * (x.ndim - 2)))
        return self._constrain(x, (dp, *(None,) * (x.ndim - 1)))

    def gathered(self, x):
        """Under ``sequence_parallel``, the residual stream's sequence
        gathered back (batch still on the data axes): what a block's
        projections read after its norm, as Megatron gathers before a
        column-parallel matmul (DTensor cannot multiply a row dimension
        sharded over two axes)."""
        if not (self.opt.sequence_parallel and is_dtensor(x)):
            return x
        spec = spec_of(x)
        if x.ndim < 3 or spec[1] is None:
            return x
        return self._constrain(x, (spec[0], None, *spec[2:]))

    def mamba_inner(self, x):
        """(B, L, d_inner): d_inner on the model axis."""
        if not self.model_axis or x.shape[-1] % self.model_size != 0:
            return self.act(x)
        dp = self._dp
        if x.shape[0] % self.dp_size != 0:
            dp = None
        return self._constrain(x, (dp, None, self.model_axis))

    def attn_qkv(self, q, k, v):
        """(B, H, S, hd): heads on model when divisible, else only the
        batch pinned to the data axes."""
        if (not self.opt.shard_activation_heads or not self.model_axis):
            return q, k, v
        dp = self._dp
        if q.shape[0] % self.dp_size != 0:
            dp = None

        def c(x):
            if x.shape[1] % self.model_size == 0:
                return self._constrain(x, (dp, self.model_axis, None, None))
            if dp is not None:
                return self._constrain(x, (dp, None, None, None))
            return x
        return c(q), c(k), c(v)

    def splits_last(self, t) -> bool:
        """Whether a DTensor's last dimension is sharded over more than
        one rank."""
        return is_dtensor(t) and math.prod(
            self.axis_sizes[a] for a in _axes_of(spec_of(t)[-1])) > 1

    def heads_ready(self, t, n: int):
        """``t`` (…, n * hd) laid out so that its last dimension splits
        into n heads: replicated there if its shards would cut a head."""
        if not is_dtensor(t):
            return t
        spec = spec_of(t)
        size = math.prod(self.axis_sizes[a] for a in _axes_of(spec[-1]))
        if n % size == 0:
            return t
        return t.redistribute(self.mesh,
                              self.placements(spec[:-1] + (None,)))

    # -------------------------------------------------- local-shard regions
    def _batch_entry(self, b: int):
        return self._dp if self.dp_axes and b % self.dp_size == 0 else None

    def _heads_entry(self, h: int):
        return (self.model_axis if self.model_axis
                and h % self.model_size == 0 else None)

    def _model_rank(self) -> int:
        return _mesh_index(self.mesh, (self.model_axis,)) \
            if self.model_axis else 0

    def local_attention(self, fn: Callable, q, k, v):
        """``fn(q, k, v)`` (an attention over (B, H, S, hd) q and (B, HKV,
        S, hd) k/v, e.g. the flash kernel) on each rank's heads and
        batch rows: q's heads on the model axis when it divides them,
        k/v's too when it divides theirs, else each rank takes the KV
        heads its query heads read (GQA groups stay whole)."""
        if not is_dtensor(q):
            return fn(q, k, v)
        b, h = q.shape[0], q.shape[1]
        hkv = k.shape[1]
        bd, hd_q = self._batch_entry(b), self._heads_entry(h)
        hd_kv = self._heads_entry(hkv) if hd_q else None
        qs = (bd, hd_q, None, None)
        kvs = (bd, hd_kv, None, None)
        vary = _axes_in(qs, kvs)
        ql = to_local(q, self.mesh, qs, vary)
        kl = to_local(k, self.mesh, kvs, vary)
        vl = to_local(v, self.mesh, kvs, vary)
        if hd_q and not hd_kv:
            hl = ql.shape[1]
            start = self._model_rank() * hl
            kl = _select_groups(kl, 1, h, hkv, start, hl)
            vl = _select_groups(vl, 1, h, hkv, start, hl)
        return from_local(fn(ql, kl, vl), self.mesh, qs)

    def local_ssd(self, fn: Callable, x, dt, a, b, c, init_state=None):
        """``fn(x, dt, a, b, c, init_state)`` -> (y, final state), the
        chunked SSD scan (x (B, L, H, P), dt (B, L, H), a (H,), b/c (B, L,
        G, N), init (B, H, P, N)), on each rank's heads and batch rows;
        each rank takes the B/C groups its heads read."""
        if not is_dtensor(x):
            return fn(x, dt, a, b, c, init_state)
        bsz, _, h, _ = x.shape
        g = b.shape[2]
        bd, hd = self._batch_entry(bsz), self._heads_entry(h)
        m = self.mesh
        vary = _axes_in((bd, hd))
        xl = to_local(x, m, (bd, None, hd, None), vary)
        dtl = to_local(dt, m, (bd, None, hd), vary)
        al = to_local(a, m, (hd,), vary)
        bl = to_local(b, m, (bd, None, None, None), vary)
        cl = to_local(c, m, (bd, None, None, None), vary)
        il = (None if init_state is None
              else to_local(init_state, m, (bd, hd, None, None), vary))
        if hd:
            hl = xl.shape[2]
            start = self._model_rank() * hl
            bl = _select_groups(bl, 2, h, g, start, hl)
            cl = _select_groups(cl, 2, h, g, start, hl)
        y, s_fin = fn(xl, dtl, al, bl, cl, il)
        return (from_local(y, m, (bd, None, hd, None)),
                from_local(s_fin, m, (bd, hd, None, None)))

    def local_moe(self, fn: Callable, p, x):
        """``fn(local_p, x, experts, reduce)`` -> (y, aux), the MoE layer
        on each rank's batch rows and experts: the tokens of a row are on
        every model rank, each rank runs its experts' share (``experts`` =
        (first expert, count)) and the partial outputs sum over the model
        axis; ``reduce`` sums the routing statistics over the data axes,
        so that the load-balancing loss is that of the whole batch."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        if not is_dtensor(x):
            return fn(p, x, None, None)
        m = self.mesh
        names, _ = mesh_axes(m)
        e = p.w_gate.shape[0]
        sharded = any(isinstance(pl, Shard) and pl.dim == 0
                      for pl in p.w_gate.placements)
        ed = self._heads_entry(e) if sharded else None
        bd = self._batch_entry(x.shape[0])
        vary = _axes_in((bd, ed))
        xl = to_local(x, m, (bd, None, None), vary)
        local = {n: to_local(getattr(p, n), m, (ed, None, None), vary)
                 for n in ("w_gate", "w_up", "w_down")}
        local["router"] = to_local(p.router, m, (None, None), vary)
        el = local["w_gate"].shape[0]
        experts = (self._model_rank() * el if ed else 0, el)
        dp_dims = set(_axes_of(bd))

        def reduce(t):
            pls = [Partial() if n in dp_dims else Replicate() for n in names]
            return DTensor.from_local(t, m, pls, run_check=False
                                      ).full_tensor()
        y, aux = fn(types.SimpleNamespace(**local), xl, experts,
                    reduce if bd else None)
        pls = []
        for n in names:
            if n in dp_dims:
                pls.append(Shard(0))
            elif ed and n == self.model_axis:
                pls.append(Partial())
            else:
                pls.append(Replicate())
        # the same aux on every rank: its gradient reaches every model
        # rank's router, whose gradients sum over the model axis, so each
        # rank holds 1/size of it as a pending sum
        aux_pls = [Partial() if ed and n == self.model_axis else Replicate()
                   for n in names]
        if ed:
            aux = aux / self.model_size
        return (DTensor.from_local(y, m, pls, run_check=False),
                DTensor.from_local(aux, m, aux_pls, run_check=False))

    def stack(self, ts):
        """``torch.stack`` of DTensors of one layout: their local shards
        stacked, the new leading dimension replicated."""
        if not is_dtensor(ts[0]):
            return torch.stack(ts)
        spec = spec_of(ts[0])
        return from_local(torch.stack([to_local(t, self.mesh, spec)
                                       for t in ts]),
                          self.mesh, (None,) + spec)

    def embed(self, table, tokens):
        """``table[tokens]`` on each rank's rows of the batch and of a
        vocabulary-sharded table: a rank looks up the tokens in its slice
        and the rows sum over the ranks of the vocabulary (a plain
        lookup, the same op as without a policy, where the table is
        whole on every rank)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        if not is_dtensor(table):
            return table[tokens.long()]
        tspec = spec_of(table)
        bd = self._batch_entry(tokens.shape[0])
        tok = to_local(tokens, self.mesh, (bd,) + (None,) * (tokens.ndim - 1)
                       ).long()
        tl = to_local(table, self.mesh, tspec, _axes_in((bd,), tspec))
        vocab_axes = _axes_of(tspec[0])
        if math.prod(self.axis_sizes[a] for a in vocab_axes) == 1:
            vocab_axes = ()
            rows = tl[tok]
        else:
            vl = tl.shape[0]
            idx = tok - _mesh_index(self.mesh, vocab_axes) * vl
            inside = ((idx >= 0) & (idx < vl))[..., None].to(tl.dtype)
            rows = tl[idx.clamp(0, vl - 1)] * inside
        names, _ = mesh_axes(self.mesh)
        pls = []
        for n in names:
            if n in _axes_of(bd):
                pls.append(Shard(0))
            elif n in vocab_axes:
                pls.append(Partial())
            elif n in _axes_of(tspec[1]):
                pls.append(Shard(rows.ndim - 1))
            else:
                pls.append(Replicate())
        return DTensor.from_local(rows, self.mesh, pls, run_check=False)

    def pick(self, logits, labels):
        """``logits.gather(-1, labels[..., None])[..., 0]`` over a
        vocabulary that may be sharded: each rank picks the labels in its
        slice of the vocabulary and the picks sum over the ranks of that
        slice, so that no rank gathers the full logits."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        if not is_dtensor(logits):
            return logits.gather(-1, labels[..., None])[..., 0]
        spec = spec_of(logits)
        ll = logits.redistribute(self.mesh, self.placements(spec)).to_local()
        lab = to_local(labels, self.mesh, spec[:-1])
        vocab_axes = _axes_of(spec[-1])
        vl = ll.shape[-1]
        idx = lab - _mesh_index(self.mesh, vocab_axes) * vl
        inside = (idx >= 0) & (idx < vl)
        got = ll.gather(-1, idx.clamp(0, vl - 1)[..., None])[..., 0]
        got = torch.where(inside, got, torch.zeros_like(got))
        names, _ = mesh_axes(self.mesh)
        pls = []
        for n in names:
            dims = [i for i, e in enumerate(spec[:-1]) if n in _axes_of(e)]
            pls.append(Shard(dims[0]) if dims else
                       Partial() if n in vocab_axes else Replicate())
        return DTensor.from_local(got, self.mesh, pls, run_check=False)

    # -------------------------------------------------------- decode caches
    def _seq_layout(self, cache) -> Tuple[Spec, Tuple[str, ...], int]:
        """(the spec of a per-layer (B, KV, S, hd) cache, the axes its
        sequence is sharded over, this rank's first position)."""
        spec = spec_of(cache)
        seq_axes = _axes_of(spec[2])
        chunk = cache.to_local().shape[2]
        return spec, seq_axes, _mesh_index(self.mesh, seq_axes) * chunk

    def update_kv_cache(self, k_cache, v_cache, k, v, write_at):
        """Write k/v (B, KV, T, hd) at per-sequence offsets ``write_at``
        into a cache (B, KV, S, hd) in its own layout, in place: each rank
        writes the positions of its slice of the sequence."""
        from repro_torch.models.transformer import update_kv_cache
        if not is_dtensor(k_cache):
            return update_kv_cache(k_cache, v_cache, k, v, write_at)
        spec, seq_axes, start = self._seq_layout(k_cache)
        new_spec = (spec[0], spec[1], None, spec[3])
        kl, vl = (to_local(t, self.mesh, new_spec) for t in (k, v))
        wl = to_local(write_at.expand(k_cache.shape[0]) if write_at.ndim
                      else write_at.reshape(1).expand(k_cache.shape[0]),
                      self.mesh, (spec[0],))
        kc, vc = k_cache.to_local(), v_cache.to_local()
        if not seq_axes:
            update_kv_cache(kc, vc, kl, vl, wl)
            return k_cache, v_cache
        # positions outside this rank's slice rewrite their own old value
        s_loc, t = kc.shape[2], kl.shape[2]
        pos = wl.to(torch.long)[:, None] + torch.arange(
            t, device=kc.device)[None, :] - start          # (B, T)
        inside = ((pos >= 0) & (pos < s_loc))[..., None, None]
        pos = pos.clamp(0, s_loc - 1)
        rows = torch.arange(kc.shape[0], device=kc.device)[:, None]
        for c, new in ((kc, kl), (vc, vl)):
            c[rows, :, pos] = torch.where(
                inside, new.transpose(1, 2).to(c.dtype), c[rows, :, pos])
        return k_cache, v_cache

    def decode_attention(self, q, k_cache, v_cache, lengths,
                         window: Optional[int]):
        """``layers.decode_attention`` on each rank's batch rows of a cache
        whose sequence is not sharded."""
        from repro_torch.models.layers import decode_attention
        if not is_dtensor(k_cache):
            return decode_attention(q, k_cache, v_cache, lengths, window)
        spec = spec_of(k_cache)
        bd = spec[0]
        qs = (bd, None, None, None)
        out = decode_attention(
            to_local(q, self.mesh, qs), k_cache.to_local(),
            v_cache.to_local(), to_local(lengths, self.mesh, (bd,)), window)
        return from_local(out, self.mesh, qs)

    # ------------------------------------------- flash-decoding over shards
    def sharded_decode_attention(self, q, k_cache, v_cache, lengths,
                                 window: Optional[int]):
        """Decode attention over a sequence-sharded cache: each shard
        computes local (m, l, o) online-softmax stats; a log-sum-exp
        combine over the sequence axes yields the exact result.  The
        collective is O(B*H*d) — independent of cache length."""
        from repro_torch.launch.mesh import shard_map
        seq_axes = self._decode_seq_axes or (
            (self.model_axis,) if self.model_axis else None)
        if seq_axes is None:
            from repro_torch.models.layers import decode_attention
            return decode_attention(q, k_cache, v_cache, lengths, window)
        b = q.shape[0]
        dp = None
        if b > 1 and self.dp_axes and b % self.dp_size == 0 \
                and not any(a in seq_axes for a in self.dp_axes):
            dp = self._dp
        qspec = (dp, None, None, None)
        cspec = (dp, None, seq_axes if len(seq_axes) > 1 else seq_axes[0],
                 None)
        lspec = (dp,)

        hkv = k_cache.shape[1]
        g = q.shape[1] // hkv
        scale = q.shape[-1] ** -0.5
        mesh = self.mesh
        names, _ = mesh_axes(mesh)

        def combine(t, op):
            # all-reduce ``op`` over the sequence axes only
            from torch.distributed.tensor import DTensor, Partial, Replicate
            src = [Partial(op) if n in seq_axes else Replicate()
                   for n in names]
            d = DTensor.from_local(t, mesh, src, run_check=False)
            return d.redistribute(mesh, [Replicate()] * len(names)
                                  ).to_local()

        def local(q_l, k_l, v_l, len_l):
            # global offset of this shard's cache slice
            chunk = k_l.shape[2]
            offset = _mesh_index(mesh, seq_axes) * chunk
            qg = q_l.reshape(q_l.shape[0], hkv, g, -1).float()
            s = torch.einsum("bkgd,bksd->bkgs", qg, k_l.float()) * scale
            kpos = offset + torch.arange(chunk, device=q_l.device)[None, :]
            mask = kpos < len_l[:, None]
            if window is not None:
                mask &= kpos > (len_l[:, None] - 1 - window)
            s = s.masked_fill(~mask[:, None, None, :], -1e30)
            m_l = s.amax(-1, keepdim=True)
            p = torch.exp(s - m_l)
            l_l = p.sum(-1, keepdim=True)
            o_l = torch.einsum("bkgs,bksd->bkgd", p, v_l.float())
            # combine across sequence shards
            m = combine(m_l, "max")
            w = l_l * torch.exp(m_l - m)
            o = combine(o_l * torch.exp(m_l - m), "sum")
            denom = combine(w, "sum")
            o = o / torch.clamp(denom, min=1e-30)
            return o.reshape(q_l.shape[0], -1, 1, q_l.shape[-1]
                             ).to(q_l.dtype)

        return shard_map(local, mesh=mesh,
                         in_specs=(qspec, cspec, cspec, lspec),
                         out_specs=qspec)(q, k_cache, v_cache, lengths)

    # --------------------------------------------------------------- zero-1
    def optimizer_spec(self, param_spec: Spec, shape: Tuple[int, ...]) -> Spec:
        """ZeRO-1: additionally shard optimizer state on the data axis
        along the first still-replicated, divisible dim."""
        if not self.opt.zero1 or not self.dp_axes:
            return tuple(param_spec)
        axis = self.dp_axes[-1]          # 'data'
        size = self.axis_sizes[axis]
        spec = list(tuple(param_spec)
                    + (None,) * (len(shape) - len(param_spec)))
        for i, (dim, cur) in enumerate(zip(shape, spec)):
            if cur is None and dim % size == 0 and dim >= size:
                spec[i] = axis
                return tuple(spec)
        return tuple(param_spec)

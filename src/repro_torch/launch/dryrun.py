"""Multi-pod dry run: trace every (arch × shape × mesh) cell on a fake
process world.

For each cell the step runs once on fake tensors (``FakeTensorMode``: no
data, no memory) on rank 0 of a fake process group the size of the
production mesh (256 or 512 ranks), with the parameters, the optimizer
state, the batch and the caches laid out by the sharding policy: the
train step (loss, backward, AdamW on a ZeRO-1 state), a prefill, or a
decode step against caches laid out by ``cache_spec``.  That proves the
layouts are coherent (every op has a sharding, every reshape a legal
split) and gives the roofline terms of :mod:`repro_torch.roofline`,
recorded to JSON:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k --mesh single --out results/dryrun_torch.json

The counterpart of ``repro.launch.dryrun``, with its names, flags and
JSON keys.  ``compile_s`` holds the seconds the full-depth trace took
(the JAX package's key for its compile time).  The fake world is
process-global: :func:`lower_cell` starts one of the mesh's size when
none is running and tears it down after.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch import configs, roofline
from repro_torch.configs.base import ALL_SHAPES, ShapeConfig
from repro_torch.sharding import PolicyOptions, ShardingPolicy

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """A fake process world of ``size`` ranks for the block (this
    process is rank 0); an already running fake world of that size is
    reused and left running."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != size:
            raise RuntimeError(
                f"a {dist.get_backend()} world of {dist.get_world_size()} "
                f"ranks is running; the dry run needs a fake world of "
                f"{size}")
        yield
        return
    mesh_mod.init_world("fake", size)
    try:
        yield
    finally:
        mesh_mod.destroy_world()


def _fake_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype)


def _locals(tree) -> list:
    from repro_torch.sharding import is_dtensor
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _locals(v)]
    if torch.is_tensor(tree):
        return [tree.to_local() if is_dtensor(tree) else tree]
    return []


def _trace_step(cfg, shape: ShapeConfig, mesh_shape: Sequence[int],
                names: Sequence[str], options: PolicyOptions,
                batch_override: Optional[int] = None,
                exclude=None) -> Dict[str, Any]:
    """Run one step of ``cfg`` on fake tensors under the policy of a
    ``mesh_shape`` mesh and count it (:class:`roofline.TraceCounter`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_compat_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim import (OptimizerConfig, init_opt_state_sharded,
                                   make_train_step)
    mesh = make_compat_mesh(mesh_shape, names, device_type="cpu")
    policy = ShardingPolicy(mesh, cfg, options)
    model = Model(cfg, "cpu", remat=options.remat, policy=policy,
                  unroll=True)
    specs = model.input_specs(shape, batch_override=batch_override)
    counter = roofline.TraceCounter(exclude)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = policy.param_shardings(model.empty_params())
        cache = specs.pop("cache", None)
        batch = {k: _fake_like(v) for k, v in specs.items()}
        if cache is not None:
            b = batch["lengths"].shape[0]
            cache = model.init_cache(b, shape.seq_len)
        state = None
        if shape.kind == "train":
            opt_cfg = OptimizerConfig()
            params.requires_grad_(True)
            state = {"params": params, "step": 0,
                     "opt": init_opt_state_sharded(params, opt_cfg, policy)}
        batch = policy.shard_batch(batch)
        for t in (_locals(dict(params.named_parameters()))
                  + _locals(batch) + _locals(cache or {})
                  + _locals(state["opt"] if state else {})):
            counter.track(t)
        arg_bytes = counter.live
        undo = counter.shadow()
        try:
            with counter:
                # outputs: what the step returns beside its in-place
                # updates (the train state, a decode step's cache)
                if shape.kind == "train":
                    make_train_step(model, opt_cfg, n_micro=options.n_micro,
                                    zero2_grads=options.zero2_grads)(
                                        state, batch)
                    outputs: Dict[str, Any] = {}
                elif shape.kind == "prefill":
                    logits, new_cache = model.prefill(
                        params, batch, cache_len=shape.seq_len)
                    outputs = {"logits": logits, "cache": new_cache}
                else:
                    logits, _ = model.decode_step(params, batch, cache)
                    outputs = {"logits": logits}
        finally:
            undo()
        out_bytes = sum(t.untyped_storage().nbytes()
                        for t in _locals(outputs))
    stats = counter.collectives()
    return {"flops": counter.flops, "bytes": counter.bytes,
            "ess": counter.essential, "coll": stats.total_bytes,
            "counts": stats.counts, "peak": float(counter.peak_bytes),
            "arg": float(arg_bytes), "out": float(out_bytes),
            "chips": mesh.size()}


def _depth_cfg(cfg, k: int):
    """Reduced-depth variant with identical width/shapes, and the scale
    factor back to full depth."""
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every or cfg.n_layers
        return (dataclasses.replace(cfg, n_layers=every * k,
                                    scan_unroll=True),
                cfg.n_layers // every)
    if cfg.family == "encdec":
        assert cfg.encoder_layers == cfg.n_layers
        return (dataclasses.replace(cfg, n_layers=k, encoder_layers=k,
                                    scan_unroll=True), cfg.n_layers)
    return dataclasses.replace(cfg, n_layers=k, scan_unroll=True), cfg.n_layers


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               options: Optional[PolicyOptions] = None,
               batch_override: Optional[int] = None,
               extrapolate: bool = True,
               cfg_override: Optional[Dict[str, Any]] = None,
               flash_accounting: bool = False,
               mesh: Optional[Tuple[Sequence[int], Sequence[str]]] = None):
    """Trace one cell; returns (the full-depth trace's counts, meta).

    FLOPs, bytes and collective bytes come from a two-point depth
    extrapolation, as in the JAX package: depth-1 and depth-2 variants
    are traced and ``cost(L) = outside + L * per_layer`` solved (on a
    model linear in depth it equals the full-depth trace exactly); the
    peak bytes and the tracing seconds come from the full-depth trace.

    ``batch_override``: the global batch traced in place of the cell's
    (the model FLOPs follow it, where the JAX package keeps the cell's).
    ``cfg_override``: ModelConfig field replacements (perf iterations).
    ``flash_accounting``: exclude (seq, chunk)-shaped score/probability
    tensors from the fused-memory bound, as the flash and SSD kernels
    keep them on chip.  ``mesh``: (shape, axis names) in place of the
    production mesh (e.g. ``((1, 1), ("data", "model"))``, one card).
    """
    cfg = configs.get(arch)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    mesh_shape, names = mesh or (MULTI_POD if multi_pod else SINGLE_POD)
    mesh_name = ("multi_pod" if multi_pod else "single_pod") if mesh is None \
        else "x".join(str(s) for s in mesh_shape)
    return trace_cell(cfg, ALL_SHAPES[shape_name], mesh_shape, names,
                      options=options, batch_override=batch_override,
                      extrapolate=extrapolate,
                      flash_accounting=flash_accounting,
                      arch=arch, mesh_name=mesh_name)


def trace_cell(cfg, shape: ShapeConfig, mesh_shape: Sequence[int],
               names: Sequence[str], *,
               options: Optional[PolicyOptions] = None,
               batch_override: Optional[int] = None,
               extrapolate: bool = True, flash_accounting: bool = False,
               arch: Optional[str] = None, mesh_name: Optional[str] = None):
    """:func:`lower_cell` of any config, shape cell and mesh: (the
    full-depth trace's counts, meta)."""
    options = options or PolicyOptions()
    arch = arch or cfg.name
    shape_name = shape.name
    mesh_name = mesh_name or "x".join(str(s) for s in mesh_shape)
    exclude = None
    if flash_accounting:
        exclude = set()
        if cfg.attention_impl == "chunked":
            sq = shape.seq_len if shape.kind != "decode" else 1
            exclude.add((sq, cfg.attention_chunk))
        if cfg.family in ("ssm", "hybrid"):
            exclude.add((cfg.ssm_chunk, cfg.ssm_chunk))
        exclude = exclude or None

    size = 1
    for s in mesh_shape:
        size *= int(s)
    with fake_world(size):
        # DTensor runs some ops of a layout it meets for the first time
        # once more (outside its sharding propagation): one depth-1 step
        # first, uncounted, so that every counted step runs warm
        _trace_step(_depth_cfg(cfg, 1)[0], shape, mesh_shape, names,
                    options, batch_override, exclude)
        t0 = time.perf_counter()
        full = _trace_step(cfg, shape, mesh_shape, names, options,
                           batch_override, exclude)
        t_trace = time.perf_counter() - t0
        if extrapolate:
            cfg1, scale = _depth_cfg(cfg, 1)
            cfg2, _ = _depth_cfg(cfg, 2)
            c1 = _trace_step(cfg1, shape, mesh_shape, names, options,
                             batch_override, exclude)
            c2 = _trace_step(cfg2, shape, mesh_shape, names, options,
                             batch_override, exclude)

            def ext(key):
                return max(0.0, max(0.0, 2 * c1[key] - c2[key])
                           + scale * (c2[key] - c1[key]))

            flops, bytes_, ess, coll = (ext("flops"), ext("bytes"),
                                        ext("ess"), ext("coll"))
            counts = {
                k: int(max(0, 2 * c1["counts"].get(k, 0)
                           - c2["counts"].get(k, 0))
                       + scale * (c2["counts"].get(k, 0)
                                  - c1["counts"].get(k, 0)))
                for k in set(c1["counts"]) | set(c2["counts"])}
        else:
            flops, bytes_, ess, coll, counts = (
                full["flops"], full["bytes"], full["ess"], full["coll"],
                full["counts"])

    peak = full["peak"]
    arg, out = full["arg"], full["out"]
    temp = max(0.0, peak - arg - out)
    # essential traffic: heavy-op bytes + the step's inputs/outputs once
    ess_total = ess + arg + out
    rep = roofline.RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=full["chips"],
        flops_per_dev=flops, bytes_per_dev=bytes_,
        collective_bytes_per_dev=coll,
        t_compute=flops / roofline.PEAK_FLOPS,
        t_memory=bytes_ / roofline.HBM_BW,
        t_collective=coll / roofline.NVLINK_BW,
        # the batch traced: with ``batch_override``, not the cell's
        model_flops=roofline.model_flops_for(
            cfg, shape if batch_override is None else
            dataclasses.replace(shape, global_batch=batch_override)),
        peak_bytes_per_dev=peak,
        collective_counts={k: v for k, v in counts.items() if v},
        essential_bytes_per_dev=ess_total,
        t_memory_fused=ess_total / roofline.HBM_BW,
    )
    meta = rep.to_dict()
    meta.update(compile_s=round(t_trace, 2), arg_bytes=int(arg),
                out_bytes=int(out), temp_bytes=int(temp))
    return full, meta


def cells(archs, shapes):
    for arch in archs:
        for shape in shapes:
            if configs.supports_shape(arch, shape):
                yield arch, shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--remat", default="dots",
                    choices=["none", "dots", "full"])
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--print-hlo", action="store_true",
                    help="print the traced step's counts (the JAX "
                         "package prints its HLO)")
    args = ap.parse_args(argv)

    archs = list(configs.ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(ALL_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    options = PolicyOptions(remat=args.remat,
                            seq_shard_decode=not args.no_seq_shard)

    results: Dict[str, Any] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    failures = []
    for arch, shape in cells(archs, shapes):
        for multi in meshes:
            key = f"{arch}|{shape}|{'multi_pod' if multi else 'single_pod'}"
            print(f"=== {key} ===", flush=True)
            try:
                # roofline extrapolation on the single-pod mesh only; the
                # multi-pod pass is the layout-coherence proof
                full, meta = lower_cell(arch, shape, multi_pod=multi,
                                        options=options,
                                        extrapolate=not multi)
                results[key] = meta
                print(json.dumps(
                    {k: meta[k] for k in
                     ("t_compute", "t_memory", "t_memory_fused",
                      "t_collective", "dominant", "roofline_fraction",
                      "compile_s")},
                    default=float), flush=True)
                if args.print_hlo:
                    print(json.dumps(full, default=float))
            except Exception as e:  # noqa: BLE001 - record and continue
                failures.append((key, repr(e)))
                traceback.print_exc()
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=float)
    print(f"\n{len(results)} cells recorded -> {args.out}")
    if failures:
        print("FAILURES:")
        for k, e in failures:
            print(" ", k, e)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

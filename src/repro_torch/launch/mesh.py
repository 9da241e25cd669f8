"""Device meshes and process worlds, in PyTorch.

The counterpart of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions
(``"data"``, ``"model"``, and ``"pod"`` for the multi-pod mesh) over the
ranks of a process world, which has to exist first:

  * :func:`init_world` starts one: ``"nccl"`` on CUDA, ``"gloo"`` on the
    CPU, or ``"fake"`` for a dry run (a fake process group of any size,
    whose collectives move nothing; see :mod:`.dryrun`), and
    :func:`destroy_world` tears it down again.  Under ``torchrun`` the
    rank and the world size come from the environment; otherwise a
    ``FileStore`` in a fresh temporary directory rendezvouses them.
  * :func:`make_compat_mesh` is ``init_device_mesh`` with dimension
    names; :func:`make_production_mesh` the (16, 16) ``("data",
    "model")`` pod or the (2, 16, 16) ``("pod", "data", "model")`` pair
    of pods; :func:`make_host_mesh` a small mesh over the ranks that
    exist, clamped as the JAX package clamps it to its devices.
  * :func:`set_mesh` makes a mesh the ambient one (:func:`current_mesh`)
    for a block.
  * :func:`shard_map` runs a function on each rank's local shards:
    every input is laid out by its spec and taken ``to_local``, and the
    outputs are wrapped back with ``DTensor.from_local``.

The JAX package's version shims (``_axis_type_kwargs``,
``jit_shardings``) have no counterpart: PyTorch has one API.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
from typing import Any, Callable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

_AMBIENT: List[Any] = []


# ---------------------------------------------------------------- worlds

def init_world(backend: str, world_size: int = 1, rank: int = 0,
               store_path: Optional[str] = None,
               timeout_s: float = 300.0) -> str:
    """Start the default process group and return its backend.

    ``backend`` is ``"nccl"`` (CUDA; each rank takes the card of its
    local rank), ``"gloo"`` (the CPU) or ``"fake"`` (a dry run: rank
    ``rank`` of ``world_size`` fake ranks, no peers, no traffic).  Under
    ``torchrun`` (``RANK``/``WORLD_SIZE`` in the environment) the
    environment's rendezvous is used and ``world_size``/``rank`` are
    ignored; otherwise a ``FileStore`` at ``store_path`` (default: a
    fresh temporary directory, which suits a world of one process)."""
    if dist.is_initialized():
        raise RuntimeError("a process world is already running; call "
                           "destroy_world() first")
    timeout = datetime.timedelta(seconds=timeout_s)
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world_size)
        return "fake"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return backend
    if store_path is None:
        store_path = os.path.join(tempfile.mkdtemp(prefix="repro_world_"),
                                  "store")
    store = dist.FileStore(store_path, world_size)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout, **kwargs)
    return backend


def destroy_world() -> None:
    """Tear the default process group down (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def world(backend: str, world_size: int = 1, rank: int = 0,
          store_path: Optional[str] = None) -> Iterator[str]:
    """:func:`init_world` for the duration of the block."""
    init_world(backend, world_size, rank, store_path)
    try:
        yield backend
    finally:
        destroy_world()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


# ---------------------------------------------------------------- meshes

def make_compat_mesh(shape: Sequence[int], names: Sequence[str],
                     device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with dimension ``names`` over the
    running world (whose size must be the product of ``shape``), on CUDA
    for an NCCL world and on the CPU otherwise."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(s) for s in shape)
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 ranks, ``("data", "model")``; the multi-pod mesh adds
    a leading ``"pod"`` axis (2 pods, 512 ranks), an outer data-parallel
    axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_compat_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """A small ``("data", "model")`` mesh over the ranks that exist:
    ``data`` clamped to the world size, ``model`` to what is left, as the
    JAX package clamps both to its devices.  The world must hold exactly
    ``data * model`` ranks after clamping."""
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(1, n // data))
    return make_compat_mesh((data, model), ("data", "model"))


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator[Any]:
    """Make ``mesh`` the ambient mesh (:func:`current_mesh`) for the
    block."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh():
    """The innermost mesh of :func:`set_mesh`, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


# ------------------------------------------------------------- shard_map

def shard_map(f: Callable, *, mesh, in_specs, out_specs) -> Callable:
    """``f`` run on each rank's local shards, as ``jax.shard_map`` runs it.

    Each positional input is laid out by its spec (a tuple of mesh-axis
    names per tensor dimension, see :mod:`repro_torch.sharding`) and
    handed to ``f`` as a plain local tensor; a plain (non-DTensor) input
    is taken as the same global value on every rank.  ``f``'s output, one
    tensor or a tuple of them, is wrapped back as DTensors with the
    placements of ``out_specs``: one spec, or a tuple with one spec per
    output.  ``in_specs`` is one spec per input."""
    from repro_torch.sharding import from_local, to_local

    def run(*args):
        local = [to_local(a, mesh, s) if torch.is_tensor(a) else a
                 for a, s in zip(args, in_specs)]
        out = f(*local)
        if isinstance(out, (tuple, list)):
            return tuple(from_local(o, mesh, s)
                         for o, s in zip(out, out_specs))
        return from_local(out, mesh, out_specs)
    return run

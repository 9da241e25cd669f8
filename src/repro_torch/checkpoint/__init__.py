"""Atomic, resumable checkpoints in the JAX package's on-disk format.

Layout (one directory per step), byte for byte that of
``repro.checkpoint``, so that a checkpoint either package writes
restores in the other:

    <dir>/step_00000100/
        manifest.json      # step, extra, and per leaf: file, shape, dtype
        arrays/<a__b>.npy  # one file per leaf: its raw bytes as uint8
    <dir>/LATEST           # atomic pointer (tmp + rename)

A tree is nested dicts (and lists or tuples) whose leaves are torch
tensors on any device, numpy arrays or Python scalars; a leaf's name is
its path of keys joined by ``/`` (dict keys sorted, as JAX flattens
them).  :func:`restore` gives CPU tensors: bfloat16 leaves are read with
``torch.frombuffer``, so no ``ml_dtypes`` is needed.  A train state goes
through ``convert.train_state_to_tree`` first, which gives it the JAX
package's leaf names and layers stacked as (L, ...).

Design points, as in the JAX package: the data is fully written before
``LATEST`` flips; :class:`AsyncCheckpointer` snapshots to host memory and
writes on a background thread, at most one save pending; a SIGTERM hook
makes a final synchronous save; resume is ``latest_step`` plus the
step-keyed data pipeline.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "/"

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple))


def _children(node):
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    return [(str(i), v) for i, v in enumerate(node)]


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, child in _children(tree):
        name = f"{prefix}{SEP}{key}" if prefix else key
        if _is_node(child):
            flat.update(_flatten(child, name))
        else:
            flat[name] = child
    return flat


def _unflatten_into(skeleton: Any, flat: Dict[str, Any],
                    prefix: str = "") -> Any:
    def fill(key, child):
        name = f"{prefix}{SEP}{key}" if prefix else key
        return (_unflatten_into(child, flat, name) if _is_node(child)
                else flat[name])
    if isinstance(skeleton, dict):
        return {k: fill(str(k), v) for k, v in skeleton.items()}
    return type(skeleton)(fill(str(i), v) for i, v in enumerate(skeleton))


def _raw(leaf: Any) -> Tuple[np.ndarray, List[int], str]:
    """(raw bytes as a uint8 array, shape, dtype name) of a leaf."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu").contiguous()
        name = _DTYPE_NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"no checkpoint dtype for {t.dtype}")
        return (t.reshape(-1).view(torch.uint8).numpy(), list(t.shape),
                name)
    arr = np.asarray(leaf)
    return (np.frombuffer(arr.tobytes(), np.uint8), list(arr.shape),
            str(arr.dtype))


def _tensor(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype not in _TORCH_DTYPES:
        raise TypeError(f"checkpoint dtype {dtype!r} has no torch dtype")
    dt = _TORCH_DTYPES[dtype]
    buf = bytearray(raw.tobytes())
    if not buf:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(buf, dtype=dt).reshape(shape)


def save(directory: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic checkpoint write."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"))
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for name, leaf in _flatten(tree).items():
        raw, shape, dtype = _raw(leaf)
        fname = name.replace(SEP, "__") + ".npy"
        # raw-bytes payload: round-trips bfloat16, which np.save cannot
        np.save(os.path.join(tmp, "arrays", fname), raw)
        manifest["leaves"][name] = {"file": fname, "shape": shape,
                                    "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _publish_latest(directory, final)
    return final


def _publish_latest(directory: str, final: str) -> None:
    ptr = os.path.join(directory, "LATEST")
    fd, tmp = tempfile.mkstemp(dir=directory)
    with os.fdopen(fd, "w") as f:
        f.write(os.path.basename(final))
    os.replace(tmp, ptr)


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[-1])


def restore(directory: str, skeleton: Any,
            step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Load a checkpoint (the latest unless ``step`` is given) into the
    structure of ``skeleton``, whose leaves need only a ``shape`` (meta
    tensors do).  Returns (tree of CPU tensors, step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    root = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    flat: Dict[str, torch.Tensor] = {}
    skel_flat = _flatten(skeleton)
    for name, meta in manifest["leaves"].items():
        raw = np.load(os.path.join(root, "arrays", meta["file"]))
        arr = _tensor(raw, meta["dtype"], meta["shape"])
        want = skel_flat.get(name)
        if want is not None and tuple(arr.shape) != tuple(want.shape):
            raise ValueError(
                f"leaf {name}: checkpoint shape {tuple(arr.shape)} != "
                f"model shape {tuple(want.shape)}")
        flat[name] = arr
    return (_unflatten_into(skeleton, flat), manifest["step"],
            manifest.get("extra", {}))


def gc_old(directory: str, keep: int = 3) -> List[str]:
    """Keep the newest ``keep`` checkpoints; never delete LATEST's target."""
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp"))
    victims = steps[:-keep] if keep else []
    latest = latest_step(directory)
    removed = []
    for v in victims:
        if latest is not None and v == f"step_{latest:08d}":
            continue
        shutil.rmtree(os.path.join(directory, v))
        removed.append(v)
    return removed


def _snapshot(tree: Any) -> Any:
    """A host copy of every leaf, isolated from later changes."""
    if _is_node(tree):
        if isinstance(tree, dict):
            return {k: _snapshot(v) for k, v in tree.items()}
        return type(tree)(_snapshot(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


class AsyncCheckpointer:
    """Background-thread checkpointer with at most one pending save and
    a SIGTERM preemption hook (a final synchronous save, then the
    default action)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._last: Optional[Tuple[int, Any, Dict]] = None
        self._lock = threading.Lock()
        self._orig_handler = None
        self._hooked = False

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        # the copy to host happens here, before the thread starts: the
        # snapshot must not see the in-place updates of later steps
        host_tree = _snapshot(tree)
        self.wait()
        with self._lock:
            self._last = (step, host_tree, extra or {})

        def run():
            save(self.directory, step, host_tree, extra)
            gc_old(self.directory, self.keep)

        self._thread = threading.Thread(target=run, daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def install_preemption_hook(self, state_fn: Callable[[], Tuple[int, Any]]
                                ) -> None:
        """On SIGTERM: final synchronous checkpoint, then default action."""
        def handler(signum, frame):
            step, tree = state_fn()
            self.wait()
            save(self.directory, step, tree, {"preempted": True})
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        self._orig_handler = signal.signal(signal.SIGTERM, handler)
        self._hooked = True

    def remove_preemption_hook(self) -> None:
        """Put back the SIGTERM handler the hook replaced (the hook holds
        the train state: a run inside a longer process releases it)."""
        if self._hooked:
            signal.signal(signal.SIGTERM, self._orig_handler)
            self._hooked = False

"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/kernels/lib<name>-<hash>.so``
at the root of the checkout, and loads with ``ctypes``.  The hash covers
the source, the shared headers and the flags, so an edited source builds
anew and an unchanged one loads at once.  Nothing is compiled when a
module is imported: the first launch builds what it needs, and
:func:`build_all` builds every kernel at once, one ``nvcc`` per source,
all started together.

Only the repository's own sources are compiled; every C entry point
returns ``cudaGetLastError()`` and :func:`check` raises when it is not 0.

Each library's first :func:`load` in a process is recorded on the
process-default tracer as a ``kernels.load`` span (``compiled`` in its
args: whether nvcc ran), so a set-up that compiles shows it by name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from repro_torch.core import telemetry as tele

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [sources()[name]] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    in parallel.  Returns the seconds each compile took (0.0 when the
    library was already there); raises with nvcc's output on failure.
    nvcc's ``-Xptxas -v`` report (registers, shared memory, spills) is
    kept beside each library as ``<lib>.log``."""
    names = list(names) if names is not None else list(sources())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(sources()[name])]
        procs[name] = (time.perf_counter(), tmp, out,
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT))
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (t0, tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".so.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """nvcc's report for a built kernel (empty if there is none)."""
    p = _lib_path(name).with_suffix(".so.log")
    return p.read_text(errors="replace") if p.exists() else ""


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.
    ``signatures`` maps each C entry point to its ``argtypes`` (pointers
    and the stream as ``c_void_p``), which returns ``int``, or to a pair
    ``(argtypes, restype)``."""
    lib = _loaded.get(name)
    if lib is None:
        args = {"library": name}
        with tele.get_tracer().span("kernels.load", cat="setup", args=args):
            args["compiled"] = build_all([name])[name] > 0
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, sig in signatures.items():
                argtypes, restype = sig if isinstance(sig, tuple) else (
                    sig, ctypes.c_int)
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


def ptr(t) -> Optional[ctypes.c_void_p]:
    """A tensor's device address for a C entry point (None: NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

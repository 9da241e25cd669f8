"""The PyTorch port stands alone: no JAX, nothing of the JAX package,
and no silent CPU fallback."""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import device as tdevice
from repro_torch.core import pipeline as tpipe
from repro_torch.core.parser import parse
from repro_torch.core.quantize import QuantSpec
from repro_torch.core.synthesis import CNN2Gate
from repro_torch.kernels import (_build, capture_info, flash_attention, ops,
                                 pool, qconv, qgemm, ssd_scan)
from repro_torch.models import cnn
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import sys, pkgutil, importlib
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["benchmarks"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k in ("jax", "benchmarks")
               or k.startswith(("jax.", "repro.", "benchmarks."))
               for k, v in sys.modules.items() if v is not None)
print(" ".join(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 16
    assert {"repro_torch.kernels.ssd_scan",
            "repro_torch.models.mamba2", "repro_torch.core.faults",
            "repro_torch.core.guard", "repro_torch.core.ser",
            "repro_torch.launch.profile", "repro_torch.optim",
            "repro_torch.checkpoint", "repro_torch.data.pipeline",
            "repro_torch.distributed",
            "repro_torch.launch.train", "repro_torch.sharding",
            "repro_torch.roofline", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.launch.perf"
            } <= set(names)


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro|benchmarks)(\.|\s|$|,)"
    r"|from\s+(jax|repro|benchmarks)(\.|\s))", re.M)


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    assert not _FORBIDDEN.findall(path.read_text()), path


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = cnn.tiny_cnn()
    x = np.zeros(g.inputs[0].shape, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CNN2Gate.from_graph(g)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cnn.run_float(g, x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cnn.collect_activations(g, x)
    pm = parse(g)
    specs = {li.name: QuantSpec(6, 4, 3) for li in pm.layers}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.build_quantized(pm, specs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(tconfigs.get_smoke("qwen2-1.5b"))
    assert tdevice.resolve("cpu").type == "cpu"


def _meta(shape, dtype=torch.int8):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_no_plain_fallback_off_the_cpu():
    """A tensor that is not on the CPU never reaches a plain version:
    every wrapper, dense, depthwise, grouped, max-pool, attention and SSD
    scan, insists on CUDA."""
    x, w = _meta((1, 6, 6, 8)), _meta((3, 3, 8, 8))
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        qconv.qconv2d(x, w, None)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        qgemm.qgemm(_meta((2, 8)), _meta((8, 4)), shift=0)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.qconv2d_nhwc(x, _meta((3, 3, 1, 8)), None, groups=8)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.qconv2d_nhwc(x, _meta((3, 3, 4, 8)), None, groups=2)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.maxpool2d_nhwc(x, 3, 2, (1, 1, 1, 1))
    q, kv = _meta((1, 4, 8, 16), torch.bfloat16), _meta((1, 2, 8, 16),
                                                       torch.bfloat16)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        flash_attention.flash_attention(q, kv, kv, window=4, q_offset=3)
    x, bc = _meta((1, 3, 2, 16), torch.bfloat16), _meta((1, 3, 1, 16),
                                                       torch.bfloat16)
    dt, a = _meta((1, 3, 2), torch.float32), _meta((2,), torch.float32)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.ssd_scan(x, dt, a, bc, bc)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ssd_scan.ssd_scan(x, dt, a, bc, bc, return_state=True)


def test_launch_counters_count_kernel_launches_only():
    """Plain versions (every CPU call, the trial forms' too) leave the
    counters alone."""
    ops.reset_launch_counts()
    g = cnn.googlenet_tiny()
    gate = CNN2Gate.from_graph(g, device="cpu")
    x = np.random.default_rng(0).standard_normal(g.inputs[0].shape)
    gate.calibrate_quantization(x.astype(np.float32))
    gate.build()(x)
    names = [ql.info.name for ql in gate.quantized.layers
             if ql.w_q is not None]
    ex = tpipe.make_executor(gate.quantized, weight_args=names)
    tpipe.vmap_trials(ex)(x, {ql.info.name: torch.stack([ql.w_q] * 2)
                                 for ql in gate.quantized.layers
                                 if ql.w_q is not None})
    single = ("qgemm", "qconv2d", "qconv2d_into", "qdwconv2d",
              "qdwconv2d_into", "qgconv2d")
    assert ops.launch_counts() == dict(
        {k: 0 for k in single}, **{k + "_trials": 0 for k in single},
        maxpool2d=0, flash_attention=0, ssd_scan=0)


def test_kernel_sources_and_build_key():
    srcs = _build.sources()
    assert set(srcs) == {"qgemm", "qconv", "qdwconv", "flash_attention",
                         "ssd_scan", "capture_info", "pool"}
    for name in srcs:
        lib = _build._lib_path(name)
        assert lib.parent == _build.BUILD_DIR
        assert lib.name.startswith(f"lib{name}-") and lib.suffix == ".so"
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        _build.check(7, "qgemm")


def test_ctypes_signatures_match_the_c_entry_points():
    """Each wrapper's ``argtypes`` has one entry per parameter of its C
    entry point: ``c_void_p`` for a pointer, ``c_float`` for a float,
    ``c_longlong`` for a long long, ``c_int`` for an int; and its return
    type (``int`` unless the signature names another) is the C one."""
    sigs = dict(qconv._SIGNATURES, qgemm=qgemm._SIGNATURES,
                flash_attention=flash_attention._SIGNATURES,
                ssd_scan=ssd_scan._SIGNATURES,
                capture_info=capture_info._SIGNATURES,
                pool=pool._SIGNATURES)
    assert set(sigs) == set(_build.sources())

    def ctype(decl):
        return (ctypes.c_void_p if "*" in decl else
                ctypes.c_float if decl.startswith("float ") else
                ctypes.c_longlong if decl.startswith("long long") else
                ctypes.c_int)
    for name, entries in sigs.items():
        src = _build.sources()[name].read_text()
        for fn, sig in entries.items():
            argtypes, restype = sig if isinstance(sig, tuple) else (
                sig, ctypes.c_int)
            m = re.search(r'extern "C" (int|long long) ' + fn
                          + r"\((.*?)\)\s*\{", src, re.S)
            assert m is not None, (name, fn)
            assert ctype(m.group(1) + " ") == restype, (name, fn)
            params = [p.strip() for p in m.group(2).split(",")]
            assert [ctype(p) for p in params] == argtypes, (name, fn)

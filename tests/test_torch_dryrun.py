"""The port's dry run and roofline on a fake process world (no card).

Each trace runs on fake tensors on rank 0 of a fake world that
``launch/dryrun.py`` starts and tears down itself (the world is
process-global, and an xdist worker also runs other files).  The JAX
package's ``launch/dryrun.py`` and ``launch/perf.py`` set ``XLA_FLAGS``
when imported, so they are read only in a subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs, roofline
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import fake_world, lower_cell, trace_cell
from repro_torch.sharding import PolicyOptions

TRAIN = ShapeConfig("t", "train", 32, 8)
PREFILL = ShapeConfig("p", "prefill", 32, 8)
DECODE = ShapeConfig("d", "decode", 64, 8)
KINDS = {"train": TRAIN, "prefill": PREFILL, "decode": DECODE}
MESH = ((2, 4), ("data", "model"))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def depth3(arch):
    cfg = configs.get_smoke(arch)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=3, encoder_layers=3)
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, n_layers=3 * (cfg.hybrid_attn_every or 1))
    return dataclasses.replace(cfg, n_layers=3)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b", "zamba2-2.7b",
                                  "whisper-large-v3", "qwen2-vl-2b",
                                  "h2o-danube-3-4b"])
def test_extrapolated_costs_equal_the_direct_trace(arch, kind):
    """Smoke configs at depth 3 on a 2 x 4 fake mesh: the two-point
    extrapolation from depths 1 and 2 equals the depth-3 trace.  The
    bytes of the train steps of mamba2, zamba2 and whisper are not quite
    linear in depth (DTensor runs a few backward ops of those models, such
    as softplus's, decomposed at some depths and not at others: a few %
    of the bytes); their FLOPs and collectives still equal."""
    full, meta = trace_cell(depth3(arch), KINDS[kind], *MESH)
    assert meta["flops_per_dev"] == full["flops"] > 0
    assert meta["collective_bytes_per_dev"] == full["coll"] > 0
    assert meta["collective_counts"] == {
        k: v for k, v in full["counts"].items() if v}
    if not (kind == "train" and arch in ("mamba2-2.7b", "zamba2-2.7b",
                                         "whisper-large-v3")):
        assert meta["bytes_per_dev"] == full["bytes"]
        assert (meta["essential_bytes_per_dev"]
                == full["ess"] + full["arg"] + full["out"])
    assert 0 < meta["peak_bytes_per_dev"] == full["peak"]
    assert meta["arg_bytes"] + meta["out_bytes"] + meta["temp_bytes"] \
        == meta["peak_bytes_per_dev"]


def test_data_parallel_flops_per_device_times_ranks_equal_one_rank():
    cfg = configs.get_smoke("qwen2-1.5b")
    one, _ = trace_cell(cfg, TRAIN, (1, 1), ("data", "model"),
                        extrapolate=False)
    dp, _ = trace_cell(cfg, TRAIN, (8, 1), ("data", "model"),
                       extrapolate=False)
    assert dp["flops"] * 8 == one["flops"] > 0
    assert one["coll"] == 0


def test_column_then_row_parallel_mlp_makes_one_forward_all_reduce():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_compat_mesh
    with fake_world(4):
        mesh = make_compat_mesh((4,), ("model",), device_type="cpu")
        counter = roofline.TraceCounter()
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(8, 64), mesh, [Replicate()])
            # (64, 32) and (32, 64) globally: each rank holds 8 of the 32
            w1 = DTensor.from_local(torch.empty(64, 8), mesh, [Shard(1)])
            w2 = DTensor.from_local(torch.empty(8, 64), mesh, [Shard(0)])
            undo = counter.shadow()
            try:
                with counter:
                    h = torch.nn.functional.silu(x @ w1)
                    (h @ w2).redistribute(mesh, [Replicate()])
            finally:
                undo()
    stats = counter.collectives()
    assert {k: v for k, v in stats.counts.items() if v} == {"all-reduce": 1}
    # all-reduce bytes count twice: the (8, 64) float32 result
    assert stats.bytes_by_kind["all-reduce"] == 2 * 8 * 64 * 4
    # per-device FLOPs: both products on the local shards
    assert counter.flops == 2 * (2 * 8 * 64 * 8)


def test_flops_are_counted_on_the_local_shard():
    """A (32, 4096, 1536) @ (1536, 8960) product sharded on both axes of
    a 16 x 16 mesh: the counter sees each rank's 1/256 of it, where
    ``FlopCounterMode`` around the DTensor op counts the whole product."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_compat_mesh
    with fake_world(256):
        mesh = make_compat_mesh((16, 16), ("data", "model"),
                                device_type="cpu")
        counter = roofline.TraceCounter()
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(2, 4096, 1536), mesh,
                                   [Shard(0), Replicate()])
            w = DTensor.from_local(torch.empty(1536, 560), mesh,
                                   [Replicate(), Shard(1)])
            undo = counter.shadow()
            try:
                with counter:
                    x @ w
            finally:
                undo()
    whole = 2 * 32 * 4096 * 1536 * 8960
    assert counter.flops == whole / 256


def test_roofline_report_and_model_flops_equal_the_jax_packages():
    from repro import configs as rconfigs
    from repro import roofline as rroofline
    from repro.configs.base import ALL_SHAPES as RSHAPES
    from repro_torch.configs.base import ALL_SHAPES
    for arch in configs.ARCH_NAMES:
        for name, shape in ALL_SHAPES.items():
            assert (roofline.model_flops_for(configs.get(arch), shape)
                    == rroofline.model_flops_for(rconfigs.get(arch),
                                                 RSHAPES[name]))
    kw = dict(arch="a", shape="s", mesh="m", chips=256, flops_per_dev=3e12,
              bytes_per_dev=4e9, collective_bytes_per_dev=2e8,
              t_compute=0.03, t_memory=0.05, t_collective=0.01,
              model_flops=4e14, peak_bytes_per_dev=1e9,
              collective_counts={"all-reduce": 3},
              essential_bytes_per_dev=1e9, t_memory_fused=0.02)
    ours, theirs = roofline.RooflineReport(**kw), rroofline.RooflineReport(**kw)
    for prop in ("dominant", "t_step", "useful_flops_ratio"):
        assert getattr(ours, prop) == getattr(theirs, prop)
    # the same formula over each package's own peak
    assert ours.roofline_fraction * roofline.PEAK_FLOPS == pytest.approx(
        theirs.roofline_fraction * rroofline.PEAK_FLOPS, rel=1e-12)
    assert set(ours.to_dict()) == set(theirs.to_dict())


def test_iterations_and_pod_axes_equal_the_jax_packages():
    from repro.core.spaces import DEFAULT_POD_AXES as R_AXES
    from repro.core.spaces import ShardingSpace as RSpace
    from repro_torch.core.spaces import DEFAULT_POD_AXES, ShardingSpace
    from repro_torch.launch.perf import ITERATIONS
    assert DEFAULT_POD_AXES == R_AXES
    assert (ShardingSpace("qwen2-1.5b", "train_4k").options()
            == RSpace("qwen2-1.5b", "train_4k").options())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", "import json, repro.launch.perf as p; "
         "print(json.dumps(p.ITERATIONS))"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == json.loads(
        json.dumps(ITERATIONS))


def test_autotune_pod_mode_runs(tmp_path):
    from repro_torch.launch import autotune
    out = tmp_path / "a.json"
    assert autotune.main(["--arch", "lm100m", "--shape", "train_4k",
                          "--algo", "bf", "--axes", "remat=full",
                          "--axes", "n_micro=1,4", "--eval-depth", "1",
                          "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["arch"] == "lm100m" and payload["board"] is None
    assert [h["option"] for h in payload["history"]] == [
        {"remat": "full", "n_micro": 1}, {"remat": "full", "n_micro": 4}]
    assert payload["evaluations"] == 2


def test_lower_cell_on_the_production_mesh_keeps_the_jax_keys():
    """qwen2-1.5b's decode cell on the 16 x 16 fake world, no
    extrapolation: the JSON keys of the JAX package's dry run."""
    _full, meta = lower_cell("qwen2-1.5b", "decode_32k", extrapolate=False,
                             options=PolicyOptions())
    for key in ("t_compute", "t_memory", "t_memory_fused", "t_collective",
                "dominant", "roofline_fraction", "compile_s", "arg_bytes",
                "out_bytes", "temp_bytes", "chips", "collective_counts"):
        assert key in meta
    assert meta["chips"] == 256 and meta["mesh"] == "single_pod"
    assert meta["collective_counts"]

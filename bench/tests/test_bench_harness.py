"""The harness driven on the CPU past its look for a card: a sound run
is correct, and a run with the timed path broken underneath is not."""
import json
import subprocess
import sys
import time

import pytest
import torch

from bench import run as bench_run
from conftest import ROOT
from smallcells import bench_with

CELLS = ["vgg16.stream_b1", "vgg16.offline_b64", "alexnet.stream_b1",
         "alexnet.offline_b64"]


def drive(tmp_path, workload, seed=2**31 + 99, seconds=0.3, traced=0):
    bench = bench_with(tmp_path, workload.split(".")[0])
    return bench_run.run(bench, workload, seed, seconds, traced,
                         torch.device("cpu"), time.time())


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tmp_path, workload):
    r = drive(tmp_path, workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "compared"
    assert r["compared"] == {"logits_differing": {"value": 0, "limit": 0}}
    want = {"setup_s"} | ({"latency_p50_ms", "latency_p95_ms"}
                          if "stream" in workload else {"images_per_s"})
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for m in r["metrics"].values())


def _stale(run):
    """A step that returns its state unchanged: from the second call on
    the executor hands back its previous answer without running."""
    last = []

    def ex(x):
        if last:
            return last[0].clone()
        last.append(run(x))
        return last[0].clone()
    return ex


def _half_batch(run):
    """Half of the batch left out: the second half's answers are the
    mean of the first half's."""
    def ex(x):
        y = run(x)
        if y.shape[0] > 1:
            h = y.shape[0] // 2
            y[h:] = y[:h].mean(dim=0)
        return y
    return ex


def _altered(run):
    """An answer altered where it is produced: one logit of every image
    moved to the next float."""
    def ex(x):
        y = run(x)
        y[:, 0] = torch.nextafter(y[:, 0], torch.full_like(y[:, 0], 1e9))
        return y
    return ex


@pytest.mark.parametrize("workload,fault", [
    ("vgg16.stream_b1", _stale), ("vgg16.stream_b1", _altered),
    ("vgg16.offline_b64", _stale), ("vgg16.offline_b64", _half_batch),
    ("vgg16.offline_b64", _altered),
    ("alexnet.stream_b1", _stale), ("alexnet.stream_b1", _altered),
    ("alexnet.offline_b64", _half_batch), ("alexnet.offline_b64", _altered),
])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, workload,
                                          fault):
    from repro_torch.core.synthesis import CNN2Gate
    build = CNN2Gate.build

    def broken_build(self, *a, **kw):
        return fault(build(self, *a, **kw))

    monkeypatch.setattr(CNN2Gate, "build", broken_build)
    r = drive(tmp_path, workload)
    assert not r["correct"]
    assert r["failed"] > 0
    assert r["compared"]["logits_differing"]["value"] > 0


def test_traced_run_on_the_cpu_reads_no_device_metric(tmp_path):
    """With no device events in the trace every per-layer reader stays
    silent: no number of a device metric comes from a CPU run."""
    r = drive(tmp_path, "alexnet.offline_b64", traced=1)
    assert r["correct"]
    assert r["metrics"] == {}
    assert "busy_s" not in r["device"] and "breakdown" not in r


_MODULES = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import torch
from pathlib import Path
from bench import run as bench_run
from smallcells import bench_with
bench_run.run(bench_with(Path({tmp!r}), "alexnet"), "alexnet.stream_b1", 3,
              0.2, 0, torch.device("cpu"), time.time())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import bench.reference.cnn, bench.model, bench.counts
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(code: str, tmp_path) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code.format(
            root=str(ROOT), src=str(ROOT / "src"),
            tests=str(ROOT / "bench" / "tests"), tmp=str(tmp_path))],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    names = _top_level_modules(_MODULES, tmp_path)
    assert "repro_torch" in names and "bench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    # the check compares whole top-level names: the port's begins with
    # the JAX package's
    assert bench_run.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    names = _top_level_modules(_REFERENCE, tmp_path)
    assert "torch" in names
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "vgg16.stream_b1", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in bench_run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert bench_run.forbidden_modules() == ["jax", "repro.core"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_readings_fail_the_limit(tmp_path, workload):
    """``bench/control.py`` at a small size: the int4 control, put in the
    program's place, goes through the run's own window and check and
    comes out not correct, every answer checked wrong."""
    from bench import cell, control
    bench = bench_with(tmp_path, workload.split(".")[0])
    r = control.readings(bench, workload, 11, 0.3, torch.device("cpu"))
    _cell, _config, traffic = cell.resolve(bench, workload)
    requests = r["attempted"] // traffic["batch"]
    checked = (min(traffic["sample_requests"], requests)
               * min(traffic.get("sample_rows", 1), traffic["batch"]))
    assert not r["correct"]
    assert r["failed"] == checked > 0
    assert r["compared"]["logits_differing"]["value"] > \
        cell.LIMITS["logits_differing"]


def _full_bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.cuda
def test_a_cell_is_correct_on_the_card(cuda_device):
    """alexnet.stream_b1 at full size for a second on the card."""
    r = bench_run.run(_full_bench(), "alexnet.stream_b1", 2**31 + 5, 1.0, 0,
                      cuda_device, time.time())
    assert r["correct"] and r["failed"] == 0
    assert r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {"latency_p50_ms", "latency_p95_ms",
                                 "setup_s"}


@pytest.mark.cuda
def test_a_traced_cell_reads_every_per_layer_metric(cuda_device):
    """alexnet.offline_b64 traced on the card: every per-layer metric the
    cell lists is read, shares stay within 100 %."""
    bench = _full_bench()
    r = bench_run.run(bench, "alexnet.offline_b64", 2**31 + 6, 1.0, 1,
                      cuda_device, time.time())
    want = {m["name"] for m in bench["per_layer"]
            if "alexnet.offline_b64" in m["workloads"]}
    assert r["correct"] and set(r["metrics"]) == want
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    for name, m in r["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, name
    assert len(r["breakdown"]["device_ops"]) <= 10

"""BENCHMARK.json against the shapes the benchmark's contract asks for,
the data-driven layout it names, and the per-layer readers on a
synthetic trace."""
import json
import re

import pytest

from bench import cell, counts, model, trace
from bench import run as bench_run
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_command(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_configs_are_files_under_paths(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert c["file"] == f"bench/configs/{c['name']}.json"
        conf = model.load_config(ROOT / c["file"])
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200
        # the family's module reads the table
        assert model.family(conf).layers_of(conf)


def test_cells_name_their_config_and_traffic(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert w["config"] in configs and NAME.match(w["traffic"])
        # the general generator implements every key of the mix
        cell.load_traffic(ROOT / "bench" / "traffic" / f"{w['traffic']}.json")
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    assert {c for c, _ in pairs} == configs


def test_metrics_and_their_readers(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert bench_run.reader_path(m["name"]).exists()
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells
            assert w in moved.get("workloads", cells)
    # every cell reports setup_s, one other end-to-end and one per-layer
    for w in cells:
        reported = [m for m in bench["end_to_end"]
                    if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
        assert "\n" not in m["layer"] and "\t" not in m["layer"]


def _reader(name):
    return bench_run.reader(name)


def synthetic(device_s, busy=0.8, window=1.0, requests=100,
              request_s=0.016):
    layers = model.layers_of(model.load_config("vgg16"))
    return trace.Trace(window_s=window, busy_s=busy, device_s=device_s,
                       idle_by_host={"cudaStreamSynchronize": 0.2},
                       requests=requests,
                       per_request=counts.forward_counts(layers, 1),
                       request_s=request_s)


def test_readers_on_a_synthetic_trace(bench):
    t = synthetic({"void qconv_wgmma_kernel<128>(CUtensorMap, ConvArgs)": 0.5,
                   "void qgemm_wgmma_kernel<64, 4>(...)": 0.1,
                   "Memcpy HtoD (Pageable -> Device)": 0.04,
                   "Memcpy DtoH (Device -> Pageable)": 0.01,
                   "Memcpy DtoD (Device -> Device)": 0.02,
                   "elementwise_kernel": 0.03})
    per = t.per_request
    want = {
        "transfer_ms.stream": 0.05 / 100 * 1e3,
        # busy 8 ms a request of an untraced 16 ms
        "device_idle_share.stream": 50.0,
        "mfu.stream": 100 * per["ops"] / (0.016 * counts.INT8_OPS_PER_S),
        "qconv_roofline.stream": 100 * 100 * per["conv_bound_s"] / 0.5,
        "qgemm_roofline.stream": 100 * 100 * per["fc_bound_s"] / 0.1,
        "other_device_ms.offline": (0.04 + 0.01 + 0.02 + 0.03) / 100 * 1e3,
    }
    for name, value in want.items():
        assert _reader(name)(t) == pytest.approx(value)
    assert _reader("device_idle_share.offline")(t) == pytest.approx(20.0)
    assert _reader("mfu.offline")(t) == pytest.approx(want["mfu.stream"])
    assert t.breakdown()["idle_gaps"] == [["cudaStreamSynchronize", 0.2]]
    # every per-layer metric of BENCHMARK.json has a reader that reads it
    for m in bench["per_layer"]:
        assert _reader(m["name"])(t) is not None


def test_readers_stay_silent_without_their_kernels():
    t = synthetic({"elementwise_kernel": 0.03}, busy=0.0, request_s=None)
    for name in ("qconv_roofline.stream", "qgemm_roofline.offline",
                 "transfer_ms.stream", "mfu.offline",
                 "device_idle_share.stream", "device_idle_share.offline"):
        assert _reader(name)(t) is None


def test_union_and_gaps():
    busy, gaps = trace._union([(1, 3), (2, 4), (6, 7), (7, 8)], 0, 10)
    assert busy == 5
    assert gaps == [(0, 1), (4, 6), (8, 10)]
    host = sorted([(0, 10, "outer"), (2, 5, "inner"), (6, 6.5, "short")])
    starts = [h[0] for h in host]
    assert trace._host_at(host, starts, 3) == "inner"
    assert trace._host_at(host, starts, 7) == "outer"
    assert trace._host_at(host, starts, 11) == "python"


def test_reduce_names_gaps_by_the_host_call_and_the_edges():
    """A trace of the CUDA activity alone: busy time is the union of the
    device events, a gap takes the runtime call around its middle, and the
    host window's rest is its edges."""
    device = [(10, 20, "k1"), (15, 30, "k2"), (50, 60, "Memcpy HtoD")]
    host = [(25, 55, "cudaMemcpyAsync"), (5, 12, "cudaGraphLaunch")]
    t = trace.reduce(device, host, 100e-6, 2, {})
    assert t.busy_s == pytest.approx(30e-6)
    assert t.device_s == pytest.approx({"k1": 10e-6, "k2": 15e-6,
                                        "Memcpy HtoD": 10e-6})
    assert t.idle_by_host == pytest.approx({"cudaMemcpyAsync": 20e-6,
                                            trace.EDGES: 50e-6})
    assert trace.reduce([], host, 1.0, 2, {}) is None


@pytest.mark.parametrize("change,why", [
    ({"clients": 4}, "implements no 'clients'"),
    ({"loop": "open"}, "implements no 'loop'"),
    ({"input_on": "disk"}, "implements no input_on"),
    ({"read_back": 1}, "implements no read_back"),
    ({"batch": 0}, "implements no batch"),
    ({"sample_requests": True}, "implements no sample_requests"),
    ({"pool": None}, "implements no pool"),
    ({"in_flight": 0, "read_back": False}, "implements no in_flight"),
    ({"in_flight": 4}, "in_flight, and needs it, only where answers"),
    ({"read_back": False}, "in_flight, and needs it, only where answers"),
])
def test_traffic_the_generator_does_not_implement_is_refused(
        tmp_path, change, why):
    mix = json.loads((ROOT / "bench" / "traffic" / "stream_b1.json")
                     .read_text())
    mix.update(change)
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(mix))
    with pytest.raises(ValueError, match=why):
        cell.load_traffic(path)


def test_traffic_without_a_needed_key_is_refused(tmp_path):
    path = tmp_path / "mix.json"
    path.write_text(json.dumps({"batch": 1, "pool": 2}))
    with pytest.raises(ValueError, match="lacks input_on, read_back"):
        cell.load_traffic(path)


def test_a_reader_is_found_by_the_name_before_its_first_dot():
    metrics = ROOT / "bench" / "metrics"
    assert bench_run.reader_path("mfu.offline") == metrics / "mfu.py"
    assert bench_run.reader_path("mfu") == metrics / "mfu.py"
    assert bench_run.reader_path("qconv_roofline.later_mix") == \
        metrics / "qconv_roofline.py"
    assert not bench_run.reader_path("no_such_metric.stream").exists()


def test_a_configuration_names_its_family_module():
    from bench.reference import cnn
    assert model.family({"family": "cnn"}) is cnn
    for attr in ("layers_of", "make_weights", "model_dict", "calibrate",
                 "int_forward", "forward_counts"):
        assert callable(getattr(cnn, attr))
    with pytest.raises(ValueError):
        model.family({"family": "../cnn"})
    with pytest.raises(ModuleNotFoundError):
        model.family({"family": "no_such_family"})

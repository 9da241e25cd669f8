"""The ``mobilenet`` family (``bench/reference/mobilenet.py``): its layer
table at full size, its counts, the model dict the program parses, the
control, the ``qdwconv_roofline`` reader, and ``mobilenet_v2.offline_b512``
driven through the harness on a small form of the configuration."""
import copy
import json
import time

import pytest
import torch

from bench import cell, control, counts, model, trace
from bench import run as bench_run
from bench.reference import mobilenet as reference
from bench.reference import resnet
from conftest import ROOT

SEEDS = (0, 2**31 + 7, 2**33 + 12345)
CELL = "mobilenet_v2.offline_b512"


def small_config(div: int = 8, hw: int = 64) -> dict:
    """MobileNetV2 with every width but the classes divided by ``div`` and
    a ``hw`` x ``hw`` input: the same kernels, strides, pads, adds and
    clamps (the GAP over 2 x 2) at a size the CPU runs in a moment."""
    c = copy.deepcopy(model.load_config("mobilenet_v2"))
    c["input"] = [3, hw, hw]
    c["stem"]["out"] //= div
    c["blocks"] = [[t, ch // div, n, s] for t, ch, n, s in c["blocks"]]
    c["head"] //= div
    return c


def bench_small(tmp_path) -> dict:
    """BENCHMARK.json with ``mobilenet_v2`` pointed at its small form."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    path = tmp_path / "mobilenet_v2.json"
    path.write_text(json.dumps(small_config()))
    for conf in bench["configs"]:
        if conf["name"] == "mobilenet_v2":
            conf["file"] = str(path)
    return bench


def test_the_layer_table_at_full_size():
    layers = reference.layers_of(model.load_config("mobilenet_v2"))
    convs = [l for l in layers if l.op == "conv"]
    assert len(convs) == 52 and sum(l.depthwise for l in convs) == 17
    assert sum(l.clip == 6.0 for l in layers) == 35
    assert [l.op for l in layers].count("add") == 10
    assert [l.op for l in layers][-2:] == ["gap", "fc"]
    by = {l.name: l for l in layers}
    assert by["stem"].out_shape == (32, 112, 112)
    assert "block1_expand" not in by          # t = 1
    assert by["block1_dw"].group == 32 and by["block1_dw"].fan_in == 9
    assert by["block2_dw"].stride == 2 and by["block2_dw"].out_shape == \
        (96, 56, 56)
    assert by["block17_project"].out_shape == (320, 7, 7)
    assert by["head"].out_shape == (1280, 7, 7) and by["fc"].out == 1000
    assert all(l.clip is None for l in layers
               if l.name.endswith(("project", "add")) or l.op == "fc")
    assert sum(l.weight_shape[1] == 1 for l in convs if l.depthwise) == 17
    assert round(sum(l.macs for l in layers) / 1e6, 1) == 300.8
    weights = sum(counts.weight_bytes(l) for l in layers if l.weighted)
    assert round(weights / 1e6, 2) == 3.47
    # each add's projection takes it; the other operand is the block's input
    hosts = {l.name: l.skip for l in layers if l.skip}
    assert len(hosts) == 10
    assert hosts["block3_project"] == "block2_project"
    assert hosts["block5_project"] == "block4_project"
    assert hosts["block6_project"] == "block5_add"
    assert all(by[h.replace("project", "add")].inputs == (h, s)
               for h, s in hosts.items())


def test_counts_split_the_depthwise_bound():
    layers = reference.layers_of(model.load_config("mobilenet_v2"))
    f = reference.forward_counts(layers, 512)
    assert f["ops"] == 2 * 512 * sum(l.macs for l in layers)
    dw = [l for l in layers if l.depthwise]
    assert f["dwconv_bound_s"] == pytest.approx(
        sum(counts.bound_s(l, 512) for l in dw))
    assert f["conv_bound_s"] == pytest.approx(sum(
        resnet.bound_s(l, 512) for l in layers if l.op == "conv"))
    # bytes bound every depthwise call: its reads and writes, not its MACs
    assert all(counts.call_bytes(l, 512) / counts.HBM_BYTES_PER_S
               > counts.ops(l, 512) / counts.INT8_OPS_PER_S for l in dw)
    # the projections that take an add read the other operand too
    by = {l.name: l for l in layers}
    p = by["block3_project"]
    assert resnet.skip_bytes(p, 512) == 512 * 24 * 56 * 56
    assert 2.0e-3 < f["conv_bound_s"] < 2.2e-3
    assert 0.85e-3 < f["dwconv_bound_s"] < 1.0e-3


def test_the_model_dict_writes_relu6_as_an_initializer_clip():
    config = small_config()
    layers = reference.layers_of(config)
    d = reference.model_dict(config, layers)
    kinds = [n["op_type"] for n in d["nodes"]]
    assert kinds.count("Conv") == 52 and kinds.count("Clip") == 35
    assert kinds.count("Add") == 10 and "Relu" not in kinds
    clip = next(n for n in d["nodes"] if n["op_type"] == "Clip")
    assert clip["inputs"][1:] == ["relu6_w", "relu6_b"]
    weights = reference.make_weights(layers, 3, "cpu")
    lo, hi = weights["relu6"]
    assert lo.shape == hi.shape == () and (float(lo), float(hi)) == (0, 6)
    dw = next(n for n in d["nodes"] if n["name"] == "block2_dw")
    assert dw["attrs"]["group"] == weights["block2_dw"][0].shape[0] == 12
    assert weights["block2_dw"][0].shape[1] == 1
    x_cal = model.make_images(1, config["input"], 3, 1, "cpu")
    _m_in, specs = reference.calibrate(layers, weights, x_cal)
    assert set(specs) == {l.name for l in layers
                          if l.op in ("conv", "add", "fc")}


@pytest.mark.parametrize("seed", SEEDS)
def test_control_in_int4_fails_the_comparison(seed):
    config = small_config()
    layers = reference.layers_of(config)
    weights = reference.make_weights(layers, seed, "cpu")
    x_cal = model.make_images(1, config["input"], seed, 1, "cpu")
    x = model.make_images(4, config["input"], seed, 2, "cpu")
    m_in, specs = reference.calibrate(layers, weights, x_cal)
    want = reference.int_forward(layers, weights, m_in, specs, x)
    m4, specs4 = reference.calibrate(layers, weights, x_cal, bits=4)
    got = reference.int_forward(layers, weights, m4, specs4, x, bits=4)
    assert int((got != want).sum()) > want.numel() // 2


def test_the_clamp_follows_the_rule():
    """A 1x1 conv of weight 1 over codes 0..127 with a ReLU6 at m_y = 4
    clamps them at floor(6 * 2^4) = 96."""
    config = {"name": "t", "input": [1, 1, 128], "clip": 6.0,
              "stem": {"out": 1, "kernel": 1, "stride": 1, "pad": 0},
              "blocks": [], "head": 1, "classes": 1}
    layers = reference.layers_of(config)
    one = (torch.ones(1, 1, 1, 1), torch.zeros(1))
    weights = {"stem": one, "head": one,
               "fc": (torch.ones(1, 1), torch.zeros(1))}
    x = torch.arange(128.0).view(1, 1, 1, 128) / 16
    specs = {"stem": (0, 4, 4), "head": (0, 4, 4), "fc": (0, 4, 4)}
    got = reference.int_forward(layers, weights, 4, specs, x)
    # the GAP's mean of min(code, 96) over 0..127, half up
    want = (sum(min(c, 96) for c in range(128)) + 64) // 128
    assert got.item() == want / 16


def test_the_depthwise_roofline_reader():
    read = bench_run.reader("qdwconv_roofline.offline")
    layers = reference.layers_of(model.load_config("mobilenet_v2"))
    per = reference.forward_counts(layers, 512)
    kernel = "void (anonymous namespace)::qdwconv_kernel<3>(DwArgs)"
    t = trace.Trace(window_s=1.0, busy_s=0.9,
                    device_s={kernel: 0.02, "qconv_wgmma_kernel": 0.05},
                    idle_by_host={}, requests=10, per_request=per,
                    request_s=0.01)
    assert read(t) == pytest.approx(100 * 10 * per["dwconv_bound_s"] / 0.02)
    assert bench_run.reader("qconv_roofline.offline")(t) == pytest.approx(
        100 * 10 * per["conv_bound_s"] / 0.07)
    t.device_s = {"qconv_wgmma_kernel": 0.05}
    assert read(t) is None                  # the trace lost the kernel
    t.per_request = {"ops": 1, "conv_bound_s": 1e-3, "fc_bound_s": 1e-4}
    assert read(t) == 0.0                   # no depthwise conv to bound
    t.requests = 0
    assert read(t) is None


def drive(tmp_path, seed=2**32 + 99, seconds=0.3, traced=0):
    return bench_run.run(bench_small(tmp_path), CELL, seed, seconds, traced,
                         torch.device("cpu"), time.time())


def test_sound_run_is_correct(tmp_path):
    r = drive(tmp_path)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["compared"] == {"logits_differing": {"value": 0, "limit": 0}}
    assert set(r["metrics"]) == {"setup_s", "images_per_s"}


def test_a_run_without_the_clamp_is_not_correct(tmp_path, monkeypatch):
    from repro_torch.kernels import qconv
    plain = qconv.epilogue_plain

    def no_clamp(acc, b, *, hi=127, **kw):
        return plain(acc, b, **kw)
    monkeypatch.setattr(qconv, "epilogue_plain", no_clamp)
    r = drive(tmp_path)
    assert not r["correct"] and r["failed"] > 0


def test_a_traced_run_on_the_cpu_reads_no_device_metric(tmp_path):
    r = drive(tmp_path, traced=1)
    assert r["correct"] and r["metrics"] == {}


def test_control_readings_fail_the_limit(tmp_path):
    bench = bench_small(tmp_path)
    r = control.readings(bench, CELL, 2**31 + 11, 0.3, torch.device("cpu"))
    _cell, _config, traffic = cell.resolve(bench, CELL)
    requests = r["attempted"] // traffic["batch"]
    checked = (min(traffic["sample_requests"], requests)
               * min(traffic.get("sample_rows", 1), traffic["batch"]))
    assert not r["correct"]
    assert r["failed"] == checked > 0


@pytest.mark.cuda
def test_the_cell_is_correct_on_the_card(cuda_device):
    """mobilenet_v2.offline_b512 at full size for a second on the card,
    traced: every per-layer metric it lists reads."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    r = bench_run.run(bench, CELL, 2**31 + 5, 1.0, 1, cuda_device,
                      time.time())
    assert r["correct"] and r["failed"] == 0
    want = {m["name"] for m in bench["per_layer"]
            if CELL in m["workloads"]}
    assert set(r["metrics"]) == want
    assert 0 < r["metrics"]["qdwconv_roofline.offline"]["value"] <= 100

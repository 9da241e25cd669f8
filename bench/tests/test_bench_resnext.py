"""The ``resnext`` family (``bench/reference/resnext.py``): its layer table
at full size, its counts with the grouped convs' bound, the model dict
the program parses, the control, the ``qgconv_roofline`` reader, and
``resnext50_32x4d.offline_b512`` driven through the harness on a small
form of the configuration."""
import copy
import json
import subprocess
import sys
import time

import pytest
import torch

from bench import cell, control, counts, model, trace
from bench import run as bench_run
from bench.reference import resnet
from bench.reference import resnext as reference
from conftest import ROOT

SEEDS = (0, 2**31 + 7, 2**33 + 12345)
CELL = "resnext50_32x4d.offline_b512"


def small_config(div: int = 8, hw: int = 32) -> dict:
    """ResNeXt-50 with every width but the classes and the cardinality
    divided by ``div``, the per-group widths kept (4, 8, 16 and 32
    channels a group), and a ``hw`` x ``hw`` input: the same kernels,
    strides, pads and adds at a size the CPU runs in a moment."""
    c = copy.deepcopy(model.load_config("resnext50_32x4d"))
    c["input"] = [3, hw, hw]
    c["stem"]["out"] //= div
    c["stages"] = [[w // div, o // div, n, s] for w, o, n, s in c["stages"]]
    c["cardinality"] //= div
    return c


def bench_small(tmp_path) -> dict:
    """BENCHMARK.json with ``resnext50_32x4d`` pointed at its small form."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    path = tmp_path / "resnext50_32x4d.json"
    path.write_text(json.dumps(small_config()))
    for conf in bench["configs"]:
        if conf["name"] == "resnext50_32x4d":
            conf["file"] = str(path)
    return bench


def test_the_layer_table_at_full_size():
    layers = reference.layers_of(model.load_config("resnext50_32x4d"))
    convs = [l for l in layers if l.op == "conv"]
    grouped = [l for l in convs if l.grouped]
    assert len(convs) == 53 and len(grouped) == 16
    assert all(l.group == 32 and l.kernel == 3 and l.pad == 1
               for l in grouped)
    assert [l.in_shape[0] // 32 for l in grouped] == \
        [4] * 3 + [8] * 4 + [16] * 6 + [32] * 3
    assert [l.stride for l in grouped].count(2) == 3
    assert [l.op for l in layers].count("add") == 16
    assert [l.op for l in layers][:2] == ["conv", "maxpool"]
    assert [l.op for l in layers][-2:] == ["gap", "fc"]
    by = {l.name: l for l in layers}
    assert by["conv1"].out_shape == (64, 112, 112)
    assert by["maxpool"].out_shape == (64, 56, 56)
    assert by["layer1_0_conv2"].weight_shape == (128, 4, 3, 3)
    assert by["layer1_0_conv2"].fan_in == 36
    assert by["layer2_0_conv2"].out_shape == (256, 28, 28)
    assert by["layer4_2_conv3"].out_shape == (2048, 7, 7)
    assert by["fc"].in_shape == (2048,) and by["fc"].out == 1000
    assert round(sum(l.macs for l in layers) / 1e9, 3) == 4.230
    weights = sum(counts.weight_bytes(l) for l in layers if l.weighted)
    assert round(weights / 1e6, 2) == 24.96
    # the projection takes its block's add, conv3 the others'
    hosts = {l.name: l.skip for l in layers if l.skip}
    assert len(hosts) == 16
    assert hosts["layer1_0_downsample"] == "layer1_0_conv3"
    assert hosts["layer1_1_conv3"] == "layer1_0_add"
    assert sum(h.endswith("downsample") for h in hosts) == 4
    assert all(not l.relu for l in convs if l.name.endswith(
        ("conv3", "downsample")))


def test_counts_split_the_grouped_bound():
    layers = reference.layers_of(model.load_config("resnext50_32x4d"))
    f = reference.forward_counts(layers, 512)
    assert f["ops"] == 2 * 512 * sum(l.macs for l in layers)
    grouped = [l for l in layers if l.grouped]
    assert f["gconv_bound_s"] == pytest.approx(
        sum(counts.bound_s(l, 512) for l in grouped))
    assert f["conv_bound_s"] == pytest.approx(sum(
        resnet.bound_s(l, 512) for l in layers if l.op == "conv"))
    # each grouped call's K is 9 * Cin/G: conv2's 36 bytes, conv5's 288
    g1 = grouped[0]
    assert counts.ops(g1, 1) == 2 * 56 * 56 * 128 * 36
    assert counts.ops(grouped[-1], 1) == 2 * 7 * 7 * 1024 * 288
    # bytes bound every grouped call: 36-288 MACs a byte are too few
    assert all(counts.call_bytes(l, 512) / counts.HBM_BYTES_PER_S
               > counts.ops(l, 512) / counts.INT8_OPS_PER_S
               for l in grouped)
    # conv2's three grouped convs, 0.123 ms each, are the largest share
    assert counts.bound_s(g1, 512) == pytest.approx(
        2 * 512 * 128 * 56 * 56 / counts.HBM_BYTES_PER_S, rel=1e-3)
    assert 0.95e-3 < f["gconv_bound_s"] < 1.05e-3
    assert 5.2e-3 < f["conv_bound_s"] < 5.6e-3
    assert f["gconv_bound_s"] < f["conv_bound_s"]


def test_the_model_dict_writes_the_groups():
    config = small_config()
    layers = reference.layers_of(config)
    d = reference.model_dict(config, layers)
    kinds = [n["op_type"] for n in d["nodes"]]
    assert kinds.count("Conv") == 53 and kinds.count("Add") == 16
    assert kinds.count("MaxPool") == 1 and kinds.count("Relu") == 1 + 32 + 16
    groups = [n["attrs"]["group"] for n in d["nodes"]
              if n["op_type"] == "Conv"]
    assert groups.count(4) == 16 and groups.count(1) == 37
    weights = reference.make_weights(layers, 3, "cpu")
    assert weights["layer1_0_conv2"][0].shape == (16, 4, 3, 3)
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


def test_the_grouped_conv_reads_its_own_group():
    """A 3x3 conv of 2 groups whose second group's weights are 0 writes 0
    (the bias) to that group's channels whatever the first group reads."""
    config = {"name": "t", "input": [4, 3, 3], "cardinality": 2,
              "stem": {"out": 4, "kernel": 1, "stride": 1, "pad": 0,
                       "pool": [1, 1, 0]},
              "stages": [[4, 4, 1, 1]], "classes": 4}
    layers = reference.layers_of(config)
    by = {l.name: l for l in layers}
    eye = torch.eye(4).view(4, 4, 1, 1)
    w2 = torch.zeros(4, 2, 3, 3)
    w2[:2, :, 1, 1] = 1.0
    weights = {"conv1": (eye, torch.zeros(4)),
               "layer1_0_conv1": (eye, torch.zeros(4)),
               "layer1_0_conv2": (w2, torch.zeros(4)),
               "layer1_0_conv3": (eye, torch.zeros(4)),
               "fc": (torch.eye(4), torch.zeros(4))}
    assert by["layer1_0_conv2"].weight_shape == (4, 2, 3, 3)
    x = torch.ones(1, 4, 3, 3)
    env = reference.float_forward(layers, weights, x)
    h = env["layer1_0_conv2"]
    assert torch.equal(h[0, :2, 1, 1], torch.full((2,), 2.0))
    assert torch.equal(h[0, 2:], torch.zeros(2, 3, 3))
    specs = {n: (0, 0, 0) for n in weights}
    specs["layer1_0_add"] = (0, 0, 0)
    got = reference.int_forward(layers, weights, 0, specs, x)
    assert got.tolist() == env["fc"].tolist()


def test_the_grouped_roofline_reader():
    read = bench_run.reader("qgconv_roofline.offline")
    layers = reference.layers_of(model.load_config("resnext50_32x4d"))
    per = reference.forward_counts(layers, 512)
    grouped = ("void (anonymous namespace)::tc::qconv_grouped_wgmma_kernel"
               "<64, false>(CUtensorMap_st, (anonymous namespace)::ConvArgs)")
    dense = "void (anonymous namespace)::tc::qconv_wgmma_kernel<64, false>"
    t = trace.Trace(window_s=1.0, busy_s=0.9,
                    device_s={grouped: 0.04, dense: 0.05},
                    idle_by_host={}, requests=10, per_request=per,
                    request_s=0.01)
    assert read(t) == pytest.approx(100 * 10 * per["gconv_bound_s"] / 0.04)
    # the grouped launches are conv launches too
    assert bench_run.reader("qconv_roofline.offline")(t) == pytest.approx(
        100 * 10 * per["conv_bound_s"] / 0.09)
    t.device_s = {dense: 0.09}
    assert read(t) is None          # no launch under the grouped name
    t.per_request = {"ops": 1, "conv_bound_s": 1e-3, "fc_bound_s": 1e-4}
    assert read(t) == 0.0           # no grouped conv to bound
    t.requests = 0
    assert read(t) is None


def test_the_reference_imports_nothing_of_the_program():
    code = ("import json, sys\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "import bench.reference.resnext\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bench" in names and "torch" in names
    assert not names & {"repro", "repro_torch", "jax", "jaxlib"}


def drive(tmp_path, seed=2**32 + 99, seconds=0.3, traced=0):
    return bench_run.run(bench_small(tmp_path), CELL, seed, seconds, traced,
                         torch.device("cpu"), time.time())


def test_sound_run_is_correct(tmp_path):
    r = drive(tmp_path)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["compared"] == {"logits_differing": {"value": 0, "limit": 0}}
    assert set(r["metrics"]) == {"setup_s", "images_per_s"}


def test_a_run_whose_groups_read_the_wrong_channels_is_not_correct(
        tmp_path, monkeypatch):
    """The grouped convs' weights handed over with the groups' input
    channels reversed: a fault only a grouped reference sees."""
    from repro_torch.kernels import qconv
    plain = qconv.qgconv2d

    def reversed_groups(x, w, b, **kw):
        return plain(x, w.flip(-2).contiguous(), b, **kw)
    monkeypatch.setattr(qconv, "qgconv2d", reversed_groups)
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
    """resnext50_32x4d.offline_b512 at full size for a second on the card,
    traced: every per-layer metric it lists reads, the grouped route's
    share inside (0, 105] %."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    r = bench_run.run(bench, CELL, 2**31 + 5, 1.0, 1, cuda_device,
                      time.time())
    assert r["correct"] and r["failed"] == 0
    want = {m["name"] for m in bench["per_layer"]
            if CELL in m["workloads"]}
    assert set(r["metrics"]) == want
    assert 0 < r["metrics"]["qgconv_roofline.offline"]["value"] <= 105

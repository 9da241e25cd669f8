"""The ``resnet`` family (``bench/reference/resnet.py``): its layer table
at full size, its reference against the program on the CPU at a small
size, the control, planted faults in the merge, and the two ResNet-18
cells driven through the harness."""
import copy
import json
import time

import pytest
import torch

from bench import cell, control, counts, model, trace
from bench import run as bench_run
from bench.reference import resnet as reference
from conftest import ROOT

SEEDS = (0, 2**31 + 7, 2**33 + 12345)
CELLS = ["resnet18.offline_b512", "resnet18.stream_b1"]


def small_config(div: int = 16, hw: int = 64) -> dict:
    """ResNet-18 with every width but the classes divided by ``div`` and
    a ``hw`` x ``hw`` input: the same kernels, strides, pads, adds and
    pools (the GAP over 2 x 2) at a size the CPU runs in a moment."""
    c = copy.deepcopy(model.load_config("resnet18"))
    c["input"] = [3, hw, hw]
    c["stem"]["out"] //= div
    for g in c["groups"]:
        g["out"] //= div
    return c


def bench_small(tmp_path) -> dict:
    """BENCHMARK.json with ``resnet18`` pointed at its small form."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    path = tmp_path / "resnet18.json"
    path.write_text(json.dumps(small_config()))
    for conf in bench["configs"]:
        if conf["name"] == "resnet18":
            conf["file"] = str(path)
    return bench


def inputs(seed, n):
    config = small_config()
    layers = reference.layers_of(config)
    weights = reference.make_weights(layers, seed, "cpu")
    x_cal = model.make_images(1, config["input"], seed, 1, "cpu")
    x = model.make_images(n, config["input"], seed, 2, "cpu")
    return config, layers, weights, x_cal, x


def program(config, layers, weights, specs, fuse_skip=True, mode="fullflow"):
    """The program built as the harness builds it."""
    from repro_torch.core import onnx_lite
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.core.synthesis import CNN2Gate

    inits = {}
    for n, (w, b) in weights.items():
        inits[f"{n}_w"], inits[f"{n}_b"] = w.numpy(), b.numpy()
    gate = CNN2Gate.from_graph(onnx_lite.from_model_dict(
        reference.model_dict(config, layers), inits), fuse_skip=fuse_skip,
        device="cpu")
    gate.apply_quantization({n: QuantSpec(*s) for n, s in specs.items()})
    return gate, gate.build(mode)


def test_the_layer_table_at_full_size():
    layers = reference.layers_of(model.load_config("resnet18"))
    ops = [l.op for l in layers]
    assert ops.count("conv") == 20 and ops.count("add") == 8
    assert ops.count("maxpool") == ops.count("gap") == ops.count("fc") == 1
    by = {l.name: l for l in layers}
    assert by["conv1"].out_shape == (64, 112, 112)
    assert by["maxpool"].out_shape == (64, 56, 56) and by["maxpool"].pad == 1
    assert by["gap"].in_shape == (512, 7, 7)
    assert by["fc"].in_shape == (512,) and by["fc"].out == 1000
    projections = [l for l in layers if l.name.endswith("downsample")]
    assert [(l.kernel, l.stride, l.relu) for l in projections] == \
        [(1, 2, False)] * 3
    assert round(sum(l.macs for l in layers) / 1e9, 3) == 1.814
    weights = sum(counts.weight_bytes(l) for l in layers if l.weighted)
    assert round(weights / 1e6, 2) == 11.68
    # each add's later conv takes it; the projections take their block's
    hosts = {l.name: l.skip for l in layers if l.skip}
    assert len(hosts) == 8
    assert hosts["layer1_0_conv2"] == "maxpool"
    assert hosts["layer2_0_downsample"] == "layer2_0_conv2"
    assert hosts["layer4_1_conv2"] == "layer4_0_add"


def test_counts_read_the_skip_operand():
    layers = reference.layers_of(model.load_config("resnet18"))
    by = {l.name: l for l in layers}
    c = by["layer1_0_conv2"]
    plain = counts.call_bytes(c, 512)
    assert reference.skip_bytes(c, 512) == 512 * 64 * 56 * 56
    assert reference.bound_s(c, 512) == pytest.approx(max(
        counts.ops(c, 512) / counts.INT8_OPS_PER_S,
        (plain + 512 * 64 * 56 * 56) / counts.HBM_BYTES_PER_S))
    assert reference.skip_bytes(by["layer1_0_conv1"], 512) == 0
    f = reference.forward_counts(layers, 512)
    assert f["ops"] == 2 * 512 * sum(l.macs for l in layers)
    assert f["conv_bound_s"] == pytest.approx(sum(
        reference.bound_s(l, 512) for l in layers if l.op == "conv"))
    without = sum(counts.bound_s(l, 512) for l in layers if l.op == "conv")
    assert f["conv_bound_s"] > without
    assert f["fc_bound_s"] == pytest.approx(counts.bound_s(by["fc"], 512))


def test_the_model_dict_names_the_programs_specs():
    config = small_config()
    layers = reference.layers_of(config)
    d = reference.model_dict(config, layers)
    kinds = [n["op_type"] for n in d["nodes"]]
    assert kinds.count("Add") == 8 and kinds.count("Conv") == 20
    assert kinds.count("GlobalAveragePool") == kinds.count("Flatten") == 1
    (pool,) = [n for n in d["nodes"] if n["op_type"] == "MaxPool"]
    assert pool["attrs"]["pads"] == [1, 1, 1, 1]
    weights = reference.make_weights(layers, 3, "cpu")
    x_cal = model.make_images(1, config["input"], 3, 1, "cpu")
    _m_in, specs = reference.calibrate(layers, weights, x_cal)
    assert set(specs) == {l.name for l in layers
                          if l.op in ("conv", "add", "fc")}
    assert all(specs[l.name][0] == 0 for l in layers if l.op == "add")


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_equals_the_program(seed):
    config, layers, weights, x_cal, x = inputs(seed, 6)
    m_in, specs = reference.calibrate(layers, weights, x_cal)
    _gate, ex = program(config, layers, weights, specs)
    ref = reference.int_forward(layers, weights, m_in, specs, x, block=4)
    got = torch.cat([ex(x[:1]), ex(x[1:])])
    assert torch.equal(got, ref)
    assert torch.unique(ref).numel() > 50


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_and_unfused_programs_agree(seed):
    """The program with the adds in the conv epilogues and the program
    with every add a stage of its own give the same integers."""
    config, layers, weights, x_cal, x = inputs(seed, 3)
    _m_in, specs = reference.calibrate(layers, weights, x_cal)
    fused_gate, fused = program(config, layers, weights, specs, True,
                                "emulation")
    plain_gate, plain = program(config, layers, weights, specs, False,
                                "emulation")
    assert sum(l.merge is not None for l in fused_gate.parsed.layers) == 8
    assert sum(l.kind == "add" for l in plain_gate.parsed.layers) == 8
    assert torch.equal(fused(x), plain(x))


def test_specs_are_the_programs_own_rule():
    """The benchmark's copy of the residual rule gives the specs the
    program's calibration gives on the same image."""
    config, layers, weights, x_cal, _x = inputs(5, 1)
    m_in, specs = reference.calibrate(layers, weights, x_cal)
    gate, _ex = program(config, layers, weights, specs, mode="emulation")
    theirs = gate.calibrate_quantization(x_cal.numpy())
    assert {n: (s.m_w, s.m_x, s.m_y) for n, s in theirs.items()} == specs
    assert gate.quantized.input_m == m_in


def test_the_rule_pins_each_adds_operands_at_their_minimum():
    config, layers, weights, x_cal, _x = inputs(9, 1)
    _m_in, specs = reference.calibrate(layers, weights, x_cal)
    pos = {l.name: specs[l.name][2] for l in layers if l.name in specs}
    pos["maxpool"] = specs["conv1"][2]
    for l in layers:
        if l.op == "add":
            _z, m_common, m_y = specs[l.name]
            assert m_common == min(pos[t] for t in l.inputs)
            assert m_y <= m_common
        elif l.weighted:
            m_w, m_x, m_y = specs[l.name]
            assert m_y <= m_w + m_x


def test_gap_divides_rounding_half_up():
    """A GAP over 4 x 4 by hand: sums 8, 7, 9 and 24 over 16 round half
    up to 1, 0, 1 and 2."""
    config = {"name": "t", "input": [1, 4, 4],
              "stem": {"out": 1, "kernel": 1, "stride": 1, "pad": 0,
                       "pool": [1, 1, 0]},
              "groups": [], "classes": 1}
    layers = reference.layers_of(config)
    weights = {"conv1": (torch.ones(1, 1, 1, 1), torch.zeros(1)),
               "fc": (torch.ones(1, 1), torch.zeros(1))}
    specs = {"conv1": (0, 0, 0), "fc": (0, 0, 0)}
    x = torch.zeros(4, 1, 16)
    x[0, 0, :8] = 1.0
    x[1, 0, :7] = 1.0
    x[2, 0, :9] = 1.0
    x[3, 0, :8] = 3.0
    got = reference.int_forward(layers, weights, 0, specs,
                                x.view(4, 1, 4, 4)).flatten()
    assert got.tolist() == [1.0, 0.0, 1.0, 2.0]


@pytest.mark.parametrize("seed", SEEDS)
def test_control_in_int4_fails_the_comparison(seed):
    _config, layers, weights, x_cal, x = inputs(seed, 4)
    m_in, specs = reference.calibrate(layers, weights, x_cal)
    want = reference.int_forward(layers, weights, m_in, specs, x)
    m4, specs4 = reference.calibrate(layers, weights, x_cal, bits=4)
    got = reference.int_forward(layers, weights, m4, specs4, x, bits=4)
    assert int((got != want).sum()) > want.numel() // 2


def _skew_alignment(which):
    """The program's fused add with one operand's alignment shift one
    place too far."""
    from repro_torch.kernels import ops
    conv = ops.qconv2d_nhwc

    def faulty(*a, skip=None, skip_shifts=(0, 0), **kw):
        if skip is not None:
            s = list(skip_shifts)
            s[which] += 1
            skip_shifts = tuple(s)
        return conv(*a, skip=skip, skip_shifts=skip_shifts, **kw)
    return faulty


def _no_intermediate_clip():
    """The program's fused add fed the conv's sum before its saturation
    to int8: the epilogue without that clip."""
    from repro_torch.kernels import qconv, ref

    def epilogue(acc, b, *, shift=0, relu=True, skip=None,
                 skip_shifts=(0, 0), merge_shift=0, merge_relu=False,
                 concat_shift=0, concat_relu=False):
        if skip is None:
            return qconv_epilogue(acc, b, shift=shift, relu=relu,
                                  concat_shift=concat_shift,
                                  concat_relu=concat_relu)
        acc = ref.round_shift(acc + b.to(torch.int32), shift)
        if relu:
            acc = acc.clamp_min(0)
        a_conv, a_skip = skip_shifts
        acc = (ref.round_shift(acc, a_conv)
               + ref.round_shift(skip.to(torch.int32), a_skip))
        acc = ref.round_shift(acc, merge_shift)
        if merge_relu:
            acc = acc.clamp_min(0)
        return acc.clamp(-128, 127).to(torch.int8)
    qconv_epilogue = qconv.epilogue_plain
    return epilogue


@pytest.mark.parametrize("fault", ["conv_alignment", "skip_alignment",
                                   "no_intermediate_clip"])
def test_a_fault_in_the_merge_fails_the_comparison(monkeypatch, fault):
    from repro_torch.kernels import ops, qconv
    config, layers, weights, x_cal, x = inputs(2**31 + 7, 8)
    m_in, specs = reference.calibrate(layers, weights, x_cal)
    if fault == "no_intermediate_clip":
        # weights large enough that the second convs saturate
        weights = {n: (w * (4.0 if n.endswith("conv2") else 1.0), b)
                   for n, (w, b) in weights.items()}
    want = reference.int_forward(layers, weights, m_in, specs, x)
    _gate, sound = program(config, layers, weights, specs, mode="emulation")
    assert torch.equal(sound(x), want)
    if fault == "no_intermediate_clip":
        monkeypatch.setattr(qconv, "epilogue_plain", _no_intermediate_clip())
    else:
        monkeypatch.setattr(ops, "qconv2d_nhwc", _skew_alignment(
            0 if fault == "conv_alignment" else 1))
    _gate, ex = program(config, layers, weights, specs, mode="emulation")
    assert int((ex(x) != want).sum()) > 0


def drive(tmp_path, workload, seed=2**32 + 99, seconds=0.3, traced=0):
    return bench_run.run(bench_small(tmp_path), workload, seed, seconds,
                         traced, torch.device("cpu"), time.time())


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tmp_path, workload):
    r = drive(tmp_path, workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["compared"] == {"logits_differing": {"value": 0, "limit": 0}}
    want = {"setup_s"} | ({"latency_p50_ms", "latency_p95_ms"}
                          if "stream" in workload else {"images_per_s"})
    assert set(r["metrics"]) == want


@pytest.mark.parametrize("workload", CELLS)
def test_a_skewed_merge_in_the_timed_path_is_not_correct(
        tmp_path, monkeypatch, workload):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "qconv2d_nhwc", _skew_alignment(1))
    r = drive(tmp_path, workload)
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_readings_fail_the_limit(tmp_path, workload):
    bench = bench_small(tmp_path)
    r = control.readings(bench, workload, 2**31 + 11, 0.3,
                         torch.device("cpu"))
    _cell, _config, traffic = cell.resolve(bench, workload)
    requests = r["attempted"] // traffic["batch"]
    checked = (min(traffic["sample_requests"], requests)
               * min(traffic.get("sample_rows", 1), traffic["batch"]))
    assert not r["correct"]
    assert r["failed"] == checked > 0


def test_the_offline_traffic_is_the_generators():
    mix = cell.load_traffic(ROOT / "bench" / "traffic" / "offline_b512.json")
    assert (mix["batch"], mix["pool"], mix["in_flight"]) == (512, 4, 4)
    assert mix["input_on"] == "device" and mix["read_back"] is False
    assert (mix["sample_requests"], mix["sample_rows"]) == (4, 16)


def _trace(device_s, requests=10):
    layers = reference.layers_of(model.load_config("resnet18"))
    return trace.Trace(window_s=1.0, busy_s=0.9, device_s=device_s,
                       idle_by_host={}, requests=requests,
                       per_request=reference.forward_counts(layers, 512),
                       request_s=0.01)


def test_pool_ms_reads_the_pool_reductions():
    read = bench_run.reader("pool_ms.offline")
    t = _trace({
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<"
        "signed char, at::native::MaxOps<signed char>, unsigned int, "
        "signed char, 4> >(...)": 0.004,
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<int, "
        "at::native::func_wrapper_t<int, at::native::sum_functor<int, int, "
        "int>::operator()>, unsigned int, int, 4> >(...)": 0.001,
        "void qconv_wgmma_kernel<128, false>(CUtensorMap, ConvArgs)": 0.08,
        "at::native::elementwise_kernel<128, 4>": 0.002})
    assert read(t) == pytest.approx(1e3 * 0.005 / 10)
    assert read(_trace({"elementwise_kernel": 0.01})) == 0.0
    assert read(_trace({"elementwise_kernel": 0.01}, requests=0)) is None


@pytest.mark.cuda
def test_the_stream_cell_is_correct_on_the_card(cuda_device):
    """resnet18.stream_b1 at full size for a second on the card."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    r = bench_run.run(bench, "resnet18.stream_b1", 2**31 + 5, 1.0, 0,
                      cuda_device, time.time())
    assert r["correct"] and r["failed"] == 0
    assert set(r["metrics"]) == {"latency_p50_ms", "latency_p95_ms",
                                 "setup_s"}

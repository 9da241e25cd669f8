"""MobileNetV2 on the port's fullflow path: ReLU6 (ONNX ``Clip``) fused
into the conv epilogues as a clamp to the code ``hi = min(127,
floor(6 * 2^m_y))``, depthwise convs and linear-bottleneck adds.

On the CPU: the parser's two ``Clip`` forms and the ones it refuses; the
program built as the benchmark builds it (``bench/reference/
mobilenet.py``'s model dict and specs, fullflow, fused skips) at widths
divided by 8 and a 64x64 input, equal to that plain reference's integer
logits; that the clamp matters (stages reach ``hi`` < 127, and the same
graph with ``Relu`` for ``Clip`` gives other logits); the build's
counters; the guarded executor and the SER trial form carrying the clamp.
On the card (``cuda`` marker): the dense and depthwise kernels with ``hi``
against their plain version at MobileNetV2's own shapes, and an eager and
a captured forward's launches.  This file imports no JAX.
"""
import copy
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import model  # noqa: E402
from bench.reference import mobilenet as reference  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.core import onnx_lite  # noqa: E402
from repro_torch.core import parser as P  # noqa: E402
from repro_torch.core import pipeline as t_pipe  # noqa: E402
from repro_torch.core import telemetry as tele  # noqa: E402
from repro_torch.core import verify as TV  # noqa: E402
from repro_torch.core.graph import (Graph, GraphValidationError,  # noqa: E402
                                    Node, TensorInfo)
from repro_torch.core.guard import GuardPolicy  # noqa: E402
from repro_torch.core.quantize import QuantSpec, clamp_code  # noqa: E402
from repro_torch.core.synthesis import CNN2Gate  # noqa: E402
from repro_torch.kernels import ops, qconv  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

SEEDS = (0, 2**31 + 7, 2**33 + 12345)


def small_config(div: int = 8, hw: int = 64) -> dict:
    """MobileNetV2 with every width but the classes divided by ``div`` and
    a ``hw`` x ``hw`` input: the same kernels, strides, pads, adds and
    clamps at a size the CPU runs in a moment."""
    c = copy.deepcopy(model.load_config("mobilenet_v2"))
    c["input"] = [3, hw, hw]
    c["stem"]["out"] //= div
    c["blocks"] = [[t, ch // div, n, s] for t, ch, n, s in c["blocks"]]
    c["head"] //= div
    return c


def inputs(seed, n):
    config = small_config()
    layers = reference.layers_of(config)
    weights = reference.make_weights(layers, seed, "cpu")
    x_cal = model.make_images(1, config["input"], seed, 1, "cpu")
    x = model.make_images(n, config["input"], seed, 2, "cpu")
    m_in, specs = reference.calibrate(layers, weights, x_cal)
    return config, layers, weights, x, m_in, specs


def program(config, layers, weights, specs, mode="fullflow",
            clip_as_relu=False, device="cpu"):
    """The program built as the benchmark's harness builds it; with
    ``clip_as_relu`` every ``Clip`` of the model dict is a ``Relu``."""
    d = reference.model_dict(config, layers)
    if clip_as_relu:
        for n in d["nodes"]:
            if n["op_type"] == "Clip":
                n["op_type"], n["inputs"] = "Relu", n["inputs"][:1]
    inits = {}
    for n, (w, b) in weights.items():
        inits[f"{n}_w"], inits[f"{n}_b"] = w.numpy(), b.numpy()
    gate = CNN2Gate.from_graph(onnx_lite.from_model_dict(d, inits),
                               device=device)
    gate.apply_quantization({n: QuantSpec(*s) for n, s in specs.items()})
    return gate, gate.build(mode)


# ------------------------------------------------------------- the parser

def _conv_clip_graph(form="initializer", lo=0.0, hi=6.0, on="conv"):
    """input -> Conv -> Clip -> GAP -> FC; or the Clip on the graph input
    (``on="input"``), behind an Add or the FC, or on a conv output that
    a Relu reads too (``"fanout"``)."""
    rng = np.random.default_rng(0)
    inits = {"c_w": rng.standard_normal((4, 3, 3, 3)).astype(np.float32),
             "c_b": np.zeros(4, np.float32),
             "f_w": rng.standard_normal((4, 2)).astype(np.float32),
             "f_b": np.zeros(2, np.float32)}
    nodes = []

    def clip(src):
        if form == "initializer":
            inits["clip_min"] = np.asarray(lo, np.float32)
            inits["clip_max"] = np.asarray(hi, np.float32)
            nodes.append(Node("Clip", "clip", [src, "clip_min", "clip_max"],
                              ["clip_o"]))
        else:
            nodes.append(Node("Clip", "clip", [src], ["clip_o"],
                              {"min": lo, "max": hi}))
        return "clip_o"

    cur = clip("input") if on == "input" else "input"
    nodes.append(Node("Conv", "c", [cur, "c_w", "c_b"], ["c_o"],
                      {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1]}))
    cur = "c_o"
    if on == "conv":
        cur = clip(cur)
    elif on == "add":
        nodes.append(Node("Add", "a", [cur, cur], ["a_o"]))
        cur = clip("a_o")
    elif on == "fanout":
        nodes.append(Node("Relu", "r", [cur], ["r_o"]))
        nodes.append(Node("Add", "a", ["r_o", clip(cur)], ["a_o"]))
        cur = "a_o"
    nodes += [Node("GlobalAveragePool", "g", [cur], ["g_o"]),
              Node("Flatten", "fl", ["g_o"], ["fl_o"], {"axis": 1}),
              Node("Gemm", "f", ["fl_o", "f_w", "f_b"], ["f_o"])]
    out = clip("f_o") if on == "fc" else "f_o"
    return Graph("t", nodes, [TensorInfo("input", (1, 3, 8, 8))], [out],
                 inits)


@pytest.mark.parametrize("form", ["initializer", "attribute"])
def test_both_clip_forms_fuse_into_the_conv(form):
    parsed = P.parse(_conv_clip_graph(form))
    (conv,) = [li for li in parsed.layers if li.kind == P.CONV]
    assert conv.relu and conv.clip_max == 6.0
    assert conv.output == "clip_o"
    assert [li.kind for li in parsed.layers] == [P.CONV, P.POOL, P.FC]


@pytest.mark.parametrize("case,why", [
    (dict(lo=-1.0), "min must be 0"),
    (dict(lo=1.0, form="attribute"), "min must be 0"),
    (dict(hi=float("inf"), form="attribute"), "max must be finite"),
    (dict(hi=None, form="attribute"), "max must be finite"),
    (dict(hi=-2.0), "max must be finite"),
    (dict(on="input"), "cannot be fused"),
    (dict(on="add"), "cannot be fused into the add stage"),
    (dict(on="fc"), "cannot be fused into the fc stage"),
    (dict(on="fanout"), "cannot be fused"),
])
def test_a_clip_the_epilogue_cannot_take_raises(case, why):
    with pytest.raises(GraphValidationError, match=why) as err:
        P.parse(_conv_clip_graph(**case))
    assert err.value.node == "clip"


def test_the_clamp_code_rule():
    assert clamp_code(6.0, 4) == 96 and clamp_code(6.0, 5) == 127
    assert clamp_code(6.0, -1) == 3 and clamp_code(6.0, -3) == 0
    assert clamp_code(6.0, 3) == 48 and clamp_code(0.5, 6) == 32
    assert reference.clamp_code(6.0, 4) == 96
    assert reference.clamp_code(6.0, 1, bits=4) == 7


def test_the_plain_epilogue_clamps_at_hi():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-128, 128, (2, 9, 9, 8), np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (3, 3, 8, 16), np.int8))
    plain = qconv.qconv2d_plain(x, w, None, shift=7, pads=(1, 1, 1, 1))
    got = qconv.qconv2d_plain(x, w, None, shift=7, pads=(1, 1, 1, 1), hi=40)
    assert int(plain.max()) > 40
    assert torch.equal(got, plain.clamp(0, 40))
    dw = torch.from_numpy(rng.integers(-128, 128, (3, 3, 1, 8), np.int8))
    got = qconv.qdwconv2d(x, dw, None, shift=5, pads=(1, 1, 1, 1), hi=9)
    want = qconv.qdwconv2d_plain(x, dw, None, shift=5, pads=(1, 1, 1, 1))
    assert torch.equal(got, want.clamp(0, 9))


# ------------------------------------------- the program and the reference

@pytest.mark.parametrize("seed", SEEDS)
def test_the_program_equals_the_reference(seed):
    config, layers, weights, x, m_in, specs = inputs(seed, 6)
    gate, ex = program(config, layers, weights, specs)
    want = reference.int_forward(layers, weights, m_in, specs, x, block=4)
    got = torch.cat([ex(x[:1]), ex(x[1:])])
    assert torch.equal(got, want)
    assert torch.unique(want).numel() > 50
    assert sum(li.merge is not None for li in gate.parsed.layers) == 10
    assert sum(li.clip_max == 6.0 for li in gate.parsed.layers) == 35


@pytest.mark.parametrize("seed", SEEDS)
def test_the_clamp_matters(seed):
    """Stages reach their clamp code below 127, and the same graph with
    ``Relu`` in each ``Clip``'s place gives other logits."""
    config, layers, weights, x, m_in, specs = inputs(seed, 4)
    gate, ex = program(config, layers, weights, specs, mode="emulation")
    hi = {ql.info.output: ql.hi for ql in gate.quantized.layers}
    audit = t_pipe.make_executor(gate.quantized, audit=True)
    y, stats = audit(x)
    reached = [t for t, s in t_pipe.stats_to_host(stats).items()
               if hi.get(t, 127) < 127 and int(s[1]) == hi[t]]
    assert len(reached) >= 10
    _gate, relu = program(config, layers, weights, specs, mode="emulation",
                          clip_as_relu=True)
    assert int((relu(x) != y).sum()) > 0


def test_an_epilogue_that_drops_the_clamp_fails_the_comparison(monkeypatch):
    config, layers, weights, x, m_in, specs = inputs(SEEDS[1], 4)
    want = reference.int_forward(layers, weights, m_in, specs, x)
    plain = qconv.epilogue_plain

    def no_clamp(acc, b, *, hi=127, **kw):
        return plain(acc, b, **kw)
    monkeypatch.setattr(qconv, "epilogue_plain", no_clamp)
    _gate, ex = program(config, layers, weights, specs, mode="emulation")
    assert int((ex(x) != want).sum()) > 0


def test_the_specs_are_the_programs_own_rule():
    config, layers, weights, x, m_in, specs = inputs(5, 1)
    gate, _ex = program(config, layers, weights, specs, mode="emulation")
    x_cal = model.make_images(1, config["input"], 5, 1, "cpu")
    theirs = gate.calibrate_quantization(x_cal.numpy())
    assert {n: (s.m_w, s.m_x, s.m_y) for n, s in theirs.items()} == specs
    assert gate.quantized.input_m == m_in


def _counts():
    reg = tele.get_registry()
    return tuple(reg.counter(n).value for n in ("build.clipped_stages",
                                                "build.fused_skips"))


def test_the_build_counts_its_clamps_and_skips():
    config, layers, weights, _x, _m, specs = inputs(SEEDS[1], 1)
    before = _counts()
    gate, _ex = program(config, layers, weights, specs)
    assert tuple(np.subtract(_counts(), before)) == (35, 10)
    graph = cnn.mobilenet_v2(batch=1, in_hw=64, num_classes=10)
    zoo = CNN2Gate.from_graph(graph, device="cpu")
    zoo.calibrate_quantization(np.random.default_rng(1).standard_normal(
        graph.inputs[0].shape).astype(np.float32))
    before = _counts()
    zoo.build("emulation")
    assert tuple(np.subtract(_counts(), before)) == (35, 10)
    # ResNet-18 has no clamp
    r = CNN2Gate.from_graph(cnn.resnet_tiny(), device="cpu")
    r.calibrate_quantization(np.zeros((1, 3, 32, 32), np.float32))
    before = _counts()
    r.build("emulation")
    assert tuple(np.subtract(_counts(), before)) == (0, 2)


def test_the_zoo_builder_at_its_published_widths():
    graph = cnn.mobilenet_v2(batch=1)
    parsed = P.parse(graph)
    convs = [li for li in parsed.layers if li.kind == P.CONV]
    assert len(convs) == 52
    assert sum(li.is_depthwise for li in convs) == 17
    assert sum(li.clip_max == 6.0 for li in convs) == 35
    assert sum(li.merge is not None for li in convs) == 10
    assert all(not li.merge.relu for li in convs if li.merge is not None)
    weighted = [li for li in parsed.layers if li.kind in (P.CONV, P.FC)]
    assert round(sum(li.macs for li in weighted) / 1e6, 1) == 300.8
    assert round(parsed.total_weights / 1e6, 2) == 3.47


def test_the_guard_carries_the_clamp():
    """A guarded build of a clipped model and its unfused rung run the
    clamp: with no fault the guard passes the program's own logits, and
    the unfused program gives them too."""
    config, layers, weights, x, _m, specs = inputs(SEEDS[2], 2)
    gate, ex = program(config, layers, weights, specs, mode="emulation")
    y, report = gate.build_guarded(
        x_cal=x, policy=GuardPolicy(margin=0.0, sat_tol=0.0))(x)
    assert not report.detected and torch.equal(y, ex(x))
    unfused = t_pipe.build_quantized(
        P.parse(gate.parsed.graph, fuse_skip=False, fuse_concat=False),
        gate.specs, device="cpu")
    assert sum(ql.hi < 127 for ql in unfused.layers) == 35
    assert torch.equal(t_pipe.make_executor(unfused)(x), ex(x))


def test_the_verifier_runs_the_clipped_program():
    """The static checks pass on the clipped program, and the probes'
    executor trace runs it: ten fused adds leave no standalone add."""
    config, layers, weights, _x, _m, specs = inputs(SEEDS[1], 1)
    gate, _ex = program(config, layers, weights, specs, mode="emulation")
    assert not gate.verify().errors
    assert TV.structural_probes(gate.quantized) == []
    trace = TV.executor_trace(gate.quantized)
    assert TV.int_add_calls(trace) == 0
    assert len(TV.kernel_call_arities(trace)) == 53


def test_the_trial_form_carries_the_clamp():
    """SER's trial form: each trial's logits equal the single executor's
    on that trial's faulty weights, clamps included."""
    config, layers, weights, x, _m, specs = inputs(SEEDS[0], 1)
    gate, _ex = program(config, layers, weights, specs, mode="emulation")
    qm = gate.quantized
    names = ["block2_expand", "block3_dw", "head"]
    plans = [TF.FaultPlan((TF.Fault(TF.WEIGHT_BIT, n, index=3 + t, bit=6),))
             for t, n in enumerate(names)]
    ex = t_pipe.make_executor(qm, weight_args=names)
    got = t_pipe.vmap_trials(ex)(x, TF.trial_weights(qm, plans, names))
    for t, plan in enumerate(plans):
        assert torch.equal(got[t], t_pipe.make_executor(
            TF.inject(qm, plan))(x))


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the clamp runs in CUDA kernels "
                    "(the plain version's tests above run here)")
    return torch.device("cuda", 0)


#: (name, H = W, Cin, Cout, K, stride, pad, depthwise, hi): MobileNetV2's
#: own shapes, the 1x1s with narrow N tiles (Cout 16/24) and the 4-byte
#: gather (Cin 24), the depthwise convs at C 96/144/960, strides 1 and 2
CARD_CONVS = [
    ("stem_3x3_s2", 224, 3, 32, 3, 2, 1, False, 96),
    ("project_112x32_16", 112, 32, 16, 1, 1, 0, False, 127),
    ("expand_112x16_96", 112, 16, 96, 1, 1, 0, False, 96),
    ("project_56x144_24", 56, 144, 24, 1, 1, 0, False, 127),
    ("expand_56x24_144", 56, 24, 144, 1, 1, 0, False, 48),
    ("head_7x320_1280", 7, 320, 1280, 1, 1, 0, False, 96),
    ("dw_112x96_s2", 112, 96, 96, 3, 2, 1, True, 96),
    ("dw_56x144_s1", 56, 144, 144, 3, 1, 1, True, 96),
    ("dw_56x144_s2", 56, 144, 144, 3, 2, 1, True, 24),
    ("dw_7x960_s1", 7, 960, 960, 3, 1, 1, True, 96),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CONVS, ids=lambda c: c[0])
@pytest.mark.parametrize("batch", [1, 8])
def test_the_kernels_clamp_as_the_plain_version(card, case, batch):
    _name, h, cin, cout, k, s, p, dw, hi = case
    rng = np.random.default_rng(h + cin + cout)
    x = torch.from_numpy(rng.integers(-128, 128, (batch, h, h, cin),
                                      np.int8))
    w = torch.from_numpy(rng.integers(
        -128, 128, (k, k, 1 if dw else cin, cout), np.int8))
    b = torch.from_numpy(rng.integers(-4000, 4000, cout, np.int32))
    fn = qconv.qdwconv2d if dw else qconv.qconv2d
    kw = dict(strides=(s, s), pads=(p,) * 4, relu=True)
    # the widest shift at which 1 % of the unclamped values pass hi, so
    # that the clamp acts on some of them and leaves the rest
    shift = int(math.log2(k * k * (1 if dw else cin))) + (
        12 if hi < 127 else 6)
    while hi < 127 and shift > 0 and float(
            (fn(x, w, b, shift=shift, **kw) > hi).float().mean()) < 0.01:
        shift -= 1
    want = fn(x, w, b, shift=shift, hi=hi, **kw)
    got = fn(x.to(card), w.to(card), b.to(card), shift=shift, hi=hi, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if hi < 127:
        assert int(want.max()) == hi


def _mobilenet_gate(dev):
    graph = cnn.mobilenet_v2(batch=1, seed=0)
    # without the zoo's softmax: the logits are exact integers on any
    # device, float32 softmax is not
    d = onnx_lite.to_model_dict(graph)
    softmax = d["nodes"].pop()
    d["outputs"] = softmax["inputs"]
    gate = CNN2Gate.from_graph(
        onnx_lite.from_model_dict(d, graph.initializers), device=dev)
    rng = np.random.default_rng(0)
    gate.calibrate_quantization(
        rng.standard_normal((1, 3, 224, 224)).astype(np.float32))
    return gate, rng.standard_normal((1, 3, 224, 224)).astype(np.float32)


@pytest.mark.cuda
def test_an_eager_forward_launches_the_depthwise_kernel_17_times(card):
    gate, x = _mobilenet_gate(card)
    run = gate.build("emulation")
    ops.reset_launch_counts()
    y = run(torch.as_tensor(x, device=card))
    torch.cuda.synchronize()
    assert qconv.launches["qdwconv2d"] == 17
    assert qconv.padded_launches["qdwconv"] == 17   # pads in the staging
    assert "copy" not in qconv.padded_launches
    assert qconv.skip_launches["qdwconv.clip"] == 17
    assert qconv.skip_launches["qconv.clip"] == 18
    assert qconv.skip_launches["qconv"] == 10
    cpu = CNN2Gate.from_graph(gate.parsed.graph, device="cpu")
    cpu.apply_quantization(gate.specs)
    assert torch.equal(y.cpu(), cpu.build("emulation")(x))


@pytest.mark.cuda
def test_the_captured_forward_holds_17_depthwise_launches(card):
    gate, x = _mobilenet_gate(card)
    full = gate.build("fullflow")
    xt = torch.as_tensor(x, device=card)
    rows = full.stage_map[tuple(xt.shape)]
    convs = {name: n for name, kind, n in rows if kind == "conv"}
    dw = [li.name for li in gate.parsed.layers if li.is_depthwise]
    assert len(dw) == 17 and len(convs) == 52
    # every conv stage, depthwise or dense, is its kernel alone: the
    # depthwise kernel takes its pads in its band staging
    assert all(convs[n] == 1 for n in dw)
    assert all(v == 1 for n, v in convs.items() if n not in dw)
    full(xt)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = full(xt)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA"]
    assert sum("qdwconv" in n for n in names) == 17
    assert torch.equal(y, gate.build("emulation")(xt))

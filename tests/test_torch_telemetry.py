"""The port's tracer and the spans of the fullflow path.

On the CPU: a tracer that is off records nothing; spans carry a request
id and a parent; their timestamps lie on the Unix epoch (the clock of
``torch.profiler``'s device trace); ``launch.profile``'s Chrome trace
keeps its format; set-up records ``gate.parse`` -> ``gate.quantize`` ->
``gate.build`` with their children; the executor's per-stage callback
runs once for the ingress, each stage in schedule order and the egress,
and changes no logit.  On the card (``cuda``): the captured executor's
spans and counters, its stage map against the graph's own device
operations, and no capture during calls after the build.
"""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import pipeline as pipe
from repro_torch.core import telemetry as tele
from repro_torch.core.synthesis import CNN2Gate, CapturedExecutor
from repro_torch.kernels import _build
from repro_torch.launch import profile as prof
from repro_torch.models import cnn

CHROME_KEYS = {"name", "cat", "ph", "ts", "dur", "pid", "tid"}


def test_a_tracer_that_is_off_records_nothing():
    # off is no tracer: quantization given none records on no tracer,
    # the process tracer included, and stages the same program
    g = cnn.tiny_cnn(batch=1)
    setup = tele.Tracer()
    gate = CNN2Gate.from_graph(g, device="cpu", tracer=setup)
    gate.calibrate_quantization(np.random.default_rng(3).standard_normal(
        g.inputs[0].shape).astype(np.float32))
    n_setup = len(setup.events())
    tele.reset()
    qm = pipe.build_quantized(gate.parsed, gate.specs, device="cpu")
    assert tele.get_tracer().events() == [] and tele.get_tracer().dropped == 0
    assert len(setup.events()) == n_setup
    for a, b in zip(qm.layers, gate.quantized.layers):
        assert (a.w_q is None) == (b.w_q is None)
        assert a.w_q is None or torch.equal(a.w_q, b.w_q)
    tr = tele.Tracer()
    assert tr.events() == []
    with tr.span("s"):
        pass
    assert [e["name"] for e in tr.events()] == ["s"]


def test_spans_carry_their_request_id_and_parent():
    tr = tele.Tracer()
    with tr.span("request", rid=7):
        with tr.span("step"):
            with tr.span("inner", rid=8):
                pass
    t0 = time.perf_counter_ns()
    t = [t0 + i * 1000 for i in range(4)]
    tr.record("call", t[0], t[3], 9, steps=("a", "b", "c"), stamps=t)
    ev = {e["name"]: e for e in tr.events()}
    assert ev["request"]["args"] == {"rid": 7}
    assert ev["step"]["args"] == {"rid": 7, "parent": "request"}
    assert ev["inner"]["args"] == {"rid": 8, "parent": "step"}
    assert ev["call"]["args"] == {"rid": 9}
    for i, name in enumerate("abc"):
        assert ev[name]["args"] == {"rid": 9, "parent": "call"}
        # a float of Unix-epoch microseconds holds a quarter of one
        assert ev[name]["ts"] == pytest.approx(ev["call"]["ts"] + i,
                                               abs=0.5)
        assert ev[name]["dur"] == pytest.approx(1.0)
    assert ev["call"]["dur"] == pytest.approx(3.0)


def test_span_timestamps_lie_on_the_unix_epoch():
    tr = tele.Tracer()
    tr.reset()
    before = time.time_ns()
    with tr.span("s"):
        time.sleep(0.002)
    t0 = time.perf_counter_ns()
    t1 = time.perf_counter_ns()
    tr.record("r", t0, t1)
    after = time.time_ns()
    for ev in tr.events():
        # microseconds, to within the float's rounding at 1.8e15
        assert before * 1e-3 - 1 <= ev["ts"]
        assert ev["ts"] + ev["dur"] <= after * 1e-3 + 1
    s = tr.events()[0]
    assert s["dur"] >= 2000
    # add_span keeps now_us()'s clock: microseconds since the anchor
    tr.add_span("x", tr.now_us(), 5.0)
    x = tr.events()[-1]
    assert before * 1e-3 - 1 <= x["ts"] <= time.time_ns() * 1e-3 + 1


def test_the_chrome_trace_of_launch_profile_keeps_its_format(tmp_path):
    tr = tele.Tracer()
    doc = prof.profile_model("tiny_cnn", iters=1, warmup=1, tracer=tr,
                             device="cpu")
    trace = json.loads(Path(tr.export(str(tmp_path / "t.json")))
                       .read_text())
    assert trace["displayTimeUnit"] == "ms"
    stages = [e for e in trace["traceEvents"] if e["cat"] == "stage"]
    assert len(stages) == 2 * (doc["summary"]["n_stages"] + 2)
    for e in trace["traceEvents"]:
        assert set(e) - {"args"} == CHROME_KEYS and e["ph"] == "X"
        assert e["dur"] >= 0
    for e in stages:
        assert set(e["args"]) == {"kind", "model"}
    runs = {e["name"]: e for e in trace["traceEvents"]
            if e["cat"] == "profile"}
    assert set(runs) == {"profile.warmup:tiny_cnn",
                         "profile.measure:tiny_cnn"}
    assert runs["profile.measure:tiny_cnn"]["args"] == {"iters": 1}


def _by_name(tr):
    out = {}
    for e in tr.events():
        out.setdefault(e["name"], []).append(e)
    return out


def _inside(child, parent):
    """Containment, to the half microsecond that a float of Unix-epoch
    microseconds holds."""
    return (parent["ts"] <= child["ts"] + 0.5
            and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + 0.5)


def test_setup_spans_nest_from_parse_to_build():
    tr = tele.Tracer()
    g = cnn.resnet_tiny(batch=1)
    gate = CNN2Gate.from_graph(g, device="cpu", tracer=tr)
    x = np.random.default_rng(2).standard_normal(
        g.inputs[0].shape).astype(np.float32)
    gate.calibrate_quantization(x)
    gate.build("fullflow")
    ev = _by_name(tr)
    assert {n: len(v) for n, v in ev.items() if n.startswith("gate.")} == \
        {"gate.parse": 1, "gate.quantize": 1, "gate.build": 1}
    parse, quant, build = (ev[n][0] for n in ("gate.parse", "gate.quantize",
                                              "gate.build"))
    assert parse["ts"] + parse["dur"] <= quant["ts"] <= build["ts"]
    weighted = [ql.info.name for ql in gate.quantized.layers
                if ql.w_q is not None]
    for name in ("quantize.numpy", "quantize.stage"):
        assert [e["args"]["stage"] for e in ev[name]] == weighted
    assert [e["args"]["rules"] for e in ev["quantize.verify"]] == \
        ["structural", "staged"]
    for name in ("quantize.numpy", "quantize.stage", "quantize.verify"):
        for e in ev[name]:
            assert e["args"]["parent"] == "gate.quantize"
            assert _inside(e, quant)
    assert build["args"]["mode"] == "fullflow"
    assert all(e["cat"] == "setup" for v in ev.values() for e in v)


def test_setup_spans_go_to_the_process_tracer_by_default():
    g = cnn.tiny_cnn(batch=1)
    tele.reset()
    gate = CNN2Gate.from_graph(g, device="cpu")
    assert gate.tracer is tele.get_tracer()
    assert [e["name"] for e in tele.get_tracer().events()] == ["gate.parse"]


@pytest.mark.parametrize("name", ["tiny_cnn", "resnet_tiny",
                                  "googlenet_tiny", "mobilenet_tiny"])
def test_the_stage_callback_runs_once_a_stage_in_schedule_order(name):
    g = getattr(cnn, name)(batch=2)
    gate = CNN2Gate.from_graph(g, device="cpu", tracer=tele.Tracer())
    x = np.random.default_rng(4).standard_normal(
        g.inputs[0].shape).astype(np.float32)
    gate.calibrate_quantization(x)
    calls = []
    ex = pipe.make_executor(gate.quantized,
                            on_stage=lambda s, k: calls.append((s, k)))
    y = ex(x)
    want = ([("ingress", "ingress")]
            + [(ql.info.name, ql.info.kind) for ql in gate.quantized.layers]
            + [("egress", "egress")])
    assert calls == want
    assert torch.equal(y, pipe.make_executor(gate.quantized)(x))


def test_the_stage_callback_is_exclusive_with_the_stage_timed_executor():
    g = cnn.tiny_cnn(batch=1)
    gate = CNN2Gate.from_graph(g, device="cpu", tracer=tele.Tracer())
    gate.calibrate_quantization(np.zeros(g.inputs[0].shape, np.float32))
    with pytest.raises(ValueError, match="stage_timed"):
        pipe.make_executor(gate.quantized, stage_timed=True,
                           on_stage=lambda s, k: None)


def test_a_kernel_library_load_is_a_span_and_a_compile_is_counted(
        monkeypatch):
    # a compile shows as ``compiled`` in the span's args
    tele.reset()
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build_all",
                        lambda names: {n: 1.5 for n in names})
    monkeypatch.setattr(_build, "_lib_path", lambda name: Path(name))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    lib = _build.load("probe_lib", {})
    assert _build.load("probe_lib", {}) is lib      # loaded once
    (ev,) = tele.get_tracer().events()
    assert ev["name"] == "kernels.load" and ev["cat"] == "setup"
    assert ev["args"] == {"library": "probe_lib", "compiled": True}
    monkeypatch.setattr(_build, "build_all",
                        lambda names: {n: 0.0 for n in names})
    _build.load("probe_lib_built", {})
    ev = tele.get_tracer().events()[-1]
    assert ev["args"] == {"library": "probe_lib_built", "compiled": False}
    assert len(tele.get_tracer().events()) == 2


# -------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA-graph executor only "
                    "exists on the card")
    return torch.device("cuda", 0)


def _fullflow(name, device, tracer=None):
    g = getattr(cnn, name)(batch=1)
    gate = CNN2Gate.from_graph(g, device=device,
                               tracer=tracer or tele.Tracer())
    x = np.random.default_rng(6).standard_normal(
        g.inputs[0].shape).astype(np.float32)
    gate.calibrate_quantization(x)
    return gate, gate.build("fullflow"), x


@pytest.mark.cuda
def test_captured_executor_spans_and_counters(card):
    setup = tele.Tracer()
    gate, full, x = _fullflow("resnet_tiny", card, setup)
    assert isinstance(full, CapturedExecutor) and full.tracer is None
    (cap,) = [e for e in setup.events() if e["name"] == "captured.capture"]
    assert cap["args"]["shape"] == list(x.shape)
    assert cap["args"]["parent"] == "gate.build"
    full.registry = reg = tele.MetricsRegistry()
    n_setup = len(setup.events())
    full(x)                                         # tracer off
    full.tracer = tr = tele.Tracer()
    requests = [x, torch.from_numpy(x), torch.as_tensor(x, device=card)]
    ys = [full(r) for r in requests]
    want = gate.build("emulation")(x)
    assert all(torch.equal(y, want) for y in ys)
    ev = _by_name(tr)
    assert sorted(ev) == ["captured.call", "captured.clone_out",
                          "captured.copy_in", "captured.replay"]
    assert [e["args"]["rid"] for e in ev["captured.call"]] == [1, 2, 3]
    for step in CapturedExecutor.STEPS:
        for call, e in zip(ev["captured.call"], ev[step]):
            assert e["args"] == {"rid": call["args"]["rid"],
                                 "parent": "captured.call"}
            assert _inside(e, call)
    c = reg.snapshot()["counters"]
    assert c == {}                                  # no capture counted
    # a new shape inside a call is a capture after the build
    full(np.concatenate([x, x]))
    assert reg.counter("captured.captures").value == 1
    assert [e["name"] for e in setup.events()[n_setup:]].count(
        "captured.capture") == 1
    full.tracer = None
    full(x)
    assert len(tr.events()) == 4 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vgg16", "alexnet"])
def test_the_stage_map_covers_the_graphs_device_operations(card, name):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gate, full, x = _fullflow(name, card)
    shape = tuple(x.shape)
    rows = full.stage_map[shape]
    assert [r[:2] for r in rows] == (
        [("ingress", "ingress")]
        + [(ql.info.name, ql.info.kind) for ql in gate.quantized.layers]
        + [("egress", "egress")])
    assert all(n >= 0 for _, _, n in rows)
    assert all(n >= 1 for _, k, n in rows if k in ("conv", "fc"))
    graph = full.graphs[shape][0]
    graph.replay()
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        graph.replay()
        torch.cuda.synchronize(card)
    device = [e for e in p.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    assert sum(n for _, _, n in rows) == len(device)


@pytest.mark.cuda
def test_no_capture_is_counted_during_calls_after_the_build(card):
    _, full, x = _fullflow("alexnet", card)
    full.registry = reg = tele.MetricsRegistry()
    full.tracer = tele.Tracer()
    for _ in range(5):
        full(x)
    assert reg.counter("captured.captures").value == 0
    assert len(full.tracer.events()) == 5 * 4
    assert len(full.graphs) == 1

"""The port's stage-timed executor and attribution profile
(``repro_torch.launch.profile``) against the JAX package's.

``spearman`` is host arithmetic and must equal the reference's on fixed
inputs.  The stage-timed executor runs the same stage program as the
plain one: its logits must be ``torch.equal`` to the plain executor's,
every scheduled stage must be timed and traced, and it is exclusive with
the resilience hooks (``tests/test_telemetry.py``).  On the CPU the
walls time the plain versions, so the tests check the document's shape,
never its times.
"""
import json

import numpy as np
import pytest
import torch

from repro.launch import profile as r_profile
from repro_torch.core import pipeline as t_pipe
from repro_torch.core import telemetry as tele
from repro_torch.core import verify as TV
from repro_torch.core.synthesis import CNN2Gate
from repro_torch.launch import profile as prof
from repro_torch.models import cnn

PAIRS = [([1, 2, 3], [10, 20, 30]), ([1, 2, 3], [30, 20, 10]),
         ([1.0, 1.0, 1.0], [1, 2, 3]), ([1], [2]), ([1, 2], [1, 2, 3]),
         ([1.0, 4.0, 2.0, 8.0, 5.0], [1.0, 64.0, 8.0, 512.0, 125.0]),
         ([3, 1, 2, 2, 5, 5, 0], [0.1, 0.5, 0.2, 0.9, 0.3, 0.3, 0.0])]


@pytest.mark.parametrize("a,b", PAIRS)
def test_spearman_matches_the_reference(a, b):
    assert prof.spearman(a, b) == r_profile.spearman(a, b)
    np.testing.assert_array_equal(prof._ranks(a), r_profile._ranks(a))


def test_spearman_rank_correlation():
    assert prof.spearman([1, 2, 3], [10, 20, 30]) == pytest.approx(1.0)
    assert prof.spearman([1, 2, 3], [30, 20, 10]) == pytest.approx(-1.0)
    assert prof.spearman([1.0, 1.0, 1.0], [1, 2, 3]) is None
    assert prof.spearman([1], [2]) is None
    a = [1.0, 4.0, 2.0, 8.0, 5.0]
    assert prof.spearman(a, [v ** 3 for v in a]) == pytest.approx(1.0)
    assert prof.PROFILE_MODELS == r_profile.PROFILE_MODELS


@pytest.fixture(scope="module")
def gate():
    g = CNN2Gate.from_graph(cnn.googlenet_tiny(batch=1), device="cpu")
    x = (np.random.default_rng(13).standard_normal(g.parsed.input_shape)
         * 0.5).astype(np.float32)
    g.calibrate_quantization(x)
    return g, x


def test_stage_timed_parity_and_coverage(gate):
    g, x = gate
    tr = tele.Tracer()
    timed = t_pipe.make_executor(g.quantized, stage_timed=True, tracer=tr)
    y1, timings = timed(x)
    assert torch.equal(y1, t_pipe.make_executor(g.quantized)(x))
    names = [t["stage"] for t in timings]
    scheduled = [ql.info.name for ql in g.quantized.layers]
    assert names == ["ingress"] + scheduled + ["egress"]
    assert [t["kind"] for t in timings[1:-1]] == \
        [ql.info.kind for ql in g.quantized.layers]
    assert all(t["wall_us"] >= 0 for t in timings)
    spans = {e["name"] for e in tr.events() if e.get("cat") == "stage"}
    assert set(scheduled) <= spans
    y2, _ = t_pipe.make_executor(g.quantized, stage_timed=True)(x)
    assert torch.equal(y1, y2)


def test_stage_timed_exclusive_with_hooks(gate):
    g, _ = gate
    qm = g.quantized
    for hook in (dict(audit=True), dict(audit=["relu_5_out"]),
                 dict(faults={"input": {}}),
                 dict(checkpoints=[qm.layers[0].info.name]),
                 dict(weight_args=["conv_1"]), dict(fault_args=["input"]),
                 dict(replay_from=0)):
        with pytest.raises(ValueError, match="stage_timed"):
            t_pipe.make_executor(qm, stage_timed=True, **hook)


def test_telemetry_off_keeps_the_ops_calls(gate):
    g, _ = gate
    base = TV.executor_trace(g.quantized)
    tele.get_tracer().add_span("noise", 0.0, 1.0)
    tele.get_registry().counter("noise").inc()
    try:
        probe = TV.executor_trace(g.quantized, stage_timed=False,
                                  tracer=None)
    finally:
        tele.reset()
    assert probe == base


def test_profile_model_report_shape():
    tr = tele.Tracer()
    doc = prof.profile_model("tiny_cnn", iters=1, warmup=1, tracer=tr,
                             device="cpu")
    s = doc["summary"]
    assert s["n_stages"] == len(doc["stages"]) > 0
    for row in doc["stages"]:
        for key in ("stage", "kind", "wall_us", "model_us", "ddr_bytes",
                    "vmem_bytes", "macs", "model_wall_ratio"):
            assert key in row
        assert row["wall_us"] >= 0 and row["model_us"] > 0
    assert set(doc["overhead_us"]) == {"ingress", "egress"}
    assert doc["device"] == "cpu" and doc["device_name"] == "cpu"
    json.dumps(doc)


def test_profile_rows_join_the_reference_models():
    """The modeled side of the join is the JAX package's FPGA model: the
    same stages, kinds, bytes and modeled microseconds."""
    doc = prof.profile_model("resnet_tiny", iters=1, warmup=1,
                             tracer=tele.Tracer(), device="cpu")
    from repro.core.resources import FPGA_BOARDS, modeled_stage_costs
    from repro.core.synthesis import CNN2Gate as RGate
    from repro.models import cnn as r_cnn
    rg = RGate.from_graph(r_cnn.resnet_tiny(batch=1))
    want = modeled_stage_costs(rg.parsed, FPGA_BOARDS["ARRIA10"], 16, 32)
    assert [r["stage"] for r in doc["stages"]] == list(want)
    for row in doc["stages"]:
        w = want[row["stage"]]
        assert (row["kind"], row["ddr_bytes"], row["vmem_bytes"],
                row["macs"]) == (w["kind"], w["ddr_bytes"], w["vmem_bytes"],
                                 w["macs"])
        assert row["model_us"] == w["model_s"] * 1e6


def test_profile_cli_writes_its_own_document(tmp_path, capsys):
    out, trace = tmp_path / "profile.json", tmp_path / "t" / "trace.json"
    assert prof.main(["--models", "tiny_cnn", "--device", "cpu",
                      "--iters", "1", "--out", str(out),
                      "--trace", str(trace)]) == 0
    doc = json.loads(out.read_text())
    assert set(doc) == {"models", "telemetry", "env"}
    assert doc["models"]["tiny_cnn"]["summary"]["n_stages"] == 4
    assert json.loads(trace.read_text())["traceEvents"]
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        prof.main(["--models", "vgg99", "--device", "cpu"])

"""The port's resource models and design-space exploration against the
JAX package's.

Both are host arithmetic copied line for line, so the tolerance is
exact equality: the same reports, the same working sets, the same
checkpoint plans, and the same fitter trajectories (best, F_max, unique
evaluations, steps and the whole history) for the same seed.  The
graphs of both packages are built from the same seeded builders (the
big ones converted once, sharing their weights).  The last tests run
the JAX package's own DSE scenarios (``tests/test_dse.py``,
``tests/test_robust_eval.py``, the Table-1 pins of
``tests/test_cnn_pipeline.py``) on the port.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from repro.core import dse as r_dse
from repro.core import onnx_lite as r_onnx
from repro.core import resources as r_res
from repro.core.parser import parse as r_parse
from repro.core.spaces import CNNDesignSpace as RSpace
from repro.core.synthesis import CNN2Gate as RGate
from repro.models import cnn as r_cnn
from repro_torch import convert
from repro_torch.core import dse as t_dse
from repro_torch.core import resources as t_res
from repro_torch.core.parser import parse as t_parse
from repro_torch.core.spaces import CNNDesignSpace as TSpace
from repro_torch.core.synthesis import CNN2Gate as TGate

SMALL = ["resnet_tiny", "mobilenet_tiny", "googlenet_tiny",
         "squeezenet_tiny"]
MODELS = ["alexnet", "vgg16"] + SMALL
BOARDS = ["5CSEMA4", "5CSEMA5", "ARRIA10"]
GRID = [(1, 1, None), (2, 4, 4), (4, 8, 8), (8, 8, 16), (16, 32, 32),
        (16, 32, None), (8, 16, 1)]


@pytest.fixture(scope="module")
def graphs():
    """name -> (JAX package graph, port graph); the port's is converted
    from the JAX package's and shares its weights."""
    cache = {}

    def get(name):
        if name not in cache:
            rg = getattr(r_cnn, name)(batch=1)
            tg = convert.graph_from_model_dict(r_onnx.to_model_dict(rg),
                                               rg.initializers)
            cache[name] = (rg, tg)
        return cache[name]
    return get


@pytest.fixture(scope="module")
def parsed(graphs):
    """(name, fused) -> (JAX package parse, port parse)."""
    cache = {}

    def get(name, fused=True):
        if (name, fused) not in cache:
            rg, tg = graphs(name)
            cache[name, fused] = (
                r_parse(rg, fuse_skip=fused, fuse_concat=fused),
                t_parse(tg, fuse_skip=fused, fuse_concat=fused))
        return cache[name, fused]
    return get


def _report(rep):
    return (rep.percents, rep.raw, rep.fits, rep.f_avg)


def _result(res):
    return (res.best, None if res.best_report is None
            else _report(res.best_report), res.f_max, res.evaluations,
            res.steps, res.history)


# ------------------------------------------------------ resource models

def test_board_profiles_and_caps_are_the_reference_s():
    assert set(t_res.FPGA_BOARDS) == set(r_res.FPGA_BOARDS)
    for name, board in r_res.FPGA_BOARDS.items():
        assert dataclasses.asdict(t_res.FPGA_BOARDS[name]) == \
            dataclasses.asdict(board)
        assert t_res.FPGA_BOARDS[name].reg == board.reg
    assert (t_res.NI_CAP, t_res.NL_CAP) == (r_res.NI_CAP, r_res.NL_CAP)
    # the card's profile carries the rates chip_smoke's bounds divide by
    assert t_res.H100.hbm_bandwidth == 3.35e12
    assert t_res.H100.peak_int8_ops == 1979e12
    assert t_res.H100.peak_bf16_flops == 989e12
    assert t_res.SMEM_BUDGET_BYTES == t_res.H100.smem_per_block


@pytest.mark.parametrize("name", MODELS)
def test_estimate_fpga_matches(parsed, name):
    rp, tp = parsed(name)
    assert tp.total_weights == rp.total_weights
    for board in BOARDS:
        for n_i, n_l, _bh in GRID:
            assert _report(t_res.estimate_fpga(
                t_res.FPGA_BOARDS[board], n_i, n_l, tp.total_weights)) == \
                _report(r_res.estimate_fpga(
                    r_res.FPGA_BOARDS[board], n_i, n_l, rp.total_weights))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", MODELS)
def test_conv_band_working_set_matches(parsed, name, fused):
    rp, tp = parsed(name, fused)
    for n_i, n_l, bh in GRID:
        for per_channel in (False, True):
            for ni in (n_i, None):
                want = r_res.conv_band_working_set(
                    rp.layers, n_l, bh, n_i=ni, per_channel=per_channel)
                got = t_res.conv_band_working_set(
                    tp.layers, n_l, bh, n_i=ni, per_channel=per_channel)
                assert got == want, (n_i, n_l, bh, per_channel)


@pytest.mark.parametrize("name", MODELS)
def test_modeled_stage_costs_match(parsed, name):
    rp, tp = parsed(name)
    for board in BOARDS:
        for n_i, n_l, bh in GRID[1:4]:
            for per_channel in (False, True):
                assert t_res.modeled_stage_costs(
                    tp, t_res.FPGA_BOARDS[board], n_i, n_l, bh,
                    per_channel) == r_res.modeled_stage_costs(
                    rp, r_res.FPGA_BOARDS[board], n_i, n_l, bh,
                    per_channel)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", MODELS)
def test_checkpoint_models_match(parsed, name, fused):
    rp, tp = parsed(name, fused)
    assert t_res.eligible_checkpoints(tp) == r_res.eligible_checkpoints(rp)
    assert t_res.concat_group_spans(tp) == r_res.concat_group_spans(rp)
    for b in range(len(rp.layers)):
        assert t_res.checkpoint_live_bytes(tp, b) == \
            r_res.checkpoint_live_bytes(rp, b)
    for k in range(5):
        plan = t_res.plan_checkpoints(tp, k)
        assert plan == r_res.plan_checkpoints(rp, k)
        assert t_res.checkpoint_bytes(tp, plan) == \
            r_res.checkpoint_bytes(rp, plan)


def test_fpga_layer_time_matches():
    rng = np.random.default_rng(0)
    for board in BOARDS:
        for _ in range(50):
            n_i, n_l = (int(v) for v in rng.choice([1, 2, 4, 8, 16, 32], 2))
            macs, a, w, o = (int(v) for v in rng.integers(0, 10 ** 9, 4))
            assert t_res.fpga_layer_time_s(
                t_res.FPGA_BOARDS[board], n_i, n_l, macs, a, w, o) == \
                r_res.fpga_layer_time_s(
                    r_res.FPGA_BOARDS[board], n_i, n_l, macs, a, w, o)


# ------------------------------------------------------------- fitters

SPACES = {
    "2axis": {},
    "3axis": {"block_h_options": [1, 4, 8, 32]},
    "4axis": {"block_h_options": [2, 8, 55],
              "checkpoint_options": [0, 1, 2]},
    "per_channel": {"block_h_options": [4, 16], "per_channel": True},
}


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("name", ["alexnet", "vgg16"])
def test_fitters_walk_the_reference_trajectory(parsed, name, space):
    rp, tp = parsed(name)
    kw = SPACES[space]
    for board in BOARDS:
        rs = RSpace(rp, r_res.FPGA_BOARDS[board], **kw)
        ts = TSpace(tp, t_res.FPGA_BOARDS[board], **kw)
        assert ts.options() == rs.options()
        assert ts.axes() == rs.axes() and ts.axis_names() == rs.axis_names()
        assert _result(t_dse.brute_force(ts)) == _result(r_dse.brute_force(rs))
        for seed in range(4):
            assert _result(t_dse.rl_dse(ts, seed=seed)) == \
                _result(r_dse.rl_dse(rs, seed=seed)), (board, seed)


def test_thresholds_and_eval_cost_match(parsed):
    rp, tp = parsed("alexnet")
    th = {"lut": 50.0, "dsp": 90.0, "mem": 100.0, "reg": 100.0}
    rs = RSpace(rp, r_res.FPGA_BOARDS["ARRIA10"])
    ts = TSpace(tp, t_res.FPGA_BOARDS["ARRIA10"])
    r_bf, t_bf = r_dse.brute_force(rs, th), t_dse.brute_force(ts, th)
    assert _result(t_bf) == _result(r_bf)
    r_rl = r_dse.rl_dse(rs, th, episodes=5, steps_per_episode=9, seed=7,
                        eval_cost_s=7.0)
    t_rl = t_dse.rl_dse(ts, th, episodes=5, steps_per_episode=9, seed=7,
                        eval_cost_s=7.0)
    assert _result(t_rl) == _result(r_rl)
    # the simulated compiler time is charged per unique evaluation
    assert t_rl.wall_time_s >= 7.0 * t_rl.evaluations


# ------------------------------------- the JAX package's DSE scenarios

@pytest.fixture(scope="module")
def alexnet_gate(graphs):
    return TGate(t_parse(graphs("alexnet")[1]), device="cpu")


@pytest.mark.parametrize("name,board,expected", [
    ("alexnet", "5CSEMA4", None), ("alexnet", "5CSEMA5", (8, 8)),
    ("alexnet", "ARRIA10", (16, 32)), ("vgg16", "5CSEMA4", None),
    # the calibrated RAM model charges VGG-16's 138 M weights 2.815
    # blocks a MB: 148 + 1.2*64 + 2.815*138.4 = 614 of 5CSEMA5's 397
    # blocks at (8, 8), so no option fits there, in both packages
    ("vgg16", "5CSEMA5", None), ("vgg16", "ARRIA10", (16, 32))])
def test_paper_table2_decisions(graphs, name, board, expected):
    gate = TGate(t_parse(graphs(name)[1]), device="cpu")
    assert gate.explore(board, algo="bf").best == expected
    for seed in range(3):
        assert gate.explore(board, algo="rl", seed=seed).best == expected


def test_5csema5_and_arria10_quotas_match_the_paper(alexnet_gate):
    p = alexnet_gate.explore("5CSEMA5", algo="bf").best_report.percents
    # paper Table 1: Logic 83 %, DSP 83 %, RAM 100 %
    assert abs(p["lut"] - 83) < 5 and abs(p["dsp"] - 83) < 5
    assert p["mem"] > 95
    p = alexnet_gate.explore("ARRIA10", algo="bf").best_report.percents
    # paper Table 3: Logic 30 %, DSP 20 %
    assert abs(p["lut"] - 30) < 3 and abs(p["dsp"] - 20) < 3
    with pytest.raises(ValueError, match="unknown DSE"):
        alexnet_gate.explore("ARRIA10", algo="sa")


def test_rl_fewer_compiler_calls_than_bf(alexnet_gate):
    """Table 2: RL-DSE ~25 % faster (fewer unique vendor-compiler calls)."""
    bf = alexnet_gate.explore("ARRIA10", algo="bf", eval_cost_s=7.0)
    rl = alexnet_gate.explore("ARRIA10", algo="rl", eval_cost_s=7.0, seed=0)
    assert rl.evaluations <= bf.evaluations
    assert rl.wall_time_s < bf.wall_time_s


def test_vgg_uses_about_8_percent_more_ram(graphs):
    gate = TGate(t_parse(graphs("vgg16")[1]), device="cpu")
    v = gate.explore("ARRIA10", algo="bf").best_report
    a = t_res.estimate_fpga(t_res.FPGA_BOARDS["ARRIA10"], 16, 32,
                            t_parse(graphs("alexnet")[1]).total_weights)
    assert 4 < v.percents["mem"] - a.percents["mem"] < 12


def test_rl_best_feasible_and_history_obeys_algorithm1(alexnet_gate):
    space = alexnet_gate.design_space("5CSEMA5")
    bf = t_dse.brute_force(space)
    for seed in range(6):
        rl = t_dse.rl_dse(space, seed=seed)
        if rl.found:
            assert all(v <= 100.0 for v in
                       space.evaluate(rl.best).percents.values())
            assert rl.f_max <= bf.f_max + 1e-9
        for opt, _f, ok in rl.history:
            assert ok == all(v <= 100.0 for v in
                             space.evaluate(opt).percents.values())


def test_options_respect_caps_and_divisibility(alexnet_gate):
    space = alexnet_gate.design_space("ARRIA10")
    for ni, nl in space.options():
        assert ni <= 16 and nl <= 32
        for li in alexnet_gate.parsed.layers[1:]:
            assert li.c_in % ni == 0


# ------------------------------------------ robust evaluation (journal)

def _flaky(report_cls, base):
    class FlakySpace(base):
        """One healthy candidate, one that always raises, one that hangs
        past the timeout, one that fails twice then succeeds (the best)."""

        HANG_S = 30.0

        def __init__(self):
            self.calls = {"good": 0, "raises": 0, "hangs": 0, "flaky": 0}

        def options(self):
            return [("good",), ("raises",), ("hangs",), ("flaky",)]

        def axes(self):
            return [["good", "raises", "hangs", "flaky"]]

        def evaluate(self, option):
            (name,) = option
            self.calls[name] += 1
            pct = {"good": 50.0, "hangs": 10.0, "flaky": 80.0}.get(name)
            if name == "raises":
                raise RuntimeError("compiler segfault")
            if name == "hangs":
                time.sleep(self.HANG_S)
            if name == "flaky" and self.calls[name] <= 2:
                raise OSError("license server flake")
            return report_cls(percents={k: pct for k in
                                        ("lut", "dsp", "mem", "reg")},
                              raw={"pct": pct}, fits=True)
    return FlakySpace


def _sweep(dse_mod, res_mod, journal):
    space = _flaky(res_mod.ResourceReport, dse_mod.DesignSpace)()
    robust = dse_mod.RobustEvaluator(space, timeout_s=0.3, retries=2,
                                     backoff_s=0.01, journal_path=journal)
    return space, robust, dse_mod.brute_force(robust)


def test_robust_sweep_quarantines_retries_and_resumes(tmp_path):
    t0 = time.perf_counter()
    space, robust, res = _sweep(t_dse, t_res, str(tmp_path / "t.json"))
    assert time.perf_counter() - t0 < 15.0   # one timeout, not HANG_S
    _rs, r_robust, r_res_ = _sweep(r_dse, r_res, str(tmp_path / "r.json"))
    assert res.best == r_res_.best == ("flaky",)
    assert res.f_max == r_res_.f_max == pytest.approx(80.0)
    assert space.calls == {"good": 1, "raises": 3, "hangs": 1, "flaky": 3}
    assert robust.stats == r_robust.stats
    assert sorted(robust.quarantined) == sorted(r_robust.quarantined)
    assert "RuntimeError" in robust.quarantined['["raises"]']
    assert "EvalTimeout" in robust.quarantined['["hangs"]']
    rep = robust.evaluate(("raises",))
    assert not rep.fits and rep.percents["lut"] == t_dse.FAILED_PCT
    # the journal: JSONL v2 in both, and a fresh evaluator resumes with
    # no evaluation at all
    with open(tmp_path / "t.json") as f:
        header = json.loads(f.readline())
    assert header == {"journal": "dse-robust-evaluator", "version": 2}
    space2, robust2, res2 = _sweep(t_dse, t_res, str(tmp_path / "t.json"))
    assert space2.calls == {"good": 0, "raises": 0, "hangs": 0, "flaky": 0}
    assert res2.best == ("flaky",) and robust2.stats["evaluated"] == 0
    assert robust2.stats["journal_hits"] == 4


def test_robust_journal_torn_tail_is_recovered(tmp_path):
    journal = str(tmp_path / "j.json")
    _sweep(t_dse, t_res, journal)
    with open(journal) as f:
        text = f.read()
    with open(journal, "w") as f:
        f.write(text[:-7])          # tear the last record mid-line
    space, robust, res = _sweep(t_dse, t_res, journal)
    assert robust.stats["journal_dropped"] == 1
    assert os.path.exists(journal + ".corrupt")
    assert res.best == ("flaky",)


def test_robust_rl_survives_hostile_space(tmp_path):
    space = _flaky(t_res.ResourceReport, t_dse.DesignSpace)()
    robust = t_dse.RobustEvaluator(space, timeout_s=0.3, retries=2,
                                   backoff_s=0.01,
                                   journal_path=str(tmp_path / "rl.json"))
    res = t_dse.rl_dse(robust, episodes=3, steps_per_episode=6, seed=0)
    assert space.calls["hangs"] <= 1
    assert res.steps == 18


def test_robust_counters_reach_the_port_registry():
    from repro_torch.core import telemetry as tele
    reg = tele.MetricsRegistry()
    space = _flaky(t_res.ResourceReport, t_dse.DesignSpace)()
    space.HANG_S = 0.0
    robust = t_dse.RobustEvaluator(space, retries=1, backoff_s=0.0,
                                   registry=reg)
    t_dse.brute_force(robust)
    snap = reg.snapshot()["counters"]
    assert snap["dse.evaluated"] == robust.stats["evaluated"] == 2
    assert snap["dse.quarantined"] == robust.stats["quarantined"] == 2


# ------------------------------------------------------ latency report

@pytest.mark.parametrize("name", MODELS)
def test_latency_report_matches_layer_by_layer(graphs, name):
    rg, tg = graphs(name)
    rgate, tgate = RGate.from_graph(rg), TGate.from_graph(tg, device="cpu")
    for board, n_i, n_l in (("ARRIA10", 16, 32), ("5CSEMA5", 8, 8),
                            ("5CSEMA4", 2, 4)):
        want = rgate.latency_report(board, n_i, n_l)
        got = tgate.latency_report(board, n_i, n_l)
        assert [dataclasses.astuple(l) for l in got.layers] == \
            [dataclasses.astuple(l) for l in want.layers]
        assert (got.total_s, got.gops) == (want.total_s, want.gops)


def test_latency_model_reproduces_table1(graphs):
    a_gate = TGate.from_graph(graphs("alexnet")[1], device="cpu")
    v_gate = TGate.from_graph(graphs("vgg16")[1], device="cpu")
    # Arria 10 @ (16,32): paper 18.24 ms / 205 ms
    a = a_gate.latency_report("ARRIA10", 16, 32).total_s * 1e3
    v = v_gate.latency_report("ARRIA10", 16, 32).total_s * 1e3
    assert abs(a - 18.24) / 18.24 < 0.05
    assert abs(v - 205.0) / 205.0 < 0.20
    # Cyclone V @ (8,8): paper 153 ms AlexNet
    c = a_gate.latency_report("5CSEMA5", 8, 8).total_s * 1e3
    assert abs(c - 153.0) / 153.0 < 0.05
    rep = a_gate.latency_report("ARRIA10", 16, 32)
    convs = [l for l in rep.layers if l.kind == "conv"]
    fcs = [l for l in rep.layers if l.kind == "fc"]
    assert len(convs) == 5 and len(fcs) == 3
    assert all(f.t_memory > f.t_compute for f in fcs)


# ------------------------------------------------------------ the CLIs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", module, *args], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_autotune_json_equals_the_reference_cli(tmp_path):
    args = ["--cnn", "alexnet", "--board", "5CSEMA5", "--algo", "bf",
            "--block-h", "1,2,55"]
    _cli("repro_torch.launch.autotune", *args, "--out",
         str(tmp_path / "t.json"))
    _cli("repro.launch.autotune", *args, "--out", str(tmp_path / "r.json"))
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == json.loads((tmp_path / "r.json").read_text())
    assert got["best"]["n_i"] == 8 and got["best"]["n_l"] == 8
    assert any(h["option"]["block_h"] == 55 and h["option"]["n_l"] == 8
               and not h["fits"] for h in got["history"])


def test_autotune_robust_journal_resumes_in_process(tmp_path, capsys):
    from repro_torch.launch import autotune
    args = ["--cnn", "tiny", "--algo", "rl", "--robust", "--journal",
            str(tmp_path / "j.json"), "--checkpoint-k", "0,1"]
    assert autotune.main(args + ["--out", str(tmp_path / "a.json")]) == 0
    assert autotune.main(args + ["--out", str(tmp_path / "b.json")]) == 0
    a = json.loads((tmp_path / "a.json").read_text())
    b = json.loads((tmp_path / "b.json").read_text())
    assert a["best"] == b["best"] and a["best"] is not None
    assert b["robust"]["stats"]["evaluated"] == 0
    assert b["robust"]["stats"]["journal_hits"] > 0
    with pytest.raises(SystemExit):
        autotune.main(["--arch", "qwen2-1.5b", "--cnn", "tiny"])
    with pytest.raises(SystemExit):
        autotune.main(["--algo", "bf"])

"""The port's static verifier against the JAX package's.

Rules QV101-QV402 are host analysis copied line for line, so each of the
JAX package's tripping inputs (``tests/test_verify.py``) must give the
port the same diagnostics — rule ids, severities, stages, tensors and
details, exactly.  Specs are calibrated once (the two packages calibrate
the same specs, ``tests/test_torch_e2e.py``) and handed to both.  The
QV5xx probes have no JAX counterpart to compare with on this jax (the
reference's probe traces Pallas kernels that no longer build): they are
held to what they must find in fused and unfused programs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import parser as RP
from repro.core import pipeline as r_pipe
from repro.core import verify as RV
from repro.core.quantize import QuantSpec as RSpec
from repro.core.resources import FPGA_BOARDS as R_BOARDS
from repro.core.spaces import CNNDesignSpace as RSpace
from repro.models import cnn as r_cnn
from repro_torch.core import dse as t_dse
from repro_torch.core import parser as TP
from repro_torch.core import pipeline as t_pipe
from repro_torch.core import verify as TV
from repro_torch.core.quantize import QuantSpec as TSpec
from repro_torch.core.resources import FPGA_BOARDS as T_BOARDS
from repro_torch.core.resources import eligible_checkpoints
from repro_torch.core.synthesis import CNN2Gate as TGate
from repro_torch.kernels import ops
from repro_torch.models import cnn as t_cnn

ZOO = ["tiny_cnn", "tiny_cnn_gap", "resnet_tiny", "mobilenet_tiny",
       "googlenet_tiny", "squeezenet_tiny"]


def _diags(diags):
    return [(d.rule_id, d.severity, d.stage, d.tensor, d.detail)
            for d in diags]


def _r_specs(specs):
    return {k: RSpec(s.m_w, s.m_x, s.m_y) for k, s in specs.items()}


def _pair(build, fused=True, **parse_kw):
    """(JAX package parse, port parse) of ``build(module)`` from each
    package's own builders."""
    kw = dict(fuse_skip=fused, fuse_concat=fused, **parse_kw)
    return RP.parse(build(r_cnn), **kw), TP.parse(build(t_cnn), **kw)


def _calibrated(name, per_channel=False, fused=True, seed=0):
    """A port gate of zoo model ``name`` calibrated on a seeded input,
    and the JAX package's parse of the same graph."""
    gate = TGate.from_graph(getattr(t_cnn, name)(batch=1), fuse_skip=fused,
                            fuse_concat=fused, device="cpu")
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(gate.parsed.input_shape) * 0.5
         ).astype(np.float32)
    gate.calibrate_quantization(x, per_channel=per_channel)
    rp = RP.parse(getattr(r_cnn, name)(batch=1), fuse_skip=fused,
                  fuse_concat=fused)
    return gate, rp


def _same_program(rp, tp, r_specs, t_specs, **kw):
    want = RV.verify_program(rp, r_specs, **kw)
    got = TV.verify_program(tp, t_specs, **kw)
    assert _diags(got.diagnostics) == _diags(want.diagnostics)
    return got


# ------------------------------------------------------- report API

def test_report_api_and_rule_catalog():
    assert TV.RULES == RV.RULES
    d_err = TV.Diagnostic("QV101", TV.ERROR, stage="c1", tensor="t",
                          detail="boom")
    d_warn = TV.Diagnostic("QV206", TV.WARNING, stage="x")
    rep = TV.VerificationReport([d_err, d_warn])
    assert not rep.ok
    assert rep.errors == [d_err] and rep.warnings == [d_warn]
    assert rep.by_rule("QV101") == [d_err]
    assert rep.rule_ids == ("QV101", "QV206")
    assert str(d_err) == str(RV.Diagnostic("QV101", RV.ERROR, stage="c1",
                                           tensor="t", detail="boom"))
    with pytest.raises(TV.VerificationError) as ei:
        rep.raise_if_errors()
    assert ei.value.diagnostics == (d_err,)
    assert isinstance(ei.value, ValueError)
    assert TV.VerificationReport([d_warn]).raise_if_errors().ok
    assert TV.VerificationReport([]).render() == \
        RV.VerificationReport([]).render()


# ------------------------------------------ the tripping inputs, rule by rule

def _overflow(mod, cout=8):
    b = mod.GraphBuilder("overflow", (1, 16384, 4, 4))
    b.conv(cout, 3, pad=1, relu=False)
    b.inits["conv_1_w"][:] = 0.9          # every tap quantizes hot
    return b.build()


def test_qv101_accumulator_overflow():
    rp, tp = _pair(_overflow)
    name = next(li.name for li in tp.layers if li.kind == TP.CONV)
    for m_w in (7, 0):
        got = _same_program(rp, tp, {name: RSpec(m_w, 0, m_w)},
                            {name: TSpec(m_w, 0, m_w)})
        assert got.rule_ids == (("QV101",) if m_w else ())
    # the per-lane analysis localizes the hot lane
    rp, tp = _pair(lambda mod: _overflow(mod, cout=4))
    got = _same_program(rp, tp, {name: RSpec((0, 0, 7, 0), 0, 0)},
                        {name: TSpec((0, 0, 7, 0), 0, 0)})
    assert "lane 2" in " ".join(d.detail for d in got.by_rule("QV101"))


def _mutated(gate, rule):
    """The JAX package's tripping spec sets of ``tests/test_verify.py``,
    applied to a calibrated resnet_tiny."""
    specs = dict(gate.specs)
    pm = gate.parsed
    conv = next(li for li in pm.layers if li.kind == TP.CONV)
    s = specs[conv.name]
    if rule == "QV201":
        specs[conv.name] = dataclasses.replace(s, m_y=s.m_w + s.m_x + 3)
    elif rule == "QV102":
        specs[conv.name] = TSpec(m_w=40, m_x=0, m_y=0)
    elif rule == "QV202":
        host = next(li for li in pm.layers if li.merge is not None)
        specs = {li.name: TSpec(m_w=7, m_x=6, m_y=6)
                 for li in pm.layers if li.kind in (TP.CONV, TP.FC)}
        specs[host.merge.name] = TSpec(m_w=0, m_x=8, m_y=8)
    elif rule == "QV205":
        del specs[conv.name]
    elif rule == "QV206":
        specs[conv.name] = dataclasses.replace(s, m_w=(4, 4, 4))
    return specs


@pytest.mark.parametrize("rule", ["QV201", "QV102", "QV202", "QV205",
                                  "QV206"])
def test_spec_rules_trip_as_the_reference(rule):
    gate, rp = _calibrated("resnet_tiny")
    specs = _mutated(gate, rule)
    got = _same_program(rp, gate.parsed, _r_specs(specs), specs,
                        check_identity=False)
    assert rule in got.rule_ids
    if rule == "QV205":
        dropped = next(li.name for li in gate.parsed.layers
                       if li.kind == TP.CONV)
        assert any(d.stage == dropped for d in got.by_rule("QV205"))


def test_qv203_threading_conflict():
    def fork(mod):
        b = mod.GraphBuilder("fork", (1, 4, 8, 8))
        b.conv(4, 3, pad=1)
        t = b.tap()
        b.conv(4, 3, pad=1)
        a = b.tap()
        b.from_tap(t).conv(4, 3, pad=1)
        b.add_from(a, relu=False)
        return b.build()
    rp, tp = _pair(fork, fused=False)
    c0, ca, cb = (li.name for li in tp.layers if li.kind == TP.CONV)
    m = next(li.name for li in tp.layers if li.kind == TP.ADD)
    spec = {c0: (4, 4, 4), ca: (4, 4, 4), cb: (4, 5, 4), m: (0, 4, 4)}
    want_m, want = RV.thread_scales_checked(
        rp, {k: RSpec(*v) for k, v in spec.items()})
    got_m, got = TV.thread_scales_checked(
        tp, {k: TSpec(*v) for k, v in spec.items()})
    assert got_m == want_m and _diags(got) == _diags(want)
    assert "QV203" in {d.rule_id for d in got}


def test_qv206_strict_per_tensor_conflict():
    gate, rp = _calibrated("resnet_tiny", per_channel=True)
    got = _same_program(rp, gate.parsed, _r_specs(gate.specs), gate.specs,
                        per_channel=False, check_identity=False)
    assert "QV206" in got.rule_ids


def _with_offset(parsed, delta):
    layers = list(parsed.layers)
    i, li = next((i, li) for i, li in enumerate(layers)
                 if li.concat is not None and li.concat_offset > 0)
    layers[i] = dataclasses.replace(li,
                                    concat_offset=li.concat_offset + delta)
    return dataclasses.replace(parsed, layers=layers)


def test_qv301_concat_partition():
    rp, tp = _pair(lambda mod: mod.squeezenet_tiny(batch=1))
    for delta in (-1, +1, 0):
        want = RV.check_concat_partition(_with_offset(rp, delta))
        got = TV.check_concat_partition(_with_offset(tp, delta))
        assert _diags(got) == _diags(want)
        assert {d.rule_id for d in got} == ({"QV301"} if delta else set())
    assert any("overlap" in d.detail for d in
               TV.check_concat_partition(_with_offset(tp, -1)))


def _late_reader(pm):
    """A stage spliced after the final one that re-reads the first
    conv's long-released output."""
    layers = list(pm.layers)
    first_conv = next(li for li in layers if li.kind == "conv")
    final = layers[-1]
    layers[-1] = dataclasses.replace(final, output=final.output + "_t")
    tail = dataclasses.replace(
        final, name="late", inputs=(layers[-1].output, first_conv.output),
        output=pm.output_name)
    return dataclasses.replace(pm, layers=layers + [tail])


def _undefined_input(pm):
    layers = list(pm.layers)
    li = next(li for li in layers if li.kind == "conv")
    layers[layers.index(li)] = dataclasses.replace(li, inputs=("never_made",))
    return dataclasses.replace(pm, layers=layers)


def _slice_escape(pm):
    layers = list(pm.layers)
    prod = next(li for li in layers if li.concat is not None)
    cc_i = next(i for i, li in enumerate(layers)
                if li.name == prod.concat.name)
    after = layers[cc_i + 1]
    layers[cc_i + 1] = dataclasses.replace(
        after, inputs=tuple(after.inputs) + (prod.output,))
    return dataclasses.replace(pm, layers=layers)


@pytest.mark.parametrize("case,model,rule", [
    ("use_after_release", "resnet_tiny", "QV302"),
    ("use_before_def", "resnet_tiny", "QV302"),
    ("slice_escape", "squeezenet_tiny", "QV303")])
def test_liveness_rules(case, model, rule):
    rp, tp = _pair(lambda mod: getattr(mod, model)(batch=1))
    if case == "use_after_release":
        want = RV.check_liveness(_late_reader(rp),
                                 release_at=RV.release_schedule(rp))
        got = TV.check_liveness(_late_reader(tp),
                                release_at=TV.release_schedule(tp))
        assert TV.release_schedule(tp) == RV.release_schedule(rp)
        assert TV.check_liveness(_late_reader(tp)) == []
    else:
        mutate = _undefined_input if case == "use_before_def" \
            else _slice_escape
        want = RV.check_liveness(mutate(rp))
        got = TV.check_liveness(mutate(tp))
    assert _diags(got) == _diags(want)
    assert rule in {d.rule_id for d in got}


def test_qv304_checkpoint_boundaries():
    rp, tp = _pair(lambda mod: mod.squeezenet_tiny(batch=1))
    blocked = sorted(set(range(len(tp.layers) - 1))
                     - set(eligible_checkpoints(tp)))
    assert blocked
    for bounds in ([blocked[0]], [99], list(eligible_checkpoints(tp)),
                   [-1, blocked[-1], 3]):
        want = RV.check_checkpoint_boundaries(rp, bounds)
        got = TV.check_checkpoint_boundaries(tp, bounds)
        assert _diags(got) == _diags(want)
    assert "fused-concat" in TV.check_checkpoint_boundaries(
        tp, [blocked[0]])[0].detail


def test_qv401_qv402_budgets():
    rp, tp = _pair(lambda mod: mod.resnet_tiny(batch=1))
    ck = eligible_checkpoints(tp)[:2]
    for kw in (dict(vmem_budget=None), dict(vmem_budget=1024),
               dict(vmem_budget=10 ** 5, checkpoints=ck),
               dict(vmem_budget=10 ** 9, checkpoints=ck),
               dict(n_i=4, n_l=8, block_h=4, vmem_budget=20000,
                    per_channel=True)):
        want = RV.check_resources(rp, **kw)
        got = TV.check_resources(tp, **kw)
        assert _diags(got) == _diags(want)
    rules = {d.rule_id for d in TV.check_resources(
        tp, vmem_budget=10 ** 5, checkpoints=ck)}
    assert "QV402" in rules
    assert "QV401" in {d.rule_id for d in TV.check_resources(
        tp, vmem_budget=1024)}


# ------------------------------------------- clean programs, whole catalog

@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_verifies_clean_as_the_reference(name, fused, per_channel):
    gate, rp = _calibrated(name, per_channel, fused)
    rep = gate.verify()
    assert rep.ok and not rep.diagnostics, rep.render()
    r_specs = _r_specs(gate.specs)
    _same_program(rp, gate.parsed, r_specs, gate.specs)
    # budgets armed: the same diagnostics where there are some
    ck = eligible_checkpoints(gate.parsed)[:2]
    _same_program(rp, gate.parsed, r_specs, gate.specs, n_i=4, n_l=8,
                  block_h=4, vmem_budget=4096, checkpoints=ck)
    # the staged weights give the overflow pass what re-quantizing does
    staged = TV.verify_quantized(gate.quantized, vmem_budget=4096)
    assert _diags(staged.diagnostics) == _diags(RV.verify_program(
        rp, r_specs, per_channel=None, vmem_budget=4096).diagnostics)


# ----------------------------------- build_quantized raises where it must

def _raised(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    assert isinstance(ei.value, (RV.VerificationError, TV.VerificationError))
    return _diags(ei.value.diagnostics)


@pytest.mark.parametrize("rule", ["QV101", "QV201", "QV202", "QV202u",
                                  "QV206"])
def test_build_quantized_raises_where_the_reference_raises(rule):
    kw = {}
    if rule == "QV101":
        rp, tp = _pair(_overflow)
        name = next(li.name for li in tp.layers if li.kind == TP.CONV)
        specs = {name: TSpec(7, 0, 7)}
    elif rule == "QV206":
        gate, rp = _calibrated("resnet_tiny", per_channel=True)
        tp, specs, kw = gate.parsed, gate.specs, dict(per_channel=False)
    else:
        gate, rp = _calibrated("resnet_tiny", fused=rule != "QV202u")
        tp = gate.parsed
        if rule == "QV201":
            specs = _mutated(gate, "QV201")
        else:   # a merge's common position above an operand's
            add = next((li.merge if li.merge is not None else li)
                       for li in tp.layers
                       if li.merge is not None or li.kind == TP.ADD)
            specs = dict(gate.specs)
            specs[add.name] = TSpec(0, specs[add.name].m_x + 3,
                                    specs[add.name].m_y)
    want = _raised(lambda: r_pipe.build_quantized(rp, _r_specs(specs), **kw))
    got = _raised(lambda: t_pipe.build_quantized(tp, specs, device="cpu",
                                                 **kw))
    assert got == want
    assert rule[:5] in {d[0] for d in got}


def test_verification_does_not_change_the_program():
    gate, _rp = _calibrated("resnet_tiny")
    qm_v = t_pipe.build_quantized(gate.parsed, gate.specs, verify=True,
                                  device="cpu")
    qm_n = t_pipe.build_quantized(gate.parsed, gate.specs, verify=False,
                                  device="cpu")
    for a, b in zip(qm_v.layers, qm_n.layers):
        for t in ("w_q", "b_q", "w_k", "shift_vec"):
            x, y = getattr(a, t), getattr(b, t)
            assert (x is None and y is None) or torch.equal(x, y)
    assert TV.executor_trace(qm_v) == TV.executor_trace(qm_n)


# -------------------------------------------------- DSE integration

def test_design_space_charges_verifier_rejects_like_infeasible():
    gate, rp = _calibrated("resnet_tiny")
    bad = _mutated(gate, "QV201")
    space = gate.design_space("ARRIA10")
    assert space.verifier_errors == ()
    t_space = type(space)(gate.parsed, T_BOARDS["ARRIA10"], specs=bad)
    r_space = RSpace(rp, R_BOARDS["ARRIA10"], specs=_r_specs(bad))
    assert t_space.verifier_errors == r_space.verifier_errors
    assert "QV201" in t_space.verifier_errors
    rep = t_space.evaluate(t_space.options()[0])
    assert not rep.fits and rep.percents["mem"] == t_dse.FAILED_PCT
    assert rep.raw["verifier"] == list(t_space.verifier_errors)
    assert space.evaluate(space.options()[0]).percents["mem"] < 100.0


def test_robust_evaluator_does_not_retry_verifier_rejects():
    class _Space(t_dse.DesignSpace):
        def __init__(self):
            self.calls = 0

        def options(self):
            return [(1, 1)]

        def axes(self):
            return [[1], [1]]

        def evaluate(self, option):
            self.calls += 1
            raise TV.VerificationError(
                [TV.Diagnostic("QV201", TV.ERROR, stage="c1")])

    space = _Space()
    ev = t_dse.RobustEvaluator(space, retries=3, backoff_s=0.0)
    assert not ev.evaluate((1, 1)).fits
    assert space.calls == 1
    assert ev.stats["verifier_rejects"] == 1
    assert "QV201" in next(iter(ev.quarantined.values()))


# ------------------------------------------------ QV501/QV502 probes

@pytest.mark.parametrize("name,kind", [("resnet_tiny", "add"),
                                       ("googlenet_tiny", "concat"),
                                       ("squeezenet_tiny", "concat")])
def test_probes_find_standalone_merges_only_when_unfused(name, kind):
    count = TV.int_add_calls if kind == "add" else TV.concat_calls
    fused, _ = _calibrated(name)
    trace = TV.executor_trace(fused.quantized)
    assert count(trace) == 0
    assert TV.structural_probes(fused.quantized) == []
    # the fused program really has fused merges for the probe to check
    assert any((li.merge is not None) if kind == "add" else li.concat_fused
               for li in fused.parsed.layers)
    unfused, _ = _calibrated(name, fused=False)
    trace = TV.executor_trace(unfused.quantized, batch=2)
    stages = sum(li.kind == kind for li in unfused.parsed.layers)
    assert count(trace) == stages > 0
    assert TV.structural_probes(unfused.quantized) == []


def test_probes_trip_when_a_merge_escapes_the_kernel(monkeypatch):
    """A conv op that leaves its merge to a standalone op (simulated by
    wrapping the entry point) is what QV501/QV502 exist to catch."""
    real = ops.qconv2d_nhwc

    def leaky(x, w, b, **kw):
        y = real(x, w, b, **kw)
        if kw.get("skip") is not None:
            ops.qadd_nhwc([kw["skip"], kw["skip"]], (0, 0))
        if kw.get("out_buf") is not None:
            ops.qconcat_nhwc([y, y], (0, 0))
        return y
    monkeypatch.setattr(ops, "qconv2d_nhwc", leaky)
    for name, rule in (("resnet_tiny", "QV501"), ("googlenet_tiny", "QV502")):
        gate, _ = _calibrated(name)
        diags = TV.structural_probes(gate.quantized)
        assert [d.rule_id for d in diags] == [rule]


@pytest.mark.parametrize("name", ["resnet_tiny", "mobilenet_tiny",
                                  "googlenet_tiny"])
def test_per_channel_calls_take_one_more_operand(name):
    pt, _ = _calibrated(name)
    pc, _ = _calibrated(name, per_channel=True)
    a_t = TV.kernel_call_arities(TV.executor_trace(pt.quantized))
    a_c = TV.kernel_call_arities(TV.executor_trace(pc.quantized))
    n_weighted = sum(li.kind in ("conv", "fc") for li in pt.parsed.layers)
    assert len(a_t) == len(a_c) == n_weighted
    assert a_c == [n + 1 for n in a_t]


def test_recording_is_scoped():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    with ops.recording() as outer:
        ops.maxpool2d_nhwc(x, 2, 2)
        with ops.recording() as inner:
            ops.avgpool2d_nhwc(x, 2, 2)
    ops.maxpool2d_nhwc(x, 2, 2)
    assert outer == [("maxpool2d_nhwc", 1), ("avgpool2d_nhwc", 1)]
    assert inner == [("avgpool2d_nhwc", 1)]
    assert ops._RECORDERS == []


# --------------------------------------------------------------- the CLI

def test_verify_cli(capsys):
    from repro_torch.launch import verify as cli
    assert cli.main(["--models", "resnet_tiny,googlenet_tiny",
                     "--per-channel", "both", "--fused", "both",
                     "--probes", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "8 combination(s), 0 error(s)" in out
    assert cli.main(["--models", "resnet_tiny", "--device", "cpu",
                     "--vmem-budget", "1024", "--per-channel", "off",
                     "--fused", "on"]) == 1
    assert "QV401" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--models", "nope", "--device", "cpu"])
    assert cli.main(["--list-rules"]) == 0
    assert "QV502" in capsys.readouterr().out


def test_verify_cli_takes_the_reference_flags(capsys, monkeypatch):
    """The JAX package's command line (``--jaxpr-probes``, its spelling of
    the probe flag) runs through the port's ``main``: the same probes as
    ``--probes``, the same report."""
    from repro_torch.launch import verify as cli
    ran = []
    probes = TV.structural_probes

    def spy(*a, **kw):
        ran.append(a[0].name)
        return probes(*a, **kw)
    monkeypatch.setattr(TV, "structural_probes", spy)
    ref_flags = ["--models", "resnet_tiny,googlenet_tiny", "--per-channel",
                 "off", "--fused", "on", "--n-i", "16", "--n-l", "32",
                 "--seed", "0", "--jaxpr-probes"]
    assert cli.main(ref_flags + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert len(ran) == 2
    assert cli.main([f for f in ref_flags if f != "--jaxpr-probes"]
                    + ["--probes", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == out and len(ran) == 4

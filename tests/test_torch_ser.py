"""The port's SER campaigns (``repro_torch.core.ser``) against the JAX
package's.

The reference vmaps a campaign's trials through one jitted closure; the
port runs them one after another through one executor.  On the same
unfused model, input and seed (the reference through the shim of
``tests/torch_reference_shim.py``) every ``TrialRecord`` — plan, touched
and flagged stages, outcome, recovery, escalation and stages replayed —
must be equal, and so must the ``summary()`` JSON (counts, Wilson
intervals, per-stage rates) and the derived guard policy.  The rest
holds the port to the JAX package's own campaign tests
(``tests/test_ser.py``) on a fused program.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import faults as RF
from repro.core import ser as r_ser
from repro_torch.core import faults as TF
from repro_torch.core import pipeline as t_pipe
from repro_torch.core import ser
from repro_torch.core.synthesis import CNN2Gate
from repro_torch.models import cnn
from torch_reference_shim import calibrated_pair
from torch_reference_shim import shimmed_reference  # noqa: F401


def _record(r):
    return (dataclasses.astuple(r.plan), r.stages, r.flagged, r.outcome,
            r.output_differs, r.recovered, r.escalated, r.replayed)


@pytest.mark.parametrize("name,trials,ckpts", [("resnet_tiny", 24, 2),
                                               ("googlenet_tiny", 16, 2),
                                               ("mobilenet_tiny", 16, 1)])
def test_campaign_matches_the_reference(shimmed_reference, name, trials,
                                        ckpts):
    rg, tg, x = calibrated_pair(name, seed=0)
    kinds = (RF.WEIGHT_BIT, RF.DROPPED_TILE, RF.ACTIVATION_BIT)
    kw = dict(trials=trials, kinds=kinds, seed=3, checkpoints=ckpts,
              chunk=8)
    want = r_ser.run_campaign(rg, x, **kw)
    got = ser.run_campaign(tg, x, **kw)
    assert [_record(r) for r in got.records] == \
        [_record(r) for r in want.records]
    assert json.dumps(got.summary(), sort_keys=True) == \
        json.dumps(want.summary(), sort_keys=True)
    assert (got.boundaries, got.boundary_names) == \
        (want.boundaries, want.boundary_names)
    counts = got.counts()
    assert counts["detected"] and counts["recovered_by_replay"]
    assert counts["silent"] == 0
    assert dataclasses.asdict(ser.derive_guard_policy([got], tg.parsed)) \
        == dataclasses.asdict(r_ser.derive_guard_policy([want], rg.parsed))
    assert ser.CAMPAIGN_KINDS == (TF.WEIGHT_BIT, TF.DROPPED_TILE,
                                  TF.ACTIVATION_BIT)


def test_two_flip_campaign_matches_the_reference(shimmed_reference):
    """Two flips a trial: each plan carries two faults, and an activation
    payload two (index, mask) slots.  Records and summary equal the
    reference's.  (The port XOR-combines repeated indices where the
    reference's scatter keeps the last; the two differ only on a no-op
    slot after a fault on element 0, ROADMAP Queue 3.)"""
    rg, tg, x = calibrated_pair("resnet_tiny", seed=0)
    kw = dict(trials=24, flips=2, kinds=(RF.WEIGHT_BIT, RF.DROPPED_TILE,
                                         RF.ACTIVATION_BIT),
              seed=3, checkpoints=2, chunk=8)
    want = r_ser.run_campaign(rg, x, **kw)
    got = ser.run_campaign(tg, x, **kw)
    assert [_record(r) for r in got.records] == \
        [_record(r) for r in want.records]
    assert all(len(r.plan.faults) == 2 for r in got.records)
    assert json.dumps(got.summary(), sort_keys=True) == \
        json.dumps(want.summary(), sort_keys=True)
    assert got.counts()["detected"]


@pytest.mark.parametrize("k,n", [(0, 0), (5, 10), (10, 10), (0, 100),
                                 (50, 100), (3, 64), (63, 64), (1, 1)])
def test_wilson_matches_the_reference(k, n):
    assert ser.wilson(k, n) == r_ser.wilson(k, n)
    assert ser.wilson(k, n, z=2.576) == r_ser.wilson(k, n, z=2.576)


# -------------------------------------------- held to tests/test_ser.py

@pytest.fixture(scope="module")
def gate():
    g = CNN2Gate.from_graph(cnn.resnet_tiny(batch=1), device="cpu")
    x = (np.random.default_rng(7).standard_normal((1, 3, 32, 32))
         * 0.5).astype(np.float32)
    g.calibrate_quantization(x)
    return g, x


@pytest.fixture(scope="module")
def campaign(gate):
    g, x = gate
    return ser.run_campaign(
        g, x, trials=16, flips=1,
        kinds=(TF.WEIGHT_BIT, TF.ACTIVATION_BIT, TF.DROPPED_TILE),
        seed=3, checkpoints=2, chunk=8)


def test_wilson_interval():
    assert ser.wilson(0, 0) == (0.0, 1.0)
    lo, hi = ser.wilson(5, 10)
    assert lo < 0.5 < hi
    lo, hi = ser.wilson(10, 10)
    assert lo > 0.69 and hi == 1.0
    lo, hi = ser.wilson(0, 100)
    assert lo == 0.0 and hi < 0.05
    assert np.diff(ser.wilson(50, 100)) < np.diff(ser.wilson(5, 10))


def test_weight_and_fault_args_noop_is_golden(gate):
    """Golden weights and an all-zero XOR payload through the campaign's
    argument-passing executor give the plain build's output; the same
    executor serves trial after trial."""
    g, x = gate
    y0 = g.build("emulation")(x)
    wnames = tuple(ql.info.name for ql in g.quantized.layers
                   if ql.w_q is not None)[:2]
    t0 = g.quantized.layers[0].info.output
    ex = t_pipe.make_executor(g.quantized, weight_args=wnames,
                              fault_args=(t0,))
    W = {n: next(ql.w_q for ql in g.quantized.layers
                 if ql.info.name == n) for n in wnames}
    for _ in range(3):
        nop = {t0: (np.zeros(2, np.int32), np.zeros(2, np.int8))}
        assert torch.equal(ex(x, W, nop), y0)
    W_np = {n: w.numpy() for n, w in W.items()}
    assert torch.equal(ex(x, W_np, nop), y0)


def test_campaign_outcomes_partition_trials(campaign):
    c = campaign
    counts = c.counts()
    assert counts["detected"] + counts["masked"] + counts["silent"] \
        == c.trials == 16
    assert counts["silent"] == 0
    for r in c.records:
        assert r.outcome in ("detected", "masked", "silent")
        if r.outcome == "detected":
            assert r.recovered and 0 < r.replayed <= c.n_stages
            if not r.escalated:
                assert r.replayed < c.n_stages
        else:
            assert not r.recovered and r.replayed == 0


def test_campaign_summary_is_json_with_cis(campaign):
    doc = json.loads(json.dumps(campaign.summary()))
    assert doc["version"] == ser.SCHEMA_VERSION and doc["trials"] == 16
    for key in ("detected", "masked", "silent", "recovered"):
        r = doc["rates"][key]
        assert 0.0 <= r["lo"] <= r["p"] <= r["hi"] <= 1.0
    for st in doc["per_stage"].values():
        assert st["trials"] >= 1 and st["avf"]["hi"] <= 1.0


def test_campaign_rejects_unvectorizable_kinds(gate):
    g, x = gate
    with pytest.raises(ValueError, match="vectorized"):
        ser.run_campaign(g, x, trials=2, kinds=(TF.SCALE,))


def test_derived_policy_covers_every_reached_trial(gate, campaign):
    g, _ = gate
    pol = ser.derive_guard_policy([campaign], g.parsed)
    sel = set(pol.audit_stages)
    assert g.parsed.layers[-1].name in sel
    assert len(sel) < len(g.parsed.layers)
    for r in campaign.records:
        if r.output_differs:
            assert set(r.flagged) & sel


def test_selective_policy_still_detects_and_recovers(gate, campaign):
    g, x = gate
    pol = ser.derive_guard_policy([campaign], g.parsed)
    rec = next(r for r in campaign.records
               if r.outcome == "detected" and r.plan.program_faults
               and set(r.flagged) & set(pol.audit_stages))
    y, report = g.build_guarded(x_cal=x, policy=pol,
                                qm=TF.inject(g.quantized, rec.plan),
                                checkpoints=2)(x)
    assert report.detected and report.ok
    assert torch.equal(y, g.build("emulation")(x))


def test_derive_policy_refuses_silent_evidence(gate, campaign):
    g, _ = gate
    bad = ser.Campaign(
        model=campaign.model, flips=1, kinds=campaign.kinds, seed=0,
        boundaries=campaign.boundaries,
        boundary_names=campaign.boundary_names,
        n_stages=campaign.n_stages,
        records=[ser.TrialRecord(plan=TF.FaultPlan(()), stages=("conv_1",),
                                 flagged=(), outcome="silent",
                                 output_differs=True)])
    with pytest.raises(ValueError, match="silent"):
        ser.derive_guard_policy([bad], g.parsed)


def test_cli_asserts_no_silent_trial(tmp_path, capsys):
    out = tmp_path / "ser.json"
    doc = ser.main(["--model", "tiny_cnn", "--trials", "12", "--device",
                    "cpu", "--out", str(out), "--derive-policy",
                    "--assert-silent", "--kinds",
                    "weight_bit,activation_bit"])
    text = capsys.readouterr().out
    assert "silent == 0" in text and json.loads(out.read_text()) == \
        json.loads(json.dumps(doc))
    assert doc["derived_policy"]["n_audited"] >= 1

"""The port's guarded execution (``repro_torch.core.guard``), audits,
checkpoints and replays against the JAX package's.

Against the reference (through the shim of
``tests/torch_reference_shim.py``, unfused programs in both packages):
the audit statistics, every checkpoint snapshot, the replay from every
eligible boundary and whole ``GuardReport``s (outcome, flagged stages,
audit rows, ladder actions with ``replayed`` and ``boundary``) must be
equal; logits within ``atol=1e-6, rtol=0``, the softmax tolerance of
``tests/test_torch_e2e.py``.  The rest holds the port to the JAX
package's own guard and checkpoint tests (``tests/test_guard.py``,
``tests/test_checkpoint_recovery.py``) on fused programs, which the
shim's oracle cannot run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as RF
from repro.core import pipeline as r_pipe
from repro.core import resources as RR
from repro.core.guard import GuardPolicy as RPolicy
from repro_torch.core import faults as TF
from repro_torch.core import pipeline as t_pipe
from repro_torch.core import resources as TR
from repro_torch.core import telemetry as tele
from repro_torch.core import verify as TV
from repro_torch.core.guard import GuardPolicy
from repro_torch.core.synthesis import CNN2Gate
from repro_torch.kernels import ops
from repro_torch.models import cnn
from torch_reference_shim import calibrated_pair
from torch_reference_shim import shimmed_reference  # noqa: F401

NETS = ["resnet_tiny", "googlenet_tiny", "mobilenet_tiny"]
STRICT = GuardPolicy(margin=0.0, sat_tol=0.0)
_PAIRS = {}


def _pair(name, per_channel=False):
    key = (name, per_channel)
    if key not in _PAIRS:
        _PAIRS[key] = calibrated_pair(name, per_channel=per_channel,
                                      seed=29)
    return _PAIRS[key]


def _report(rep):
    return (rep.outcome, rep.flagged, rep.recovered_by, rep.degraded,
            rep.ok,
            [(a.stage, a.tensor, a.sat, a.max_abs, a.mean_abs, a.flagged,
              a.reasons) for a in rep.audits],
            [(a.action, a.flagged, a.replayed, a.boundary)
             for a in rep.actions])


def _weighted(qm):
    return [ql.info.name for ql in qm.layers if ql.w_q is not None]


def _scenario(kind, tg):
    """(fault plan builder, policy kwargs, checkpoints) of one ladder
    scenario; the builder takes a package's faults module."""
    names = _weighted(tg.quantized)
    if kind == "late_weight":
        return (lambda F: F.FaultPlan((F.Fault(F.WEIGHT_BIT, names[-2],
                                               index=1, bit=7),)), {}, 2)
    if kind == "early_weight":
        return (lambda F: F.FaultPlan((F.Fault(F.WEIGHT_BIT, names[0],
                                               index=0, bit=6),)), {}, 2)
    if kind == "activation":
        return (lambda F: F.FaultPlan.sample(tg.quantized, 4,
                                             kinds=(F.ACTIVATION_BIT,),
                                             seed=9, bits=(6, 7)), {}, 2)
    # per-channel shift lane with the unfused rung off: per-tensor serves
    return (lambda F: F.FaultPlan((F.Fault(F.SHIFT_LANE, names[1], lane=1,
                                           delta=2),)),
            dict(fallback_unfused=False), None)


@pytest.mark.parametrize("kind", ["late_weight", "early_weight",
                                  "activation", "shift_lane"])
@pytest.mark.parametrize("name", NETS)
def test_guard_report_matches_the_reference(shimmed_reference, name,
                                            kind):
    rg, tg, x = _pair(name, per_channel=kind == "shift_lane")
    plan_of, pol_kw, ckpt = _scenario(kind, tg)
    reports = []
    for gate, F, pol, xin in ((rg, RF, RPolicy, jnp.asarray(x)),
                              (tg, TF, GuardPolicy, x)):
        plan = plan_of(F)
        gx = gate.build_guarded(
            x_cal=x, policy=pol(margin=0.0, sat_tol=0.0, **pol_kw),
            qm=F.inject(gate.quantized, plan),
            faults=plan.activation_faults() or None, checkpoints=ckpt)
        y, rep = gx(xin)
        reports.append((np.asarray(y), _report(rep)))
    (ry, r_rep), (ty, t_rep) = reports
    assert t_rep == r_rep
    np.testing.assert_allclose(ty, ry, rtol=0, atol=1e-6)
    assert t_rep[0] != "clean"
    if kind == "shift_lane":
        assert t_rep[2] == "per_tensor"
    if kind == "early_weight":
        assert [a[0] for a in t_rep[6]][-1] == "fallback:unfused"


@pytest.mark.parametrize("name", NETS)
def test_audit_snapshots_and_replays_match_the_reference(shimmed_reference,
                                                         name):
    rg, tg, x = _pair(name)
    elig = RR.eligible_checkpoints(rg.parsed)
    assert elig == TR.eligible_checkpoints(tg.parsed)
    ry, rst, rck = r_pipe.make_executor(rg.quantized, interpret=True,
                                        audit=True, checkpoints=elig)(
        jnp.asarray(x))
    ty, tst, tck = t_pipe.make_executor(tg.quantized, audit=True,
                                        checkpoints=elig)(x)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=0,
                               atol=1e-6)
    host = t_pipe.stats_to_host(tst)
    assert set(host) == set(rst)
    for t in rst:
        np.testing.assert_array_equal(host[t], np.asarray(rst[t]))
    names = [ql.info.name for ql in tg.quantized.layers]
    for b in elig:
        snap_r, snap_t = rck[names[b]], tck[names[b]]
        assert set(snap_r) == set(snap_t)
        for t in snap_r:
            np.testing.assert_array_equal(snap_t[t].numpy(),
                                          np.asarray(snap_r[t]))
        yr, sr = r_pipe.make_executor(rg.quantized, interpret=True,
                                      audit=True, replay_from=b)(snap_r)
        yt, st = t_pipe.make_executor(tg.quantized, audit=True,
                                      replay_from=b)(snap_t)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yr), rtol=0,
                                   atol=1e-6)
        assert torch.equal(yt, ty)
        st = t_pipe.stats_to_host(st)
        assert set(st) == set(sr)
        for t in sr:
            np.testing.assert_array_equal(st[t], np.asarray(sr[t]))
    sel = sorted(host)[::2]
    _, rsel = r_pipe.make_executor(rg.quantized, interpret=True,
                                   audit=sel)(jnp.asarray(x))
    _, tsel = t_pipe.make_executor(tg.quantized, audit=sel)(x)
    assert set(tsel) == set(rsel) == set(sel)


# -------------------------------------------- held to tests/test_guard.py

RNG = np.random.default_rng(29)


@pytest.fixture(scope="module")
def gate():
    g = CNN2Gate.from_graph(cnn.resnet_tiny(batch=1), device="cpu")
    x = (RNG.standard_normal((1, 3, 32, 32)) * 0.5).astype(np.float32)
    g.calibrate_quantization(x)
    return g, x


@pytest.fixture(scope="module")
def goog():
    g = CNN2Gate.from_graph(cnn.googlenet_tiny(batch=1), device="cpu")
    x = (RNG.standard_normal(g.parsed.input_shape) * 0.5).astype(np.float32)
    g.calibrate_quantization(x)
    return g, x


def test_guards_off_makes_the_ops_calls_of_build(gate):
    g, x = gate
    plain, off = g.build("emulation"), g.build_guarded(policy=None)
    calls = []
    for ex in (plain, off):
        with ops.recording() as c:
            y = ex(x)
        calls.append((c, y))
    assert calls[0][0] == calls[1][0]
    assert torch.equal(calls[0][1], calls[1][1])


def test_clean_run_passes_audit(gate):
    g, x = gate
    y, report = g.build_guarded(x_cal=x, policy=STRICT)(x)
    assert report.ok and not report.detected and not report.degraded
    assert report.actions == [] and report.recovered_by is None
    assert report.outcome == "clean"
    assert torch.equal(y, g.build("emulation")(x))


def test_weight_flip_detected_and_recovered_bit_exact(gate):
    g, x = gate
    clean = g.build("emulation")(x)
    first_conv = _weighted(g.quantized)[0]
    qm_f = TF.inject(g.quantized, TF.FaultPlan((TF.Fault(
        TF.WEIGHT_BIT, first_conv, index=0, bit=6),)))
    y, report = g.build_guarded(x_cal=x, policy=STRICT, qm=qm_f)(x)
    assert report.detected and first_conv in report.flagged
    assert report.actions[0].action == "reexecute"
    assert report.actions[0].flagged  # persistent: reexecute re-flags
    assert report.recovered_by == "unfused" and report.degraded
    assert report.ok and report.outcome == "fell_back"
    assert torch.equal(y, clean)


def test_activation_fault_detected(gate):
    g, x = gate
    plan = TF.FaultPlan.sample(g.quantized, 4, kinds=(TF.ACTIVATION_BIT,),
                               seed=9, bits=(6, 7))
    y, report = g.build_guarded(x_cal=x, policy=STRICT,
                                faults=plan.activation_faults())(x)
    assert report.detected and report.ok
    assert torch.equal(y, g.build("emulation")(x))


def test_per_tensor_rung_serves_degraded_output():
    g = CNN2Gate.from_graph(cnn.resnet_tiny(batch=1), device="cpu")
    x = (RNG.standard_normal((1, 3, 32, 32)) * 0.5).astype(np.float32)
    g.calibrate_quantization(x, per_channel=True)
    qm_f = TF.inject(g.quantized, TF.FaultPlan((TF.Fault(
        TF.WEIGHT_BIT, _weighted(g.quantized)[0], index=0, bit=6),)))
    policy = GuardPolicy(margin=0.0, sat_tol=0.0, fallback_unfused=False)
    _, report = g.build_guarded(x_cal=x, policy=policy, qm=qm_f)(x)
    assert report.detected
    assert report.recovered_by == "per_tensor" and report.degraded
    assert report.ok


def test_concat_producer_fault_recovers_through_unfused_rung(goog):
    g, x = goog
    clean = g.build("emulation")(x)
    producers = [ql.info.name for ql in g.quantized.layers
                 if ql.info.concat is not None and ql.w_q is not None]
    assert producers
    for name in producers:
        for index, bit in ((0, 7), (1, 7), (0, 6), (2, 7)):
            qm_f = TF.inject(g.quantized, TF.FaultPlan((TF.Fault(
                TF.WEIGHT_BIT, name, index=index, bit=bit),)))
            if not torch.equal(t_pipe.make_executor(qm_f)(x), clean):
                break
        else:
            continue
        break
    else:
        pytest.fail("no probed producer flip reached the output")
    gx = g.build_guarded(x_cal=x, policy=STRICT, qm=qm_f)
    y, report = gx(x)
    assert report.detected and report.actions[0].action == "reexecute"
    assert report.recovered_by == "unfused" and report.degraded
    assert report.ok and torch.equal(y, clean)
    lvl = gx._fallbacks["unfused"]
    assert not any(li.concat is not None or li.concat_fused
                   for li in lvl.qm.parsed.layers)


def test_with_program_shares_calibration(gate):
    g, x = gate
    gx = g.build_guarded(x_cal=x, policy=STRICT)
    plan = TF.FaultPlan.sample(g.quantized, 2, kinds=(TF.WEIGHT_BIT,),
                               seed=1, bits=(5, 6, 7))
    gx2 = gx.with_program(TF.inject(g.quantized, plan))
    assert gx2._gold is gx._gold and gx2._fallbacks is gx._fallbacks
    _, report = gx2(x)
    assert report.detected


def test_guard_spans_and_counters():
    g = CNN2Gate.from_graph(cnn.tiny_cnn(batch=1), device="cpu")
    x = (RNG.standard_normal(g.parsed.input_shape)).astype(np.float32)
    g.calibrate_quantization(x)
    reg, tr = tele.MetricsRegistry(), tele.Tracer()
    from repro_torch.core.guard import GuardedExecutor
    qm_f = TF.inject(g.quantized, TF.FaultPlan((TF.Fault(
        TF.WEIGHT_BIT, _weighted(g.quantized)[0], index=0, bit=7),)))
    gx = GuardedExecutor(g, x, policy=STRICT, qm=qm_f, registry=reg,
                         tracer=tr)
    _, report = gx(x)
    snap = reg.snapshot()["counters"]
    assert snap[f"guard.outcome.{report.outcome}"] == 1
    for act in report.actions:
        assert snap[f"guard.rung.{act.action}"] >= 1
    names = {e["name"] for e in tr.events()}
    assert {"guard.infer", "guard.primary",
            "guard.rung.reexecute"} <= names


# ------------------------------- held to tests/test_checkpoint_recovery.py

def test_checkpoint_build_output_identical(gate):
    g, x = gate
    ex = t_pipe.make_executor(g.quantized,
                              checkpoints=TR.plan_checkpoints(g.parsed, 2))
    y, ckpts = ex(x)
    assert torch.equal(y, g.build("emulation")(x)) and len(ckpts) == 2


def test_snapshot_matches_liveness_model(gate):
    g, x = gate
    boundaries = TR.plan_checkpoints(g.parsed, 2)
    _, ckpts = t_pipe.make_executor(g.quantized,
                                    checkpoints=boundaries)(x)
    names = [ql.info.name for ql in g.quantized.layers]
    for b in boundaries:
        snap = ckpts[names[b]]
        model = TR.checkpoint_live_bytes(g.parsed, b)
        assert set(snap) == set(model)
        for t, arr in snap.items():
            assert arr.numel() * arr.element_size() == model[t]
    assert TR.checkpoint_bytes(g.parsed, boundaries) == sum(
        a.numel() for b in boundaries for a in ckpts[names[b]].values())


@pytest.mark.parametrize("fixture", ["gate", "goog"])
def test_replay_bit_exact_from_every_eligible_boundary(fixture, request):
    """On fused programs too; two replays from one snapshot agree, and
    the snapshot is left as it was."""
    g, x = request.getfixturevalue(fixture)
    y0 = g.build("emulation")(x)
    elig = TR.eligible_checkpoints(g.parsed)
    _, ckpts = t_pipe.make_executor(g.quantized, checkpoints=elig)(x)
    names = [ql.info.name for ql in g.quantized.layers]
    for b in elig:
        snap = ckpts[names[b]]
        kept = {t: a.clone() for t, a in snap.items()}
        rex = t_pipe.make_executor(g.quantized, replay_from=b)
        assert torch.equal(rex(snap), y0)
        assert torch.equal(rex(snap), y0)
        assert set(snap) == set(kept)
        assert all(torch.equal(snap[t], kept[t]) for t in kept)


def test_checkpoint_inside_fused_concat_group_rejected(goog):
    g, _ = goog
    layers = g.parsed.layers
    name_idx = {li.name: i for i, li in enumerate(layers)}
    producer = next(i for i, li in enumerate(layers)
                    if li.concat is not None)
    c_end = name_idx[layers[producer].concat.name]
    for bad in range(producer, c_end):
        assert bad not in TR.eligible_checkpoints(g.parsed)
    with pytest.raises(ValueError, match="fused-concat"):
        t_pipe.make_executor(g.quantized, checkpoints=[producer])
    with pytest.raises(TV.VerificationError, match="QV304"):
        t_pipe.make_executor(g.quantized, checkpoints=[len(layers)])


@pytest.mark.parametrize("fixture", ["gate", "goog"])
def test_guard_checkpoint_recovery_bit_exact(fixture, request):
    g, x = request.getfixturevalue(fixture)
    clean = g.build("emulation")(x)
    depth = len(g.quantized.layers)
    last_w = _weighted(g.quantized)[-1]
    for index, bit in ((0, 7), (1, 7), (2, 7), (0, 6), (3, 7)):
        qm_f = TF.inject(g.quantized, TF.FaultPlan((TF.Fault(
            TF.WEIGHT_BIT, last_w, index=index, bit=bit),)))
        if not torch.equal(t_pipe.make_executor(qm_f)(x), clean):
            break
    else:
        pytest.fail("no probed flip reached the output")
    y, report = g.build_guarded(x_cal=x, policy=STRICT, qm=qm_f,
                                checkpoints=2)(x)
    assert report.detected and report.ok and not report.degraded
    assert report.recovered_by == "checkpoint_replay"
    assert report.outcome == "checkpoint_replayed"
    act = report.actions[0]
    assert act.action == "checkpoint_replay" and not act.flagged
    assert 0 < act.replayed < depth
    assert torch.equal(y, clean)


def test_no_upstream_snapshot_falls_through_to_reexecute(gate):
    g, x = gate
    plan = TF.FaultPlan((TF.Fault(TF.WEIGHT_BIT, _weighted(g.quantized)[0],
                                  index=0, bit=6),))
    y, report = g.build_guarded(x_cal=x, policy=STRICT,
                                qm=TF.inject(g.quantized, plan),
                                checkpoints=2)(x)
    assert report.detected and report.actions[0].action == "reexecute"
    assert report.recovered_by == "unfused" and report.ok
    assert torch.equal(y, g.build("emulation")(x))


# ------------------------------------------------------- hook contracts

def test_hook_arguments_are_checked(gate):
    g, x = gate
    qm = g.quantized
    with pytest.raises(ValueError, match="exclusive"):
        t_pipe.make_executor(qm, checkpoints=[1], replay_from=1)
    with pytest.raises(ValueError, match="replay_from=99"):
        t_pipe.make_executor(qm, replay_from=99)
    with pytest.raises(ValueError, match="without staged weights"):
        t_pipe.make_executor(qm, weight_args=("maxpool_nope",))
    with pytest.raises(ValueError, match="unknown tensors"):
        t_pipe.make_executor(qm, fault_args=("no_such_tensor",))
    ex = t_pipe.make_executor(qm, fault_args=(qm.parsed.input_name,))
    with pytest.raises(TypeError, match="expected 1 extra argument.*got 2"):
        ex(x, {}, {})


def test_return_composition(gate):
    g, x = gate
    qm = g.quantized
    assert torch.is_tensor(t_pipe.make_executor(qm)(x))
    y, stats = t_pipe.make_executor(qm, audit=True)(x)
    assert list(stats) == [ql.info.output for ql in qm.layers]
    y2, stats2, ckpts = t_pipe.make_executor(qm, audit=True,
                                             checkpoints=[2])(x)
    assert torch.equal(y, y2) and list(ckpts) == [qm.layers[2].info.name]
    assert all(torch.equal(stats[t], stats2[t]) for t in stats)


def test_fused_concat_producer_audit_is_its_slice_of_the_merge(goog):
    """A fused producer's audit row is the stats of its channel slice of
    the unfused program's merge output (after the pool the merge
    absorbed), which the unfused program holds as a tensor."""
    g, x = goog
    unfused = CNN2Gate.from_graph(cnn.googlenet_tiny(batch=1),
                                  fuse_skip=False, fuse_concat=False,
                                  device="cpu")
    unfused.apply_quantization(g.specs)
    _, stats = t_pipe.make_executor(g.quantized, audit=True)(x)
    u_layers = unfused.quantized.layers
    producers = [ql.info for ql in g.quantized.layers
                 if ql.info.concat is not None]
    merges = sorted({li.concat.output for li in producers})
    at = [i for i, ql in enumerate(u_layers) if ql.info.output in merges]
    _, ckpts = t_pipe.make_executor(unfused.quantized, checkpoints=at)(x)
    merged = {t: a for snap in ckpts.values() for t, a in snap.items()}
    assert any(li.concat.pool is not None for li in producers)
    for li in producers:
        m = merged[li.concat.output]
        sl = m[..., li.concat_offset:li.concat_offset + li.c_out]
        assert torch.equal(stats[li.output], t_pipe._stage_stats(sl))

"""The port's fault injection (``repro_torch.core.faults``) and the
executor's fault hooks against the JAX package's.

Both packages sample plans with numpy on the host, so the same seed over
the same model must give the same plan, fault for fault, and ``inject``
the same corrupted int8 image, spec and all.  Runs of the reference
executor go through the shim of ``tests/torch_reference_shim.py`` on
unfused programs, where every int8 tensor must be equal and the logits
within ``atol=1e-6, rtol=0`` (the softmax tolerance of
``tests/test_torch_e2e.py``).  The rest holds the port to the JAX
package's own fault tests (``tests/test_faults.py``) on fused programs,
and pins what the kernels read: after ``inject`` every layer's K-major
``w_k`` and ``shift_vec`` are staged from its corrupted weight and spec.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as RF
from repro.core import pipeline as r_pipe
from repro.core import resources as RR
from repro_torch.core import faults as TF
from repro_torch.core import pipeline as t_pipe
from repro_torch.core import verify as TV
from repro_torch.core.synthesis import CNN2Gate
from repro_torch.kernels import qconv, qgemm
from repro_torch.models import cnn
from torch_reference_shim import calibrated_pair
from torch_reference_shim import shimmed_reference  # noqa: F401

NETS = ["resnet_tiny", "googlenet_tiny", "mobilenet_tiny"]
_PAIRS = {}


def _pair(name, per_channel=False):
    key = (name, per_channel)
    if key not in _PAIRS:
        _PAIRS[key] = calibrated_pair(name, per_channel=per_channel, seed=3)
    return _PAIRS[key]


def _faults(plan):
    return [dataclasses.astuple(f) for f in plan.faults]


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("name", NETS)
def test_same_seed_same_plan_every_kind(name, per_channel):
    rg, tg, _ = _pair(name, per_channel)
    kinds = RF.ALL_KINDS if per_channel else tuple(
        k for k in RF.ALL_KINDS if k != RF.SHIFT_LANE)
    assert TF.ALL_KINDS == RF.ALL_KINDS
    for seed in (0, 5):
        rp = RF.FaultPlan.sample(rg.quantized, 24, kinds=kinds, seed=seed)
        tp = TF.FaultPlan.sample(tg.quantized, 24, kinds=kinds, seed=seed)
        assert _faults(rp) == _faults(tp) and rp.seed == tp.seed
        assert {k for k, *_ in _faults(tp)} == set(kinds)
        ra, ta = rp.activation_faults(), tp.activation_faults()
        assert set(ra) == set(ta)
        for t in ra:
            assert set(ra[t]) == set(ta[t])
            for k in ra[t]:
                np.testing.assert_array_equal(ra[t][k], ta[t][k])


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("name", NETS)
def test_inject_is_bit_equal(name, per_channel):
    rg, tg, _ = _pair(name, per_channel)
    kinds = TF.PROGRAM_KINDS if per_channel else tuple(
        k for k in TF.PROGRAM_KINDS if k != TF.SHIFT_LANE)
    plan = TF.FaultPlan.sample(tg.quantized, 12, kinds=kinds, seed=1)
    r_inj = RF.inject(rg.quantized, RF.FaultPlan.sample(
        rg.quantized, 12, kinds=kinds, seed=1))
    t_inj = TF.inject(tg.quantized, plan)
    changed = 0
    for rl, tl, gl in zip(r_inj.layers, t_inj.layers, tg.quantized.layers):
        assert rl.info.name == tl.info.name
        for a, b in ((rl.w_q, tl.w_q), (rl.b_q, tl.b_q)):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert (rl.spec is None) == (tl.spec is None)
        if rl.spec is not None:
            assert (rl.spec.m_w, rl.spec.m_x, rl.spec.m_y) == \
                (tl.spec.m_w, tl.spec.m_x, tl.spec.m_y)
        changed += tl is not gl
    assert changed >= 1


@pytest.mark.parametrize("name", NETS)
def test_static_faults_match_the_reference(shimmed_reference, name):
    """A plan of every kind, weight-side by ``inject`` and in flight by
    ``faults=``: every snapshot at every eligible boundary equal in int8,
    the logits within the softmax tolerance."""
    rg, tg, x = _pair(name)
    kinds = tuple(k for k in RF.ALL_KINDS if k != RF.SHIFT_LANE)
    plan_r = RF.FaultPlan.sample(rg.quantized, 6, kinds=kinds, seed=4)
    plan_t = TF.FaultPlan.sample(tg.quantized, 6, kinds=kinds, seed=4)
    elig = RR.eligible_checkpoints(rg.parsed)
    r_ex = r_pipe.make_executor(RF.inject(rg.quantized, plan_r),
                                interpret=True, checkpoints=elig,
                                faults=plan_r.activation_faults())
    t_ex = t_pipe.make_executor(TF.inject(tg.quantized, plan_t),
                                checkpoints=elig,
                                faults=plan_t.activation_faults())
    ry, rck = r_ex(jnp.asarray(x))
    ty, tck = t_ex(x)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=0,
                               atol=1e-6)
    assert set(rck) == set(tck) and len(tck) == len(elig)
    for b in rck:
        assert set(rck[b]) == set(tck[b])
        for t in rck[b]:
            np.testing.assert_array_equal(tck[b][t].numpy(),
                                          np.asarray(rck[b][t]))
    clean = t_pipe.make_executor(tg.quantized)(x)
    assert not torch.equal(ty, clean)


# --------------------------------------------- held to tests/test_faults.py

@pytest.fixture(scope="module")
def gate():
    g = CNN2Gate.from_graph(cnn.resnet_tiny(batch=1), device="cpu")
    x = (np.random.default_rng(11).standard_normal((1, 3, 32, 32))
         * 0.5).astype(np.float32)
    g.calibrate_quantization(x)
    return g, x


def test_sample_deterministic_in_seed(gate):
    g, _ = gate
    kinds = (TF.WEIGHT_BIT, TF.BIAS_BIT, TF.SCALE, TF.DROPPED_TILE,
             TF.ACTIVATION_BIT, TF.ACTIVATION_TILE)
    a = TF.FaultPlan.sample(g.quantized, 16, kinds=kinds, seed=3)
    b = TF.FaultPlan.sample(g.quantized, 16, kinds=kinds, seed=3)
    assert a == b
    assert a != TF.FaultPlan.sample(g.quantized, 16, kinds=kinds, seed=4)
    with pytest.raises(ValueError, match="unknown fault kind"):
        TF.FaultPlan.sample(g.quantized, 1, kinds=("cosmic_ray",))
    with pytest.raises(ValueError, match="no eligible stage"):
        TF.FaultPlan.sample(g.quantized, 1, kinds=(TF.SHIFT_LANE,))


def test_inject_returns_new_model_golden_untouched(gate):
    g, _ = gate
    qm = g.quantized
    golden = [ql.w_q.clone() for ql in qm.layers if ql.w_q is not None]
    golden_k = [ql.w_k.clone() for ql in qm.layers if ql.w_k is not None]
    plan = TF.FaultPlan.sample(qm, 4, kinds=(TF.WEIGHT_BIT,), seed=0)
    qm_f = TF.inject(qm, plan)
    assert qm_f is not qm and qm_f.device == qm.device
    assert all(torch.equal(a, ql.w_q) for a, ql in zip(
        golden, [ql for ql in qm.layers if ql.w_q is not None]))
    assert all(torch.equal(a, ql.w_k) for a, ql in zip(
        golden_k, [ql for ql in qm.layers if ql.w_k is not None]))
    diff = sum(int((a.w_q != b.w_q).sum())
               for a, b in zip(qm.layers, qm_f.layers) if a.w_q is not None)
    assert 1 <= diff <= 4  # one byte per weight_bit fault (collisions ok)


def test_single_weight_bit_flip_is_one_byte(gate):
    g, _ = gate
    qm = g.quantized
    target = next(ql for ql in qm.layers if ql.w_q is not None)
    qm_f = TF.inject(qm, TF.FaultPlan((TF.Fault(
        TF.WEIGHT_BIT, target.info.name, index=7, bit=6),)))
    w0 = target.w_q.reshape(-1)
    w1 = next(ql for ql in qm_f.layers
              if ql.info.name == target.info.name).w_q.reshape(-1)
    changed = torch.nonzero(w0 != w1).reshape(-1).tolist()
    assert changed == [7]
    assert (int(w0[7]) ^ int(w1[7])) & 0xFF == 1 << 6


def test_unknown_stage_rejected(gate):
    g, _ = gate
    with pytest.raises(KeyError, match="no_such_stage"):
        TF.inject(g.quantized, TF.FaultPlan((TF.Fault(TF.WEIGHT_BIT,
                                                      "no_such_stage"),)))


def test_activation_fault_changes_output(gate):
    g, x = gate
    qm = g.quantized
    clean = t_pipe.make_executor(qm)(x)
    payload = TF.FaultPlan.sample(qm, 3, kinds=(TF.ACTIVATION_BIT,),
                                  seed=5).activation_faults()
    assert payload
    assert not torch.equal(clean, t_pipe.make_executor(qm,
                                                       faults=payload)(x))


def test_fault_hooks_off_keep_the_ops_calls(gate):
    """``faults=None`` / ``faults={}`` / ``audit=False`` make exactly the
    ops calls of the executor without hooks: the counterpart of the JAX
    package's jaxpr identity."""
    g, x = gate
    qm = g.quantized
    base = TV.executor_trace(qm)
    assert base == TV.executor_trace(qm, audit=False, faults=None)
    assert base == TV.executor_trace(qm, faults={})
    assert base == TV.executor_trace(qm, weight_args=(), fault_args=(),
                                     checkpoints=None, replay_from=None)


def _grouped():
    """A ragged grouped conv (group 2) between dense ones."""
    b = cnn.GraphBuilder("grouped", (1, 3, 10, 10), 5)
    b.conv(8, 3, pad=1)
    b.conv(8, 3, pad=1, group=2)
    b.global_avgpool()
    b.fc(4, relu=False, softmax=True)
    return b.build()


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("name", NETS + ["grouped"])
def test_inject_restages_what_the_kernels_read(name, per_channel):
    """The kernels read ``w_k`` and ``shift_vec``, which the plain
    versions on the CPU ignore: a fault that reached only ``w_q`` would
    pass every CPU parity test and be masked on the card.  After
    ``inject`` every layer's copies are staged from its corrupted weight
    and spec, by the same route rule as the build."""
    g = CNN2Gate.from_graph(_grouped() if name == "grouped"
                            else getattr(cnn, name)(batch=1), device="cpu")
    x = np.random.default_rng(2).standard_normal(
        g.parsed.input_shape).astype(np.float32)
    g.calibrate_quantization(x, per_channel=per_channel)
    kinds = TF.PROGRAM_KINDS if per_channel else (
        TF.WEIGHT_BIT, TF.BIAS_BIT, TF.SCALE, TF.DROPPED_TILE)
    qm_f = TF.inject(g.quantized, TF.FaultPlan.sample(
        g.quantized, 24, kinds=kinds, seed=8))
    kinds_seen = set()
    for ql in qm_f.layers:
        if ql.w_q is None:
            assert ql.w_k is None and ql.shift_vec is None
            continue
        li = ql.info
        if li.kind == "fc":
            assert torch.equal(ql.w_k, qgemm.stage_kmajor(ql.w_q))
            kinds_seen.add("fc")
        elif li.is_dw_kernel:
            assert ql.w_k is None
            kinds_seen.add("depthwise")
        else:
            assert torch.equal(ql.w_k, qconv.stage_kmajor(ql.w_q, li.group))
            kinds_seen.add("grouped" if li.group > 1 else "dense")
        want = qgemm.stage_shift(ql.spec.requant_shift, ql.w_q.shape[-1],
                                 ql.w_q.device)
        assert (ql.shift_vec is None) == (want is None) == \
            (not per_channel)
        if want is not None:
            assert torch.equal(ql.shift_vec, want)
    assert {"fc"} < kinds_seen


def test_zero_xor_mask_is_the_identity(gate):
    g, x = gate
    qm = g.quantized
    names = [ql.info.output for ql in qm.layers]
    ex = t_pipe.make_executor(qm, fault_args=(qm.parsed.input_name,
                                              names[0], names[-1]))
    nop = (np.asarray([0, 5, 0], np.int32), np.zeros(3, np.int8))
    payload = {t: nop for t in (qm.parsed.input_name, names[0], names[-1])}
    with torch.no_grad():
        assert torch.equal(ex(x, payload), g.build()(x))


def test_xor_payload_combines_repeats_and_drops_no_ops():
    """Repeated indices combine as the JAX package's scatter combines
    them: each writes ``x[i] ^ mask`` from the original value and the
    last slot wins (a zero mask last writes the original back), and a
    zero mask alone is the identity, in any slot order.  As there, an
    index past the tensor is dropped and a negative one counts from the
    end."""
    h = torch.arange(-4, 4, dtype=torch.int8).reshape(2, 4)
    entry = (np.asarray([0, 0, 3, 3, 5]),
             np.asarray([64, 0, 1, 2, -128], np.int8))
    out = t_pipe._apply_arg_faults(h, entry)
    want = h.clone().reshape(-1)
    want[3] ^= 2
    want[5] ^= -128
    assert torch.equal(out, want.reshape(2, 4))
    ref = r_pipe._apply_arg_faults(jnp.asarray(h.numpy()), entry)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert torch.equal(h, torch.arange(-4, 4, dtype=torch.int8).reshape(
        2, 4))  # the input is never written
    edge = (np.asarray([8, -1, 40, -9, 2]), np.asarray([1, 4, 2, 8, 16],
                                                       np.int8))
    out = t_pipe._apply_arg_faults(h, edge)
    want = h.clone().reshape(-1)
    want[7] ^= 4
    want[2] ^= 16
    assert torch.equal(out, want.reshape(2, 4))
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        r_pipe._apply_arg_faults(jnp.asarray(h.numpy()), edge)))


def test_weight_args_stage_the_kernel_operand_from_the_call(gate,
                                                            monkeypatch):
    """A stage named by ``weight_args`` hands the kernels the K-major copy
    of the call-time weight, never the build's ``w_k``."""
    g, x = gate
    qm = g.quantized
    names = [ql.info.name for ql in qm.layers if ql.w_q is not None]
    bad = TF.inject(qm, TF.FaultPlan(tuple(
        TF.Fault(TF.WEIGHT_BIT, n, index=1, bit=7) for n in names)))
    want = t_pipe.make_executor(bad)(x)
    seen = []

    def spy(kind, fn):
        def call(x_, w, b, **kw):
            seen.append((kind, w, kw.get("w_k")))
            return fn(x_, w, b, **kw)
        return call
    monkeypatch.setattr(qconv, "qconv2d", spy("conv", qconv.qconv2d))
    monkeypatch.setattr(qgemm, "qgemm", spy("fc", qgemm.qgemm))
    ex = t_pipe.make_executor(qm, weight_args=names)
    y = ex(x, {ql.info.name: ql.w_q for ql in bad.layers
               if ql.w_q is not None})
    assert torch.equal(y, want)
    assert {k for k, _w, _wk in seen} == {"conv", "fc"}
    assert len(seen) == len(names)
    for (kind, w, w_k), ql in zip(seen, [l for l in bad.layers
                                         if l.w_q is not None]):
        assert torch.equal(w, ql.w_q)
        stage = qconv.stage_kmajor if kind == "conv" else qgemm.stage_kmajor
        assert torch.equal(w_k, stage(w))


def test_a_no_op_slot_after_a_fault_at_index_0():
    """The JAX package's call-time payload is one scatter in which a
    padding slot ``(0, 0)`` after a real fault at flat index 0 writes
    last and undoes it (XLA keeps the last of repeated indices), so that
    trial's flip is lost; the port applies the payload the same way."""
    h = np.arange(8, dtype=np.int8)
    entry = (np.asarray([0, 0], np.int32), np.asarray([64, 0], np.int8))
    ref = np.asarray(r_pipe._apply_arg_faults(jnp.asarray(h), entry))
    np.testing.assert_array_equal(ref, h)
    np.testing.assert_array_equal(
        t_pipe._apply_arg_faults(torch.from_numpy(h), entry).numpy(), ref)


@pytest.mark.parametrize("bits", [(6, 6), (6, 2), (7, 0)],
                         ids=["same_bit", "two_bits", "sign_and_low"])
def test_two_static_flips_on_one_element_match_the_reference(bits):
    """A static ``faults=`` payload with two flips on one element (and a
    zeroed burst): the JAX package's scatter keeps the last flip, written
    from the original value, and so does the port."""
    plan = [TF.Fault(TF.ACTIVATION_BIT, "s", index=5, bit=b, tensor="t")
            for b in bits]
    plan.append(TF.Fault(TF.ACTIVATION_TILE, "s", tile=(9, 12), tensor="t"))
    payload = TF.FaultPlan(tuple(plan)).activation_faults()["t"]
    h = np.arange(-8, 8, dtype=np.int8).reshape(2, 2, 2, 2)
    ref = np.asarray(r_pipe._apply_tensor_faults(jnp.asarray(h), payload))
    got = t_pipe._apply_tensor_faults(torch.from_numpy(h), payload).numpy()
    np.testing.assert_array_equal(got, ref)
    want = h.reshape(-1).copy()
    want[5] ^= np.array(1 << bits[-1], np.uint8).astype(np.int8)
    want[9:12] = 0
    np.testing.assert_array_equal(got.reshape(-1), want)

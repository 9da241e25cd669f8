"""The port's trial-batched SER campaign against the JAX package's
vmapped one, and its parts against the single-trial ones.

The JAX package runs a campaign chunk as ``jax.vmap(_call, in_axes=(None,
0, 0))``: every Pallas kernel on the path then runs in a trial-batched
form, one launch for all trials, each reading its own weight image.  The
port writes that form out: the kernels' trial forms (CPU: the loops of
``kernels/ref.py``), ``faults.trial_weights`` (the stacked weight images
built on the device), ``pipeline.vmap_trials`` (the executor's trial form)
and ``ser.run_campaign`` (one call a chunk, one replay call a boundary
group).  Here, at small sizes on the CPU:

* each trial form equals the loop of its single-trial wrapper and, where
  the JAX package has an oracle for it, that oracle under ``jax.vmap``;
* the stacked weights equal ``faults.inject``'s ``w_q`` and ``w_k``;
* the trial form's logits, stats and checkpoints equal the single-trial
  executor's for every trial, bit for bit (fused programs);
* campaign records and ``summary()`` equal the JAX package's through the
  shim of ``tests/torch_reference_shim.py`` (unfused programs).

The kernels themselves run only on the card: their tests here are marked
``cuda`` and skip without one (``chip_smoke.py`` holds them there).
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ser as r_ser
from repro.kernels import ref as r_ref
from repro_torch.core import faults as TF
from repro_torch.core import pipeline as t_pipe
from repro_torch.core import resources as TR
from repro_torch.core import ser
from repro_torch.core.synthesis import CNN2Gate
from repro_torch.kernels import ops, qconv, qgemm, ref
from repro_torch.models import cnn
from torch_reference_shim import calibrated_pair
from torch_reference_shim import shimmed_reference  # noqa: F401


def _i8(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))


def _bias(rng, n):
    return torch.from_numpy(rng.integers(-3000, 3000, n).astype(np.int32))


# ------------------------------------------------ the kernels' trial forms

@pytest.mark.parametrize("t,m,k,n,per_col,relu", [
    (3, 1, 70, 13, False, True), (4, 2, 128, 40, True, False),
    (2, 9, 33, 7, False, False)])
def test_qgemm_trials_equal_the_loop_and_the_vmapped_oracle(t, m, k, n,
                                                            per_col, relu):
    rng = np.random.default_rng(t * 100 + k)
    x, w, b = _i8(rng, (t * m, k)), _i8(rng, (t, k, n)), _bias(rng, n)
    shift = (tuple(int(s) for s in rng.integers(4, 9, n)) if per_col
             else 6)
    got = qgemm.qgemm_trials(x, w, b, shift=shift, relu=relu)
    loop = torch.cat([qgemm.qgemm(x[i * m:(i + 1) * m], w[i], b,
                                  shift=shift, relu=relu) for i in range(t)])
    assert torch.equal(got, loop)
    assert torch.equal(ops.qgemm(x, w, b, shift=shift, relu=relu), got)
    s = jnp.asarray(shift, jnp.int32) if per_col else shift
    want = jax.vmap(lambda xt, wt: r_ref.qgemm_ref(xt, wt, jnp.asarray(b),
                                                   s, relu))(
        jnp.asarray(x.numpy().reshape(t, m, k)), jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(got.numpy().reshape(t, m, n),
                                  np.asarray(want))


CONVS = [  # name, T, N, Hp, Cin, Cout, k, stride, pool, groups
    ("dense", 3, 1, 9, 8, 16, 3, 1, None, 1),
    ("dense_pool_batch2", 2, 2, 10, 4, 12, 3, 1, (2, 2), 1),
    ("grouped", 3, 1, 9, 8, 12, 3, 1, (3, 2), 2),
    ("depthwise", 4, 1, 10, 8, 8, 3, 1, None, 8),
    ("depthwise_m2_s2", 2, 2, 11, 6, 12, 3, 2, None, 6),
]


def _conv_case(case, seed=0):
    name, t, n, hp, cin, cout, k, s, pool, groups = case
    rng = np.random.default_rng(seed + hp * 7 + cout)
    cin_g = 1 if name.startswith("depthwise") else cin // groups
    x = _i8(rng, (t * n, hp, hp, cin))
    w = _i8(rng, (t, k, k, cin_g, cout))
    b = _bias(rng, cout)
    kw = dict(strides=(s, s), shift=7, relu=True, pool=pool)
    return x, w, b, kw, groups, t, n


def _conv_trials(name):
    if name.startswith("depthwise"):
        return qconv.qdwconv2d_trials, qconv.qdwconv2d
    if name == "grouped":
        return qconv.qgconv2d_trials, qconv.qgconv2d
    return qconv.qconv2d_trials, qconv.qconv2d


@pytest.mark.parametrize("case", CONVS, ids=[c[0] for c in CONVS])
def test_conv_trials_equal_the_loop_and_the_vmapped_oracle(case):
    x, w, b, kw, groups, t, n = _conv_case(case)
    trial_fn, single = _conv_trials(case[0])
    gkw = dict(groups=groups) if case[0] == "grouped" else {}
    got = trial_fn(x, w, b, **gkw, **kw)
    loop = torch.cat([single(x[i * n:(i + 1) * n], w[i], b, **gkw, **kw)
                      for i in range(t)])
    assert torch.equal(got, loop)
    via_ops = ops.qconv2d_nhwc(x, w, b, groups=groups, **kw)
    assert torch.equal(via_ops, got)
    want = jax.vmap(lambda xt, wt: r_ref.qconv2d_ref(
        xt, wt, jnp.asarray(b), kw["strides"], kw["shift"], kw["relu"],
        kw["pool"], groups))(jnp.asarray(x.numpy().reshape(
            (t, n) + tuple(x.shape[1:]))), jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(
        got.numpy().reshape((t, n) + tuple(got.shape[1:])), np.asarray(want))


@pytest.mark.parametrize("case", [CONVS[1], CONVS[4]],
                         ids=["dense_into", "depthwise_into"])
def test_into_trials_write_each_trials_images(case):
    """The concat-buffer forms write trial t's results into its own
    images of the shared buffer, and no other channel."""
    x, w, b, kw, groups, t, n = _conv_case(case, seed=1)
    trial_fn, single = _conv_trials(case[0])
    kw.update(concat_shift=1, concat_relu=True)
    y = trial_fn(x, w, b, **kw)
    c_tot, off = y.shape[-1] + 9, 5
    sentinel = torch.full(tuple(y.shape[:3]) + (c_tot,), 77, dtype=torch.int8)
    buf = trial_fn(x, w, b, out_buf=sentinel.clone(), out_off=off, **kw)
    plain = (ref.qdwconv2d_trials_ref if case[0].startswith("depthwise")
             else ref.qconv2d_trials_ref)
    assert torch.equal(buf, plain(x, w, b, out_buf=sentinel.clone(),
                                  out_off=off, **kw))
    loop = sentinel.clone()
    for i in range(t):
        rows = slice(i * n, (i + 1) * n)
        single(x[rows], w[i], b, out_buf=loop[rows], out_off=off, **kw)
    assert torch.equal(buf, loop)
    assert torch.equal(buf[..., off:off + y.shape[-1]], y)
    others = torch.cat([buf[..., :off], buf[..., off + y.shape[-1]:]], -1)
    assert bool((others == 77).all())


def test_skip_trials_read_each_trials_skip():
    x, w, b, kw, _g, t, n = _conv_case(CONVS[0], seed=2)
    rng = np.random.default_rng(9)
    skip = _i8(rng, (t * n, 7, 7, 16))
    kw.update(skip=skip, skip_shifts=(1, 0), merge_shift=1, merge_relu=True)
    got = qconv.qconv2d_trials(x, w, b, **kw)
    loop = torch.cat([qconv.qconv2d(x[i:i + 1], w[i], b, **dict(
        kw, skip=skip[i:i + 1])) for i in range(t)])
    assert torch.equal(got, loop)


def test_ops_route_a_weight_stack_to_the_trial_forms(monkeypatch):
    """A weight with a leading trial axis goes to the trial form, a shared
    weight to the single form at the batch of all trials."""
    seen = []
    for name in ("qconv2d", "qconv2d_trials", "qdwconv2d",
                 "qdwconv2d_trials", "qgconv2d", "qgconv2d_trials"):
        fn = getattr(qconv, name)
        monkeypatch.setattr(qconv, name, lambda *a, _n=name, _f=fn, **kw: (
            seen.append(_n), _f(*a, **kw))[1])
    for name in ("qgemm", "qgemm_trials"):
        fn = getattr(qgemm, name)
        monkeypatch.setattr(qgemm, name, lambda *a, _n=name, _f=fn, **kw: (
            seen.append(_n), _f(*a, **kw))[1])
    for case in CONVS:
        x, w, b, kw, groups, _t, _n = _conv_case(case)
        ops.qconv2d_nhwc(x, w, b, groups=groups, **kw)
        ops.qconv2d_nhwc(x, w[0], b, groups=groups, **kw)
    rng = np.random.default_rng(3)
    x, w = _i8(rng, (6, 20)), _i8(rng, (3, 20, 5))
    ops.qgemm(x, w, None, shift=4)
    ops.qgemm(x, w[0], None, shift=4)
    assert seen == ["qconv2d_trials", "qconv2d"] * 2 + [
        "qgconv2d_trials", "qgconv2d"] + ["qdwconv2d_trials",
                                          "qdwconv2d"] * 2 + [
        "qgemm_trials", "qgemm"]


def _meta(shape, dtype=torch.int8):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("fn,xs,ws,kw,err,msg", [
    (qconv.qconv2d_trials, (3, 9, 9, 8), (2, 3, 3, 8, 16), {}, ValueError,
     "T\\*N images"),
    (qconv.qconv2d_trials, (2, 9, 9, 8), (3, 3, 8, 16), {}, ValueError,
     "T\\*N images"),
    (qconv.qconv2d_trials, (4, 9, 9, 8), (2, 3, 3, 8, 16),
     dict(w_k=(16, 128)), ValueError, "staged weight"),
    (qconv.qconv2d_trials, (4, 9, 9, 8), (2, 3, 3, 8, 16),
     dict(w_k=(2, 16, 128)), ValueError, "runs on CUDA or the CPU"),
    (qconv.qconv2d, (4, 9, 9, 8), (2, 3, 3, 8, 16), {}, ValueError,
     "HWIO weight"),
    (qconv.qdwconv2d_trials, (4, 9, 9, 8), (2, 3, 3, 1, 8), {}, ValueError,
     "runs on CUDA or the CPU"),
    (qconv.qdwconv2d_trials, (3, 9, 9, 8), (2, 3, 3, 1, 8), {}, ValueError,
     "T\\*N images"),
    (qconv.qgconv2d_trials, (2, 9, 9, 8), (2, 3, 3, 4, 12),
     dict(groups=2), ValueError, "runs on CUDA or the CPU"),
])
def test_trial_wrappers_check_operands_before_the_device(fn, xs, ws, kw, err,
                                                         msg):
    if "w_k" in kw:
        kw = dict(kw, w_k=_meta(kw["w_k"]))
    with pytest.raises(err, match=msg):
        fn(_meta(xs), _meta(ws), None, **kw)


def test_plans_give_each_trial_its_own_row_tiles():
    one = qconv.plan(1, 16, 16, 512, 3, 3, 512, (1, 1), (2, 2))
    many = qconv.plan(1, 16, 16, 512, 3, 3, 512, (1, 1), (2, 2), trials=32)
    assert many.m_tiles == 32 * one.m_tiles and many.k_pad == one.k_pad
    assert many.splits <= one.splits
    fc6 = qgemm.plan(1, 4096, 25088, trials=32)
    assert (fc6.m_tiles, fc6.nw, fc6.splits) == (32, 8, 1)
    assert qgemm.stage_kmajor(torch.ones((2, 3, 5), dtype=torch.int8)).shape \
        == (2, 5, 128)
    w = _i8(np.random.default_rng(0), (3, 3, 3, 4, 6))
    assert torch.equal(qconv.stage_kmajor(w)[1], qconv.stage_kmajor(w[1]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the trial-form kernels run only "
                    "on the card (chip_smoke.py holds them there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONVS, ids=[c[0] for c in CONVS])
def test_trial_kernels_equal_their_plain_versions_on_the_card(card, case):
    x, w, b, kw, groups, _t, _n = _conv_case(case)
    trial_fn, _single = _conv_trials(case[0])
    gkw = dict(groups=groups) if case[0] == "grouped" else {}
    x, w, b = x.to(card), w.to(card), b.to(card)
    got = trial_fn(x, w, b, **gkw, **kw)
    want = trial_fn(x.cpu(), w.cpu(), b.cpu(), **gkw, **kw)
    assert torch.equal(got.cpu(), want)
    rng = np.random.default_rng(1)
    xg, wg, bg = _i8(rng, (12, 300)), _i8(rng, (4, 300, 70)), _bias(rng, 70)
    y = qgemm.qgemm_trials(xg.to(card), wg.to(card), bg.to(card), shift=6)
    assert torch.equal(y.cpu(), qgemm.qgemm_trials(xg, wg, bg, shift=6))


# --------------------------------------------- stacked trial weight images

def _grouped():
    """A ragged grouped conv (group 2) between dense ones."""
    b = cnn.GraphBuilder("grouped", (1, 3, 10, 10), 5)
    b.conv(8, 3, pad=1)
    b.conv(8, 3, pad=1, group=2)
    b.global_avgpool()
    b.fc(4, relu=False, softmax=True)
    return b.build()


_GATES = {}


def _gate(name):
    if name not in _GATES:
        g = CNN2Gate.from_graph(_grouped() if name == "grouped"
                                else getattr(cnn, name)(batch=1),
                                device="cpu")
        x = (np.random.default_rng(4).standard_normal(g.parsed.input_shape)
             * 0.5).astype(np.float32)
        g.calibrate_quantization(x)
        _GATES[name] = (g, x)
    return _GATES[name]


@pytest.mark.parametrize("name", ["resnet_tiny", "mobilenet_tiny",
                                  "grouped"])
def test_trial_weights_equal_inject(name):
    g, _x = _gate(name)
    qm = g.quantized
    weighted = [ql.info.name for ql in qm.layers if ql.w_q is not None]
    plans = [TF.FaultPlan.sample(qm, 8, kinds=(TF.WEIGHT_BIT,
                                               TF.DROPPED_TILE), seed=s)
             for s in range(6)]
    # faults whose order matters: a flip under a later tile, a flip after
    # a tile, two flips of one bit (cancel) and of two bits
    s0, cout = weighted[1], qm.layers[1].w_q.shape[-1]
    plans.append(TF.FaultPlan((
        TF.Fault(TF.WEIGHT_BIT, s0, index=cout + 1, bit=3),
        TF.Fault(TF.DROPPED_TILE, s0, tile=(0, 2)),
        TF.Fault(TF.WEIGHT_BIT, s0, index=0, bit=7),
        TF.Fault(TF.WEIGHT_BIT, s0, index=3, bit=1),
        TF.Fault(TF.WEIGHT_BIT, s0, index=3, bit=1),
        TF.Fault(TF.WEIGHT_BIT, s0, index=4, bit=2),
        TF.Fault(TF.WEIGHT_BIT, s0, index=4, bit=6))))
    plans.append(TF.FaultPlan(()))
    stacks = TF.trial_weights(qm, plans, weighted)
    for n, (w, wk) in stacks.items():   # the pair is w and its staging
        li = next(ql.info for ql in qm.layers if ql.info.name == n)
        staged = t_pipe.stage_kmajor(li, w)
        assert (wk is None) == (staged is None) and (
            wk is None or torch.equal(wk, staged))
    for t, plan in enumerate(plans):
        inj = {ql.info.name: ql for ql in TF.inject(qm, plan).layers}
        for n, (w, wk) in stacks.items():
            assert torch.equal(w[t], inj[n].w_q), (t, n)
            if inj[n].w_k is None:       # depthwise: no K-major copy
                assert wk is None
            else:
                assert torch.equal(wk[t], inj[n].w_k), (t, n)


def test_trial_weights_refuse_kinds_beyond_the_weight_image():
    g, _x = _gate("resnet_tiny")
    qm = g.quantized
    name = next(ql.info.name for ql in qm.layers if ql.b_q is not None)
    with pytest.raises(ValueError, match="bias_bit"):
        TF.trial_weights(qm, [TF.FaultPlan((TF.Fault(TF.BIAS_BIT, name),))],
                         [name])


# ----------------------------------------------- the executor's trial form

def _payload(rng, qm, tensors, trials, slots=3):
    """Random (idx, mask) rows with repeats, zero slots and index 0."""
    sizes = {ql.info.output: t_pipe.layer_bytes(ql.info)[2]
             for ql in qm.layers}
    sizes[qm.parsed.input_name] = int(np.prod(qm.parsed.input_shape))
    out = {}
    for t in tensors:
        idx = rng.integers(0, sizes[t], (trials, slots)).astype(np.int32)
        idx[0, :2] = 0                    # a real flip, then a no-op slot
        idx[1, 1] = idx[1, 0]             # a repeat
        mask = np.array(1, np.uint8) << rng.integers(
            0, 8, (trials, slots)).astype(np.uint8)
        mask = mask.astype(np.int8)
        mask[0, 1] = 0
        out[t] = (idx, mask)
    return out


def _exec_case(name, late_only):
    g, x = _gate(name)
    qm = g.quantized
    stages = qm.layers
    weighted = [ql.info.name for ql in stages if ql.w_q is not None]
    wargs = weighted[len(weighted) // 2:] if late_only else weighted
    prods = [ql.info.output for ql in stages if ql.info.concat is not None]
    fargs = [stages[len(stages) // 2].info.output] + prods[:1]
    if not late_only:
        fargs.append(qm.parsed.input_name)
    bnd = TR.plan_checkpoints(qm.parsed, 2)
    return g, x, qm, wargs, sorted(set(fargs)), bnd


@pytest.mark.parametrize("late_only", [False, True],
                         ids=["every_stage", "late_stages"])
@pytest.mark.parametrize("name", ["resnet_tiny", "googlenet_tiny",
                                  "mobilenet_tiny", "grouped"])
def test_vmapped_executor_equals_the_single_trial_executor(name, late_only):
    """Every trial's logits, audit stats and checkpoints from one call of
    the trial form equal the executor's own call with that trial's
    weights and payload, bit for bit; each boundary's replay likewise.
    ``late_stages`` leaves the first half of the stages shared (run once,
    at the batch of one)."""
    g, x, qm, wargs, fargs, bnd = _exec_case(name, late_only)
    rng = np.random.default_rng(17)
    trials = 3
    plans = [TF.FaultPlan.sample(qm, 4, kinds=(TF.WEIGHT_BIT,
                                               TF.DROPPED_TILE), seed=s)
             for s in range(trials)]
    weights = TF.trial_weights(qm, plans, wargs)
    payload = _payload(rng, qm, fargs, trials)
    static = TF.FaultPlan.sample(qm, 2, kinds=(TF.ACTIVATION_BIT,
                                               TF.ACTIVATION_TILE),
                                 seed=5).activation_faults()
    ex = t_pipe.make_executor(qm, audit=True, checkpoints=bnd,
                              weight_args=wargs, fault_args=fargs,
                              faults=static)
    ys, stats, ckpts = t_pipe.vmap_trials(ex)(x, weights, payload)
    assert ys.shape[0] == trials and set(ckpts) == {
        qm.layers[b].info.name for b in bnd}
    for t in range(trials):
        y, st, ck = ex(x, {n: w[t] for n, (w, _wk) in weights.items()},
                       {k: (i[t], m[t]) for k, (i, m) in payload.items()})
        assert torch.equal(ys[t], y)
        assert list(stats) == list(st)
        for k in st:
            assert torch.equal(stats[k][t], st[k]), (t, k)
        for b in ck:
            assert set(ckpts[b]) == set(ck[b])
            for k in ck[b]:
                assert torch.equal(ckpts[b][k][t], ck[b][k]), (t, b, k)
    clean = t_pipe.make_executor(qm)(x)
    assert any(not torch.equal(ys[t], clean) for t in range(trials))
    for b in bnd:
        rex = t_pipe.make_executor(qm, audit=True, replay_from=b)
        env = ckpts[qm.layers[b].info.name]
        yr, sr = t_pipe.vmap_trials(rex)(env)
        for t in range(trials):
            y1, s1 = rex({k: v[t] for k, v in env.items()})
            assert torch.equal(yr[t], y1)
            assert all(torch.equal(sr[k][t], s1[k]) for k in s1)


def test_vmap_trials_refuses_what_it_cannot_batch():
    g, x = _gate("resnet_tiny")
    qm = g.quantized
    with pytest.raises(TypeError, match="stage-timed"):
        t_pipe.vmap_trials(t_pipe.make_executor(qm, stage_timed=True))
    names = [ql.info.name for ql in qm.layers if ql.w_q is not None][:2]
    ex = t_pipe.make_executor(qm, weight_args=names)
    w = {n: wq for n, (wq, _wk) in TF.trial_weights(
        qm, [TF.FaultPlan(())] * 2, names).items()}
    with pytest.raises(ValueError, match="leading trial axis"):
        t_pipe.vmap_trials(ex)(x, {names[0]: w[names[0]],
                                   names[1]: w[names[1]][:1]})
    with pytest.raises(ValueError, match="expected"):
        t_pipe.vmap_trials(ex)(x, {n: v[0] for n, v in w.items()})


# -------------------------------------- campaigns against the reference

def _record(r):
    return (dataclasses.astuple(r.plan), r.stages, r.flagged, r.outcome,
            r.output_differs, r.recovered, r.escalated, r.replayed)


def _same_campaign(rg, tg, x, **kw):
    want = r_ser.run_campaign(rg, x, **kw)
    got = ser.run_campaign(tg, x, **kw)
    assert [_record(r) for r in got.records] == \
        [_record(r) for r in want.records]
    assert json.dumps(got.summary(), sort_keys=True) == \
        json.dumps(want.summary(), sort_keys=True)
    return got


_PAIRS = {}


def _pair(name):
    if name not in _PAIRS:
        _PAIRS[name] = calibrated_pair(name, seed=0)
    return _PAIRS[name]


@pytest.mark.parametrize("flips", [1, 2])
@pytest.mark.parametrize("kind", ser.CAMPAIGN_KINDS)
def test_campaign_matches_the_reference_for_each_kind(shimmed_reference,
                                                      kind, flips):
    rg, tg, x = _pair("resnet_tiny")
    got = _same_campaign(rg, tg, x, trials=10, flips=flips, kinds=(kind,),
                         seed=1, checkpoints=2, chunk=4)
    assert all(len(r.plan.faults) == flips for r in got.records)
    assert {f.kind for r in got.records for f in r.plan.faults} == {kind}


def test_campaign_with_a_flip_on_element_0_matches_the_reference(
        shimmed_reference):
    """Seed 12's first two trials flip element 0 of a tensor whose payload
    row then holds a no-op slot ``(0, 0)``: the reference's scatter undoes
    the flip, and so does the port (with the two slots XOR-combined
    instead, these trials' records differ from the reference's)."""
    rg, tg, x = _pair("resnet_tiny")
    kw = dict(trials=4, flips=2, kinds=(TF.ACTIVATION_BIT,), seed=12,
              checkpoints=2, chunk=4)
    got = _same_campaign(rg, tg, x, **kw)
    at0 = [r for r in got.records if any(
        f.index == 0 and sum(g.tensor == f.tensor for g in r.plan.faults) == 1
        for f in r.plan.faults)]
    assert at0


def test_campaign_with_a_ragged_chunk_matches_the_reference(
        shimmed_reference):
    rg, tg, x = _pair("mobilenet_tiny")
    got = _same_campaign(rg, tg, x, trials=11, flips=1,
                         kinds=ser.CAMPAIGN_KINDS, seed=4, checkpoints=1,
                         chunk=4)
    assert got.trials == 11


def test_campaign_without_checkpoints_matches_the_reference(
        shimmed_reference):
    rg, tg, x = _pair("resnet_tiny")
    got = _same_campaign(rg, tg, x, trials=8, flips=2,
                         kinds=ser.CAMPAIGN_KINDS, seed=6, checkpoints=0,
                         chunk=8)
    assert got.boundaries == ()
    assert all(r.escalated for r in got.records if r.outcome == "detected")


def test_campaign_makes_one_call_a_chunk_and_a_replay_group(monkeypatch):
    """One call of the executor's trial form a chunk, one of the replay's
    a boundary group; the single-trial executor runs once (golden)."""
    g, x = _gate("resnet_tiny")
    calls = {"single": 0, "chunk": 0, "replay": 0}
    make, vmap = t_pipe.make_executor, t_pipe.vmap_trials

    def counted_make(*a, **kw):
        ex = make(*a, **kw)
        kind = "replay" if kw.get("replay_from") is not None else "chunk"

        def single(*args):
            calls["single"] += 1
            return ex(*args)

        def batched(*args):
            calls[kind] += 1
            return vmap(ex)(*args)
        single.trials = batched
        return single
    monkeypatch.setattr(t_pipe, "make_executor", counted_make)
    camp = ser.run_campaign(g, x, trials=10, kinds=ser.CAMPAIGN_KINDS,
                            seed=3, checkpoints=2, chunk=4)
    names = [li.name for li in g.parsed.layers]
    groups = 0
    for lo in range(0, 10, 4):
        firsts = [min(names.index(st) for st in r.flagged)
                  for r in camp.records[lo:lo + 4] if r.outcome == "detected"]
        groups += len({max(b for b in camp.boundaries if b < f)
                       for f in firsts
                       if any(b < f for b in camp.boundaries)})
    assert calls == {"single": 1, "chunk": math.ceil(10 / 4),
                     "replay": groups}
    assert groups >= 1

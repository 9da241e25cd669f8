"""The port's training path against the JAX package's: the loss and its
gradient for every architecture, the optimizer, remat, gradient
compression, microbatching, the straggler monitor, the data pipeline,
``input_specs`` and the launcher.

Model-level tests convert a JAX ``Model.init`` tree (numpy leaves,
every mamba layer's ``conv_b``/``conv_c`` and their biases drawn from a
seed: the reference's zeros make the SSD term 0) with
``convert.lm_params_from_numpy`` and feed both packages the same numpy
batch (B 2 x S 16) on the smoke configs, in float32.

Tolerances: the loss within 1e-5 relative; each gradient leaf within
1e-4 of its own largest |g| plus 1e-6 of the whole gradient's largest
|g|.  Both packages sum in float32 in other orders (measured: the loss
to 1.7e-7 relative, leaves to 6.5e-6 of their max |g|); the floor tied
to the whole gradient covers leaves whose true gradient is 0 (whisper's
key biases: softmax ignores a per-query shift) and which both packages
fill with ~2e-9 of float32 noise.  An optimizer step fed identical
gradients is held to 1e-6 relative.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro import distributed as r_dist
from repro import optim as r_optim
from repro.data import pipeline as r_data
from repro.models.model import Model as RModel
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch import distributed as t_dist
from repro_torch import optim as t_optim
from repro_torch.configs.base import DECODE_32K, PREFILL_32K, TRAIN_4K
from repro_torch.data import pipeline as t_data
from repro_torch.kernels import ops
from repro_torch.launch import train as t_train
from repro_torch.models.model import Model as TModel

BC_KEYS = ("conv_b", "conv_c", "conv_bias_b", "conv_bias_c")
LOSS_RTOL = 1e-5
LEAF_RTOL, WHOLE_RTOL = 1e-4, 1e-6


def _mamba_subtrees(cfg, tree):
    stack = tree["stack"]
    if cfg.family == "ssm":
        return [stack["mamba"]]
    if cfg.family == "hybrid":
        return [stack["mamba_stack"]["mamba"]]
    return []


@functools.lru_cache(maxsize=None)
def _jax_tree(name):
    """The JAX smoke model's parameters (numpy leaves), B/C convs seeded."""
    cfg = r_configs.get_smoke(name)
    tree = jax.tree.map(np.array, RModel(cfg).init(jax.random.key(0)))
    rng = np.random.default_rng(11)
    for sub in _mamba_subtrees(cfg, tree):
        for key in BC_KEYS:
            sub[key] = (rng.standard_normal(sub[key].shape) * 0.3).astype(
                np.float32)
    return tree


def _batch(cfg, bsz=2, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.input_embeds and cfg.family != "encdec":
        b["embeds"] = rng.standard_normal(
            (bsz, seq, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size,
                                   (bsz, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (bsz, seq)).astype(np.int32)
    labels[0, :3] = -1                  # masked out of the loss
    b["labels"] = labels
    if cfg.mrope:
        b["positions"] = rng.integers(0, 3 * seq, (3, bsz, seq)).astype(
            np.int32)
    if cfg.family == "encdec":
        b["audio_embeds"] = rng.standard_normal(
            (bsz, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port(name, remat="none", tree=None):
    cfg = t_configs.get_smoke(name)
    params = convert.lm_params_from_numpy(
        cfg, _jax_tree(name) if tree is None else tree, device="cpu")
    return TModel(cfg, "cpu", remat=remat), params.requires_grad_(True)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_grads_close(got_tree, want_tree):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert set(got) == set(want)
    whole = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        tol = LEAF_RTOL * np.abs(w).max() + WHOLE_RTOL * whole
        err = np.abs(got[k] - w).max()
        assert err <= tol, (k, err, tol)


# --------------------------------------------------------- loss and grads

@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name):
    cfg = r_configs.get_smoke(name)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    params = jax.tree.map(jnp.asarray, _jax_tree(name))
    loss, grads = jax.jit(jax.value_and_grad(RModel(cfg).loss))(params,
                                                                batch)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("name", r_configs.ARCH_NAMES)
def test_loss_and_gradients_match(name):
    want_loss, want_grads = _jax_value_and_grad(name)
    model, params = _port(name)
    loss, grads = t_optim.value_and_grad(
        model.loss, params, _torch_batch(_batch(model.cfg)))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_grads_close(convert.named_to_numpy(model.cfg, grads), want_grads)
    assert all(p.grad is None for p in params.parameters())


def test_moe_loss_adds_the_aux_term():
    """granite's loss is its cross entropy plus 0.01 * aux / n_layers,
    the aux loss the serving forward keeps as ``_last_aux``."""
    name = "granite-moe-1b-a400m"
    model, params = _port(name)
    batch = _torch_batch(_batch(model.cfg))
    with torch.no_grad():
        logits = model.forward(params, batch).float()
        loss = model.loss(params, batch)
    labels = batch["labels"].long()
    mask = labels >= 0
    ce = torch.nn.functional.cross_entropy(logits[mask], labels[mask])
    aux = 0.01 * model._last_aux / model.cfg.n_layers
    assert float(aux) > 0
    torch.testing.assert_close(loss, ce + aux, rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------- remat

@pytest.mark.parametrize("name", ["qwen2-1.5b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_remat_policies_give_equal_gradients(name):
    """``full`` and ``dots`` recompute the same operations on the same
    inputs: the gradients are equal, bit for bit."""
    batch = _torch_batch(_batch(t_configs.get_smoke(name)))
    results = {}
    for remat in ("none", "full", "dots"):
        model, params = _port(name, remat)
        results[remat] = t_optim.value_and_grad(model.loss, params, batch)
    loss0, g0 = results["none"]
    for remat in ("full", "dots"):
        loss, g = results[remat]
        assert torch.equal(loss, loss0), remat
        assert all(torch.equal(g[k], g0[k]) for k in g0), remat


def test_unknown_remat_policy_raises_in_both_packages():
    name = "qwen2-1.5b"
    cfg = t_configs.get_smoke(name)
    batch = _batch(cfg)
    model, params = _port(name, "everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        model.loss(params, _torch_batch(batch))
    rmodel = RModel(r_configs.get_smoke(name), remat="everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        rmodel.loss(jax.tree.map(jnp.asarray, _jax_tree(name)),
                    {k: jnp.asarray(v) for k, v in batch.items()})


def test_dots_recomputes_all_but_the_matrix_products():
    """What the backward pass recomputes of the forward: nothing under
    ``none``; the 2-D products and the SiLU under ``full``; under ``dots``
    the SiLUs but no 2-D product (its outputs were kept), so the
    backward's ``mm`` count is ``none``'s."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] = self.ops.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    name = "qwen2-1.5b"
    batch = _torch_batch(_batch(t_configs.get_smoke(name)))
    mm, silu = torch.ops.aten.mm.default, torch.ops.aten.silu.default
    seen = {}
    for remat in ("none", "full", "dots"):
        model, params = _port(name, remat)
        loss = model.loss(params, batch)
        with Count() as c:
            loss.backward()
        seen[remat] = (c.ops.get(mm, 0), c.ops.get(silu, 0))
    layers = model.cfg.n_layers
    assert seen["none"][1] == 0
    # the recompute stops once the backward has what it needs: the down
    # projection, last in the layer, is not rerun
    assert seen["full"] == (seen["none"][0] + 6 * layers, layers)
    assert seen["dots"] == (seen["none"][0], layers)


# ------------------------------------------------- kernels refuse grads

def test_loss_on_the_flash_kernel_raises():
    name = "qwen2-1.5b"
    cfg = dataclasses.replace(t_configs.get_smoke(name),
                              attention_impl="flash")
    params = convert.lm_params_from_numpy(cfg, _jax_tree(name),
                                          device="cpu").requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        TModel(cfg, "cpu").loss(params, _torch_batch(_batch(cfg)))
    with torch.no_grad():
        assert torch.isfinite(TModel(cfg, "cpu").loss(
            params, _torch_batch(_batch(cfg))))


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 8, 16, generator=g, requires_grad=True)
    kv = torch.randn(1, 2, 8, 16, generator=g)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        ops.flash_attention(q, kv, kv)
    with torch.no_grad():
        ops.flash_attention(q, kv, kv)
    x = torch.randn(1, 8, 2, 16, generator=g)
    dt = torch.rand(1, 8, 2, generator=g)
    a = -torch.rand(2, generator=g)
    bc = torch.randn(1, 8, 1, 16, generator=g, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan has no backward"):
        ops.ssd_scan(x, dt, a, bc, bc.detach(), chunk=4)
    ops.ssd_scan(x, dt, a, bc.detach(), bc.detach(), chunk=4)


def test_the_training_loss_never_reaches_the_ssd_wrapper(monkeypatch):
    """Under ``loss`` every mamba scan runs the plain version itself; a
    serving forward still calls ``ops.ssd_scan``."""
    calls = []
    real = ops.ssd_scan
    monkeypatch.setattr(ops, "ssd_scan",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model, params = _port("zamba2-2.7b")
    batch = _torch_batch(_batch(model.cfg))
    model.loss(params, batch).backward()
    assert calls == []
    model.forward(params, batch)
    assert len(calls) == model.cfg.n_layers


# --------------------------------------------------------------- optim

def _tree_of(named_tree):
    return jax.tree.map(jnp.asarray, named_tree)


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
def test_apply_update_matches(opt_name):
    """Three steps fed the same gradients (one of them large enough to be
    clipped) from the same state."""
    name = "qwen2-1.5b"
    cfg = t_configs.get_smoke(name)
    opt = r_optim.OptimizerConfig(name=opt_name, lr=1e-2, warmup_steps=2)
    topt = t_optim.OptimizerConfig(**dataclasses.asdict(opt))
    model, params = _port(name)
    rng = np.random.default_rng(5)
    tree = _jax_tree(name)
    grads = [jax.tree.map(lambda x, s=s: (rng.standard_normal(x.shape)
                                          * s).astype(np.float32), tree)
             for s in (0.01, 1.0, 0.1)]
    rparams = _tree_of(tree)
    rstate = r_optim.init_opt_state(rparams, opt)
    tstate = t_optim.init_opt_state(params, topt)
    for step, g in enumerate(grads):
        rparams, rstate, rm = r_optim.apply_update(
            rparams, _tree_of(g), rstate, jnp.asarray(step, jnp.int32), opt)
        tg = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
        convert._fill(convert._structure(cfg), g, named=tg)
        _, _, tm = t_optim.apply_update(params, tg, tstate, step, topt)
        assert tm["lr"] == pytest.approx(float(rm["lr"]), rel=1e-7)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
    for got, want in ((convert.lm_params_to_numpy(cfg, params), rparams),
                      *[(convert.named_to_numpy(cfg, tstate[k]), rstate[k])
                        for k in rstate]):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=1e-6, atol=1e-7), got, want)


def test_schedule_and_masters_are_the_jax_packages():
    cfg = t_optim.OptimizerConfig(lr=3e-4, warmup_steps=7)
    rcfg = r_optim.OptimizerConfig(lr=3e-4, warmup_steps=7)
    for step in (0, 1, 5, 6, 7, 100):
        assert t_optim.schedule(cfg, step) == float(
            r_optim.schedule(rcfg, jnp.asarray(step, jnp.int32)))
    model, params = _port("qwen2-1.5b")
    state = t_optim.init_opt_state(params, cfg)
    assert set(state) == {"master", "mu", "nu"}
    for n, p in params.named_parameters():
        m = state["master"][n]
        assert m.dtype == torch.float32 and torch.equal(m, p.detach())
        assert m.data_ptr() != p.data_ptr()
    assert set(t_optim.init_opt_state(params, t_optim.OptimizerConfig(
        name="sgd"))) == {"master", "mu"}


def test_optimizer_groups_bound_the_temporaries(monkeypatch):
    """The update walks the leaves in groups; with one leaf a group it
    gives the same result."""
    cfg = t_optim.OptimizerConfig(lr=1e-2, warmup_steps=1)
    out = []
    for group in (t_optim.GROUP_ELEMENTS, 1):
        monkeypatch.setattr(t_optim, "GROUP_ELEMENTS", group)
        model, params = _port("qwen2-1.5b")
        state = t_optim.init_train_state(
            model, torch.Generator().manual_seed(0), cfg)
        step = t_optim.make_train_step(model, cfg)
        batch = _torch_batch(_batch(model.cfg))
        for _ in range(2):
            step(state, batch)
        out.append([p.detach().clone() for p in state["params"].parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def assert_state_tracks_jax(got, want, lrs, opt_name):
    """A port train state against the JAX package's after the same steps
    (numpy trees).  SGD: every leaf within the JAX resume test's
    tolerance (rtol 2e-5, atol 2e-6).  AdamW normalizes each element's
    update, so an element whose gradient is as small as the float32
    noise of the two packages' sums (their key biases, whose true
    gradient is 0, and a few weights) moves by as much as any other,
    in a direction that noise picks: at most 0.1 % of the elements may
    leave that tolerance, each by at most 2 * the sum of the steps'
    learning rates (PR 22 measured 10 of 90,688 after two steps)."""
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    beyond = total = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        out = diff > 2e-6 + 2e-5 * np.abs(w)
        if opt_name == "sgd" or "['step']" in k:
            assert not out.any(), (k, diff.max())
        assert diff.max() <= 2 * sum(lrs), (k, diff.max())
        beyond += int(out.sum())
        total += w.size
    assert beyond <= 1e-3 * total, (beyond, total)


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
def test_train_step_matches_the_jax_train_step(opt_name):
    """Two steps of ``make_train_step`` from the same state and batches:
    the losses within 1e-5, the state as :func:`assert_state_tracks_jax`
    says."""
    name = "qwen2-1.5b"
    cfg = t_configs.get_smoke(name)
    opt = r_optim.OptimizerConfig(name=opt_name, lr=1e-3, warmup_steps=2)
    topt = t_optim.OptimizerConfig(**dataclasses.asdict(opt))
    rmodel = RModel(r_configs.get_smoke(name))
    rstate = r_optim.init_train_state(rmodel, jax.random.key(0), opt)
    model = TModel(cfg, "cpu")
    tstate = t_optim.init_train_state(
        model, torch.Generator().manual_seed(1), topt)
    convert.train_state_from_numpy(cfg, jax.tree.map(np.asarray, rstate),
                                   tstate)
    rstep = jax.jit(r_optim.make_train_step(rmodel, opt))
    tstep = t_optim.make_train_step(model, topt)
    lrs = []
    for seed in (1, 2):
        batch = _batch(cfg, seed=seed)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, _torch_batch(batch))
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=LOSS_RTOL)
        lrs.append(tm["lr"])
    assert tstate["step"] == int(rstate["step"]) == 2
    assert_state_tracks_jax(convert.train_state_to_numpy(cfg, tstate),
                            jax.tree.map(np.asarray, rstate), lrs, opt_name)


# ------------------------------------------- compression, accumulation

def test_quantize_and_ef_compress_are_bit_equal():
    rng = np.random.default_rng(3)
    for scale in (1e-3, 1.0, 50.0):
        x = (rng.standard_normal(257) * scale).astype(np.float32)
        rq, rs = r_dist.quantize_int8(jnp.asarray(x))
        tq, ts = t_dist.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        assert ts.numpy().tobytes() == np.asarray(rs).tobytes()
        np.testing.assert_array_equal(
            t_dist.dequantize_int8(tq, ts).numpy(),
            np.asarray(r_dist.dequantize_int8(rq, rs)))
    zero_q, zero_s = t_dist.quantize_int8(torch.zeros(4))
    assert not zero_q.any() and float(zero_s) > 0
    g = {"a": rng.standard_normal((8, 4)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    re = {k: jnp.zeros(v.shape) for k, v in g.items()}
    te = {k: torch.zeros(v.shape) for k, v in g.items()}
    for _ in range(4):
        rd, re = r_dist.ef_compress({k: jnp.asarray(v) for k, v in g.items()},
                                    re)
        td, te = t_dist.ef_compress({k: torch.from_numpy(v)
                                     for k, v in g.items()}, te)
        for k in g:
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(rd[k]))
            np.testing.assert_array_equal(te[k].numpy(), np.asarray(re[k]))
    _, params = _port("qwen2-1.5b")
    ef = t_dist.init_error_feedback(params)
    assert all(e.dtype == torch.float32 and not e.any() for e in ef.values())
    assert set(ef) == {n for n, _ in params.named_parameters()}


def test_accumulating_step_matches_the_full_batch():
    model, params = _port("qwen2-1.5b")
    batch = _torch_batch(_batch(model.cfg, bsz=4))
    batch["labels"].clamp_(min=0)      # equal label counts a half
    l1, g1 = t_dist.make_accumulating_step(model.loss, 1)(params, batch)
    l2, g2 = t_dist.make_accumulating_step(model.loss, 2)(params, batch)
    # the mean of two halves' means equals the full mean: equal counts
    assert float(l2) == pytest.approx(float(l1), rel=1e-6)
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k].float(), rtol=1e-5,
                                   atol=1e-7)
    assert all(p.grad is None for p in params.parameters())


def test_accumulating_train_step_matches_one_step():
    cfg = t_optim.OptimizerConfig(lr=1e-2, warmup_steps=1)
    out = []
    for n_micro in (1, 2):
        model, _ = _port("qwen2-1.5b")
        state = t_optim.init_train_state(
            model, torch.Generator().manual_seed(0), cfg)
        batch = _torch_batch(_batch(model.cfg, bsz=4))
        batch["labels"].clamp_(min=0)
        state, m = t_optim.make_train_step(model, cfg, n_micro=n_micro)(
            state, batch)
        out.append((float(m["loss"]), [p.detach().clone()
                                       for p in state["params"].parameters()]))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    # an AdamW step moves every element by about lr = 1e-2 whatever its
    # gradient, so a near-zero gradient summed in another order may move
    # by up to ~lr: hold the parameters to 1e-3 of a step
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_straggler_monitor_matches():
    durations = [1.0] * 8 + [5.0, 5.0, 5.0, 1.0, 0.9, 7.0, 1.1, 3.0]
    rm = r_dist.StragglerMonitor(window=6, threshold=2.0, sustained=2)
    tm = t_dist.StragglerMonitor(window=6, threshold=2.0, sustained=2)
    for step, d in enumerate(durations):
        re, te = rm.observe(step, d), tm.observe(step, d)
        assert (re is None) == (te is None)
        assert tm.should_checkpoint == rm.should_checkpoint
    assert [dataclasses.astuple(e) for e in tm.events] == [
        dataclasses.astuple(e) for e in rm.events]
    assert len(tm.events) >= 3
    tm.start()
    assert tm.stop(99) is None or tm.events[-1].step == 99
    with pytest.raises(RuntimeError, match="without start"):
        tm.stop(100)


# --------------------------------------------------------- data pipeline

@pytest.mark.parametrize("seed,hosts", [(0, 1), (5, 2), (17, 1)])
def test_synthetic_batches_are_the_jax_packages(seed, hosts):
    for host in range(hosts):
        kw = dict(vocab_size=101, seq_len=24, global_batch=8, seed=seed,
                  host_id=host, num_hosts=hosts)
        rs = r_data.make_source(r_data.DataConfig(**kw))
        ts = t_data.make_source(t_data.DataConfig(**kw))
        assert isinstance(ts, t_data.SyntheticLM)
        for step in (0, 3, 1000):
            rb, tb = rs.batch_at(step), ts.batch_at(step)
            assert set(rb) == set(tb) == {"tokens", "labels"}
            for k in rb:
                np.testing.assert_array_equal(tb[k], rb[k])
                assert tb[k].dtype == np.int32


def test_mmap_tokens_are_the_jax_packages(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(2).integers(0, 500, 4001).astype(
        np.int32).tofile(path)
    kw = dict(vocab_size=500, seq_len=32, global_batch=4, seed=3,
              source="mmap", path=str(path))
    rs = r_data.make_source(r_data.DataConfig(**kw))
    ts = t_data.make_source(t_data.DataConfig(**kw))
    assert isinstance(ts, t_data.MmapTokens) and ts.n_windows == 125
    for step in (0, 7):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(ts.batch_at(step)[k],
                                          rs.batch_at(step)[k])
    b = ts.batch_at(1)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    with pytest.raises(ValueError, match="needs a path"):
        t_data.MmapTokens(t_data.DataConfig(vocab_size=5, seq_len=4,
                                            global_batch=1, source="mmap"))
    with pytest.raises(ValueError, match="does not split"):
        t_data.DataConfig(vocab_size=5, seq_len=4, global_batch=3,
                          num_hosts=2).host_batch


def test_prefetcher_resumes_and_propagates_errors():
    src = t_data.make_source(t_data.DataConfig(vocab_size=50, seq_len=8,
                                               global_batch=2, seed=1))
    pf = t_data.Prefetcher(src, start_step=7)
    try:
        step, batch = next(pf)
        assert step == 7
        np.testing.assert_array_equal(batch["tokens"],
                                      src.batch_at(7)["tokens"])
        assert next(pf)[0] == 8
    finally:
        pf.close()

    class Corrupt:
        def batch_at(self, step):
            if step >= 2:
                raise ValueError("corrupt shard")
            return {"tokens": np.zeros((1, 2), np.int32)}

    pf = t_data.Prefetcher(Corrupt(), start_step=0, depth=2)
    got = []
    try:
        with pytest.raises(RuntimeError, match="producer failed") as ei:
            for _ in range(5):
                got.append(next(pf)[0])
        assert got == [0, 1]
        assert isinstance(ei.value.__cause__, ValueError)
    finally:
        pf.close()
    assert not pf.thread.is_alive()


# ----------------------------------------------------------- input specs

@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen2-vl-2b",
                                  "whisper-large-v3", "h2o-danube-3-4b"])
@pytest.mark.parametrize("shape", [TRAIN_4K, PREFILL_32K, DECODE_32K],
                         ids=lambda s: s.name)
def test_input_specs_match(name, shape):
    rspecs = RModel(r_configs.get(name)).input_specs(
        r_configs.ALL_SHAPES[shape.name])
    tspecs = TModel(t_configs.get(name), "cpu").input_specs(shape)

    def flat(tree):
        return {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype)
                                          .replace("torch.", ""))
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat(tspecs) == flat(rspecs)
    leaves = jax.tree_util.tree_leaves(tspecs)
    assert all(t.device.type == "meta" for t in leaves)
    small = TModel(t_configs.get(name), "cpu").input_specs(
        shape, batch_override=3)
    assert all(t.shape[0] == 3 or t.shape[1] == 3
               for t in jax.tree_util.tree_leaves(small))


# ------------------------------------------------------------- launcher

def _train(tmp_path, *args):
    return t_train.main(["--arch", "qwen2-1.5b", "--preset", "smoke",
                         "--device", "cpu", *args])


def test_train_loss_decreases(tmp_path, capsys):
    metrics = tmp_path / "m.json"
    assert _train(tmp_path, "--steps", "40", "--seq-len", "32",
                  "--global-batch", "8", "--lr", "5e-3", "--warmup", "5",
                  "--metrics-out", str(metrics)) == 0
    log = json.loads(metrics.read_text())
    first = np.mean([m["loss"] for m in log[:5]])
    last = np.mean([m["loss"] for m in log[-5:]])
    assert last < first * 0.9, (first, last)
    assert "(improved)" in capsys.readouterr().out


def test_train_checkpoint_resume(tmp_path, capsys):
    import signal
    from repro_torch import checkpoint as ckpt
    ckpt_dir = tmp_path / "ckpt"
    args = ["--seq-len", "32", "--global-batch", "4",
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "5"]
    before = signal.getsignal(signal.SIGTERM)
    assert _train(tmp_path, *args, "--steps", "10") == 0
    # the preemption hook (which holds the state) is gone after the run
    assert signal.getsignal(signal.SIGTERM) == before
    assert ckpt.latest_step(str(ckpt_dir)) == 10
    assert _train(tmp_path, *args, "--steps", "15") == 0
    assert ckpt.latest_step(str(ckpt_dir)) == 15
    out = capsys.readouterr().out
    assert "resumed from step 10" in out
    assert "step    10 loss" in out and "step     9 loss" in out


def test_train_with_grad_compression(tmp_path):
    metrics = tmp_path / "m.json"
    assert _train(tmp_path, "--steps", "30", "--seq-len", "32",
                  "--global-batch", "8", "--lr", "5e-3", "--warmup", "5",
                  "--grad-compression", "int8_ef",
                  "--metrics-out", str(metrics)) == 0
    log = json.loads(metrics.read_text())
    assert log[-1]["loss"] < log[0]["loss"]


@pytest.mark.parametrize("args", [["--mesh", "production"],
                                  ["--data-par", "2"], ["--model-par", "2"]])
def test_train_meshes_are_not_ported_yet(tmp_path, args):
    """Meshes are ported: one process is a world of one rank, so the
    host mesh clamps to 1 x 1 and trains, as the JAX package's clamps to
    its devices, and the 256-rank production mesh is refused."""
    import torch.distributed as dist
    if args[0] == "--mesh":
        with pytest.raises(RuntimeError, match="256"):
            _train(tmp_path, "--steps", "1", *args)
    else:
        _train(tmp_path, "--steps", "1", *args)
    assert not dist.is_initialized()


def test_train_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train.main(["--steps", "1"])


def test_global_norm_clipping_matches():
    rng = np.random.default_rng(8)
    leaves = [np.asarray(rng.standard_normal(s) * 3, np.float32)
              for s in ((4, 5), (7,), ())]
    for max_norm in (0.5, 1e3):
        rg, rn = r_optim.clip_by_global_norm(
            [jnp.asarray(x) for x in leaves], max_norm)
        tg, tn = t_optim.clip_by_global_norm(
            [torch.from_numpy(x) for x in leaves], max_norm)
        assert float(tn) == pytest.approx(float(rn), rel=1e-6)
        assert float(t_optim.global_norm(
            [torch.from_numpy(x) for x in leaves])) == pytest.approx(
                float(r_optim.global_norm([jnp.asarray(x) for x in leaves])),
                rel=1e-6)
        for a, b in zip(tg, rg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    bf16 = torch.full((3,), 1e3, dtype=torch.bfloat16)
    assert float(t_optim.global_norm([bf16])) == pytest.approx(
        1e3 * 3 ** 0.5, rel=1e-6)

"""The port's Mamba-2 SSM and hybrid serving paths against the JAX
package's.

Each model-level test converts a JAX ``Model.init`` tree (numpy leaves)
with ``convert.lm_params_from_numpy`` after overwriting every mamba
layer's ``conv_b``, ``conv_c`` and their biases with seeded non-zero
values in that tree, so both packages run the same weights.  The JAX
package's init makes them zeros, and then B = C = 0 and the SSD term is
exactly 0: a comparison on those weights would pass whatever the scan
computed (``test_the_ssd_term_is_zero_with_the_reference_init``).

The configs are the smoke variants of mamba2-2.7b and zamba2-2.7b
(float32).  Tolerance ``rtol = atol = 1e-5``, as in ``test_torch_lm.py``:
both packages replay the same chunked arithmetic in float32, with their
products and reductions summed in other orders.  Greedy token streams
must be equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.core import telemetry as r_tele
from repro.launch import serve as r_serve
from repro.models import mamba2 as r_mamba2
from repro.models.model import Model as RModel
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.core import telemetry as t_tele
from repro_torch.kernels import ops
from repro_torch.launch import serve as t_serve
from repro_torch.models import mamba2 as t_mamba2
from repro_torch.models import transformer as t_transformer
from repro_torch.models.model import Model as TModel

SSM = ["mamba2-2.7b", "zamba2-2.7b"]
TOL = dict(rtol=1e-5, atol=1e-5)
BC_KEYS = ("conv_b", "conv_c", "conv_bias_b", "conv_bias_c")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **TOL)


def _mamba_tree(cfg, tree):
    """The mamba layers' subtree of a model tree (stacked over layers)."""
    stack = tree["stack"]
    return (stack["mamba_stack"] if cfg.family == "hybrid" else stack)["mamba"]


def _set_bc(tree, rng):
    """Overwrite ``conv_b``/``conv_c`` and their biases with normal * 0.3."""
    for key in BC_KEYS:
        tree[key] = (rng.standard_normal(tree[key].shape) * 0.3).astype(
            np.float32)


@functools.lru_cache(maxsize=None)
def _tree(name):
    """A JAX model tree (numpy leaves) with seeded non-zero B/C convs."""
    cfg = r_configs.get_smoke(name)
    params = RModel(cfg).init(jax.random.key(0))
    tree = jax.tree.map(np.array, params)
    _set_bc(_mamba_tree(cfg, tree), np.random.default_rng(11))
    return tree


def _pair(name):
    """(JAX model, JAX params, port model, port params) of one config."""
    tree = _tree(name)
    tcfg = t_configs.get_smoke(name)
    return (RModel(r_configs.get_smoke(name)),
            jax.tree.map(jnp.asarray, tree), TModel(tcfg, device="cpu"),
            convert.lm_params_from_numpy(tcfg, tree, device="cpu"))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _block(name, rng):
    """One mamba block's parameters (numpy, float32, non-zero B/C) of a
    smoke config, and the same in the port's module."""
    cfg = r_configs.get_smoke(name)
    p = jax.tree.map(np.array, r_mamba2.init_mamba2(cfg, jax.random.key(3)))
    _set_bc(p, rng)
    mod = t_mamba2.Mamba2(t_configs.get_smoke(name))
    convert._fill(mod, p)
    return cfg, p, mod


# ---------------------------------------------------------- the block

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    want, want_st = r_mamba2._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, got_st = t_mamba2._causal_conv(_t(x), _t(w), _t(b),
                                        None if st is None else _t(st))
    _close(got, want)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))


@pytest.mark.parametrize("name", SSM)
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_matches(name, with_state):
    """The block, from zero state or from a seeded state, returning its
    new state; 37 tokens span three 16-position chunks, ragged."""
    rng = np.random.default_rng(4)
    cfg, p, mod = _block(name, rng)
    u = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        zero = r_mamba2.init_mamba_state(cfg, 2, jnp.float32)
        state = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
                 for k, v in zero.items()}
    want_y, want_st = r_mamba2.mamba2_forward(
        cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(u),
        init_state=None if state is None else jax.tree.map(jnp.asarray,
                                                           state),
        return_state=True)
    got_y, got_st = t_mamba2.mamba2_forward(
        t_configs.get_smoke(name), mod, _t(u),
        init_state=None if state is None else {k: _t(v) for k, v in
                                               state.items()},
        return_state=True)
    _close(got_y, want_y, "y")
    for key in want_st:
        _close(got_st[key], want_st[key], key)
    assert got_st["ssm"].dtype == torch.float32


@pytest.mark.parametrize("name", SSM)
def test_decode_step_updates_the_state_in_place(name):
    rng = np.random.default_rng(5)
    cfg, p, mod = _block(name, rng)
    tcfg = t_configs.get_smoke(name)
    u = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    state = t_mamba2.init_mamba_state(tcfg, 3, torch.float32)
    views = dict(state)
    jstate = r_mamba2.init_mamba_state(cfg, 3, jnp.float32)
    for i in range(3):
        want, jstate = r_mamba2.mamba2_decode_step(
            cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(u * (i + 1)),
            jstate)
        got, state = t_mamba2.mamba2_decode_step(tcfg, mod, _t(u * (i + 1)),
                                                 state)
        _close(got, want, f"step {i}")
    for key, v in views.items():
        assert state[key] is v
        _close(v, jstate[key], key)


def test_the_ssd_term_is_zero_with_the_reference_init():
    """With the JAX package's init (zero ``conv_b``/``conv_c``) and D = 0
    the block outputs exactly 0 in both packages: nothing but ``D x``
    reaches the output.  With non-zero B/C the SSD term does."""
    name = "mamba2-2.7b"
    cfg = r_configs.get_smoke(name)
    tcfg = t_configs.get_smoke(name)
    p = jax.tree.map(np.array, r_mamba2.init_mamba2(cfg, jax.random.key(3)))
    p["d_skip"] = np.zeros_like(p["d_skip"])
    u = np.random.default_rng(6).standard_normal(
        (1, 20, cfg.d_model)).astype(np.float32)
    mod = t_mamba2.Mamba2(tcfg)
    convert._fill(mod, p)
    assert not torch.any(t_mamba2.mamba2_forward(tcfg, mod, _t(u)))
    assert not np.any(np.asarray(r_mamba2.mamba2_forward(
        cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(u))))
    _set_bc(p, np.random.default_rng(7))
    convert._fill(mod, p)
    y = t_mamba2.mamba2_forward(tcfg, mod, _t(u))
    assert float(y.abs().max()) > 1e-3
    _close(y, r_mamba2.mamba2_forward(cfg, jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(u)))


def test_init_draws_the_jax_distributions():
    cfg = dataclasses.replace(t_configs.get_smoke("mamba2-2.7b"), d_model=256)
    p = t_mamba2.init_mamba2(cfg, torch.Generator().manual_seed(0))
    assert set(dict(p.named_parameters())) == set(
        r_mamba2.init_mamba2(r_configs.get_smoke("mamba2-2.7b"),
                             jax.random.key(0)))
    assert abs(p.w_x.std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert abs(p.w_out.std().item() - 512 ** -0.5) < 0.1 * 512 ** -0.5
    assert abs(p.conv_x.std().item() - 0.1) < 0.02
    for w in (p.conv_b, p.conv_c, p.conv_bias_x, p.conv_bias_b,
              p.conv_bias_c, p.dt_bias):
        assert not w.any()
    np.testing.assert_allclose(p.a_log.numpy(),
                               np.log(np.linspace(1.0, 16.0, 32)), rtol=1e-6)
    assert bool((p.d_skip == 1).all()) and bool((p.gate_norm == 1).all())
    assert p.a_log.dtype == torch.float32 and p.w_x.dtype == torch.float32
    assert not any(w.requires_grad for w in p.parameters())


# ---------------------------------------------------------- the model

@pytest.mark.parametrize("name", SSM)
def test_model_init_and_cache_shapes_match(name):
    cfg = t_configs.get_smoke(name)
    model = TModel(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tree = _tree(name)
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert sum(p.numel() for p in params.parameters()) == sum(
        np.asarray(v).size for v in flat.values())
    want = jax.tree.map(lambda a: a.shape,
                        RModel(r_configs.get_smoke(name)).init_cache(3, 20))
    got = model.init_cache(3, 20)
    assert jax.tree.map(lambda a: tuple(a.shape), got) == want
    flat_got = jax.tree.leaves(got)
    assert all(not v.any() for v in flat_got)


@pytest.mark.parametrize("name", SSM)
def test_forward_matches(name):
    rm, rp, tm, tp = _pair(name)
    toks = _tokens(rm.cfg, (2, 37))
    _close(tm.forward(tp, {"tokens": _t(toks)}),
           rm.forward(rp, {"tokens": jnp.asarray(toks)}))


def _prefill_both(rm, rp, tm, tp, toks, cache_len):
    want, rcache = rm.prefill(rp, {"tokens": jnp.asarray(toks)}, cache_len)
    got, tcache = tm.prefill(tp, {"tokens": _t(toks)}, cache_len)
    _close(got, want, "logits")
    got_leaves = jax.tree_util.tree_flatten_with_path(tcache)[0]
    want_leaves = dict(jax.tree_util.tree_flatten_with_path(rcache)[0])
    assert [k for k, _ in got_leaves] == list(want_leaves)
    for path, v in got_leaves:
        assert tuple(v.shape) == want_leaves[path].shape, path
        _close(v, want_leaves[path], jax.tree_util.keystr(path))
    return want, rcache, tcache


@pytest.mark.parametrize("name", SSM)
def test_prefill_and_decode_steps_match(name):
    """A 37-token prefill, then 5 greedy decode steps, comparing the
    logits of every step and, at the end, the whole cache."""
    rm, rp, tm, tp = _pair(name)
    toks = _tokens(rm.cfg, (2, 37))
    want, rcache, tcache = _prefill_both(rm, rp, tm, tp, toks, 48)
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    lengths = np.full((2,), 37, np.int32)
    for i in range(5):
        batch = {"tokens": tok, "lengths": lengths}
        want, rcache = rm.decode_step(
            rp, {k: jnp.asarray(v) for k, v in batch.items()}, rcache)
        got, tcache = tm.decode_step(tp, {k: _t(v) for k, v in batch.items()},
                                     tcache)
        _close(got, want, f"step {i}")
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(
            np.int32)
        lengths = lengths + 1
    for path, v in jax.tree_util.tree_flatten_with_path(tcache)[0]:
        _close(v, dict(jax.tree_util.tree_flatten_with_path(rcache)[0])[path],
               jax.tree_util.keystr(path))


def test_ssm_prefill_ignores_cache_len_and_hybrid_checks_it():
    """The JAX ``stack_prefill`` ignores ``cache_len`` for an ssm model;
    a hybrid model's shared attention needs it to hold the prompt."""
    rm, rp, tm, tp = _pair("mamba2-2.7b")
    toks = _tokens(rm.cfg, (1, 20))
    ops.reset_launch_counts()
    _prefill_both(rm, rp, tm, tp, toks, 8)
    assert ops.launch_counts()["ssd_scan"] == 0  # CPU: the plain version
    _, _, tm, tp = _pair("zamba2-2.7b")
    with pytest.raises(ValueError, match="cache_len 8"):
        tm.prefill(tp, {"tokens": _t(toks)}, 8)


def test_hybrid_groups_must_divide_the_layers():
    cfg = dataclasses.replace(t_configs.get_smoke("zamba2-2.7b"), n_layers=5)
    with pytest.raises(ValueError, match="hybrid_attn_every"):
        TModel(cfg, device="cpu").init_cache(1, 8)
    assert t_transformer.hybrid_groups(t_configs.get_smoke("zamba2-2.7b")) \
        == (2, 2)


# -------------------------------------------------------------- server

def _serve(server_mod, model, params, reqs, slots, cache_len, **kw):
    server = server_mod.Server(model, params, slots, cache_len, **kw)
    if server_mod is r_serve:
        # see tests/test_torch_lm.py::_serve: wait for each JAX decode so
        # that it reads the lengths it was called with
        decode = server._decode
        server._decode = lambda *a: jax.block_until_ready(decode(*a))
    for r in reqs:
        server.submit(r)
    steps = 0
    while server.busy:
        server.step()
        steps += 1
        assert steps < 500
    return server


@pytest.mark.parametrize("name", SSM)
def test_server_streams_match_jax(name):
    """Five requests on two slots: admission, the token-by-token prompt
    feed and slot reuse.  As in the JAX package, a reused slot keeps the
    previous request's SSM and conv states and idle slots advance on
    token 0; the streams must still be equal to the JAX server's."""
    rm, rp, tm, tp = _pair(name)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, rm.cfg.vocab_size, 6) for _ in range(5)]
    lens = [9, 4, 9, 3, 9]
    r_reqs = [r_serve.Request(i, p, n) for i, (p, n) in
              enumerate(zip(prompts, lens))]
    t_reqs = [t_serve.Request(i, p, n) for i, (p, n) in
              enumerate(zip(prompts, lens))]
    r_srv = _serve(r_serve, rm, rp, r_reqs, 2, 32,
                   registry=r_tele.MetricsRegistry(), tracer=r_tele.Tracer())
    t_srv = _serve(t_serve, tm, tp, t_reqs, 2, 32,
                   registry=t_tele.MetricsRegistry(), tracer=t_tele.Tracer())
    assert [r.output for r in t_reqs] == [r.output for r in r_reqs]
    assert [len(r.output) for r in t_reqs] == lens
    want, got = r_srv.stats(), t_srv.stats()
    for key in ("rejected", "expired", "queued", "active", "tokens"):
        assert got[key] == want[key], key
    ssm = t_srv.cache["ssm"] if name == "mamba2-2.7b" else \
        t_srv.cache["mamba"]["ssm"]
    assert bool(ssm.abs().sum() > 0)


def test_a_reused_slot_keeps_the_previous_requests_state():
    """The reference never resets an SSM slot.  On a one-slot server
    (no idle slots), a request served after another ends in a state other
    than the one it reaches served alone: a reset at admission would
    make them equal.  The port's tokens and state are the JAX server's."""
    rm, rp, tm, tp = _pair("mamba2-2.7b")
    rng = np.random.default_rng(8)
    first, second = (rng.integers(0, rm.cfg.vocab_size, 6) for _ in range(2))

    def run(server_mod, model, params, prompts):
        reqs = [server_mod.Request(i, p, 6) for i, p in enumerate(prompts)]
        tele = r_tele if server_mod is r_serve else t_tele
        srv = _serve(server_mod, model, params, reqs, 1, 32,
                     registry=tele.MetricsRegistry(), tracer=tele.Tracer())
        return [r.output for r in reqs], np.asarray(srv.cache["ssm"])

    t_alone, t_alone_ssm = run(t_serve, tm, tp, [second])
    t_after, t_after_ssm = run(t_serve, tm, tp, [first, second])
    r_alone, _ = run(r_serve, rm, rp, [second])
    r_after, r_after_ssm = run(r_serve, rm, rp, [first, second])
    assert t_alone == r_alone and t_after == r_after
    np.testing.assert_allclose(t_after_ssm, r_after_ssm, **TOL)
    assert not np.allclose(t_after_ssm, t_alone_ssm)


@pytest.mark.parametrize("arch", SSM)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    assert t_serve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                         "--slots", "2", "--max-new", "4",
                         "--prompt-len", "4"]) == 0
    assert "served 3 requests on cpu, 12 tokens" in capsys.readouterr().out

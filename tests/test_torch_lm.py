"""The port's dense-LM serving path against the JAX package's.

Each test converts a JAX ``Model.init`` tree (numpy leaves) with
``convert.lm_params_from_numpy``, feeds both packages the same numpy
inputs and compares.  The configs are the smoke variants of the five
dense models (float32); ``test_torch_families.py`` holds the MoE, VLM
and encoder-decoder families.  Tolerance ``rtol = atol = 1e-5``, as in
``test_torch_float.py``: both packages compute in float32, with their
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
from repro.launch import serve as r_serve
from repro.models import layers as r_layers
from repro.models.model import Model as RModel
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.core import telemetry as t_tele
from repro_torch.kernels import ops
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_transformer
from repro_torch.models.model import Model as TModel

DENSE = ["qwen2-1.5b", "qwen3-4b", "qwen2.5-32b", "h2o-danube-3-4b",
         "lm100m"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **TOL)


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The JAX model's parameters and their numpy tree (float32)."""
    params = RModel(r_configs.get_smoke(name)).init(jax.random.key(0))
    return params, jax.tree.map(np.asarray, params)


def _pair(name, **overrides):
    """(JAX model, JAX params, port model, port params) of one config."""
    params, tree = _jax_init(name)
    rcfg = dataclasses.replace(r_configs.get_smoke(name), **overrides)
    tcfg = dataclasses.replace(t_configs.get_smoke(name), **overrides)
    return (RModel(rcfg), params, TModel(tcfg, device="cpu"),
            convert.lm_params_from_numpy(tcfg, tree, device="cpu"))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("name", sorted(r_configs._MODULES)
                         + sorted(r_configs._EXTRAS))
def test_config_registry_matches(name):
    assert dataclasses.asdict(t_configs.get(name)) == \
        dataclasses.asdict(r_configs.get(name))
    assert dataclasses.asdict(t_configs.get_smoke(name)) == \
        dataclasses.asdict(r_configs.get_smoke(name))
    assert t_configs.get(name).param_count() == \
        r_configs.get(name).param_count()


# -------------------------------------------------------------- layers

def test_norms_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    _close(t_layers.rms_norm(_t(x), _t(scale), 1e-6),
           r_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    _close(t_layers.layer_norm(_t(x), _t(scale), _t(bias), 1e-5),
           r_layers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(bias), 1e-5))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 200, (2, 7)).astype(np.int32)
    _close(t_layers.apply_rope(_t(x), _t(pos), theta),
           r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    pos3 = rng.integers(0, 200, (3, 2, 7)).astype(np.int32)
    _close(t_layers.apply_mrope(_t(x), _t(pos3), theta),
           r_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta))


# (causal, window, q_offset, Sq, Skv, chunk)
ATTN = [(True, None, 0, 12, 12, 5), (True, 6, 0, 12, 12, 4),
        (False, None, 0, 9, 21, 8), (True, 5, 11, 4, 15, 4)]


@pytest.mark.parametrize("causal,window,q_offset,sq,skv,chunk", ATTN)
def test_chunked_and_naive_attention_match(causal, window, q_offset, sq,
                                           skv, chunk):
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, skv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, skv, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(t_layers.chunked_attention(_t(q), _t(k), _t(v), chunk=chunk, **kw),
           r_layers.chunked_attention(jq, jk, jv, chunk=chunk, **kw))
    _close(t_layers.naive_attention(_t(q), _t(k), _t(v), **kw),
           r_layers.naive_attention(jq, jk, jv, **kw))


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches(window):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 4, 1, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 2, 20, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 2, 20, 16)).astype(np.float32)
    lengths = np.array([1, 9, 20], np.int32)
    _close(t_layers.decode_attention(_t(q), _t(kc), _t(vc), _t(lengths),
                                     window),
           r_layers.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                     jnp.asarray(vc), jnp.asarray(lengths),
                                     window))


@pytest.mark.parametrize("lengths", [np.int32(3), np.int32(19),
                                     np.array([0, 18, 25], np.int32)],
                         ids=["scalar", "scalar_clamped", "per_slot_clamped"])
def test_update_kv_cache_clamps_as_dynamic_update_slice(lengths):
    rng = np.random.default_rng(3)
    kc = rng.standard_normal((3, 2, 20, 4)).astype(np.float32)
    new = rng.standard_normal((3, 2, 2, 4)).astype(np.float32)
    if np.ndim(lengths) == 0:
        want = jax.lax.dynamic_update_slice(kc, new, (0, 0, lengths, 0))
    else:
        want = jax.vmap(lambda c, n, p: jax.lax.dynamic_update_slice(
            c, n, (0, p, 0)))(kc, new, lengths)
    want = np.asarray(want)
    got, _ = t_transformer.update_kv_cache(_t(kc.copy()), _t(kc.copy()),
                                           _t(new), _t(new), _t(lengths))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------- the model

def test_init_draws_the_jax_distributions():
    cfg = t_configs.get_smoke("qwen2-1.5b")
    model = TModel(dataclasses.replace(cfg, d_model=256, d_ff=512),
                   device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    layer = params.stack[0]
    assert params.lm_head is None and params.embed.shape == (256, 256)
    assert abs(params.embed.std().item() - 0.02) < 0.002
    assert abs(layer.attn.wq.std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert abs(layer.mlp.w_down.std().item() - 512 ** -0.5) \
        < 0.1 * 512 ** -0.5
    assert not layer.attn.bq.any() and bool((layer.norm1.scale == 1).all())
    assert not any(p.requires_grad for p in params.parameters())
    again = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(again.stack[1].attn.wo, params.stack[1].attn.wo)
    _, tree = _jax_init("qwen2-1.5b")
    full = TModel(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    shapes = {n: tuple(p.shape) for n, p in full.named_parameters()}
    assert shapes["embed"] == tree["embed"].shape
    assert shapes["stack.1.attn.wq"] == tree["stack"]["attn"]["wq"].shape[1:]


@pytest.mark.parametrize("name", DENSE)
def test_forward_matches(name):
    rm, rp, tm, tp = _pair(name)
    toks = _tokens(rm.cfg, (2, 12))
    _close(tm.forward(tp, {"tokens": _t(toks)}),
           rm.forward(rp, {"tokens": jnp.asarray(toks)}))


@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
@pytest.mark.parametrize("name", DENSE)
def test_prefill_matches(name, impl):
    """``flash`` runs the JAX package's Pallas kernel in interpret mode
    and the port's ``ops.flash_attention`` on the CPU; ``chunked`` takes
    chunks of 8 so that the 12-token prompt spans two."""
    rm, rp, tm, tp = _pair(name, attention_impl=impl, attention_chunk=8)
    toks = _tokens(rm.cfg, (2, 12))
    want, wcache = rm.prefill(rp, {"tokens": jnp.asarray(toks)}, 16)
    got, gcache = tm.prefill(tp, {"tokens": _t(toks)}, 16)
    _close(got, want, "logits")
    for key in ("k", "v"):
        assert gcache[key].shape == wcache[key].shape
        _close(gcache[key], wcache[key], key)


def _decode_both(rm, rp, tm, tp, rcache, tcache, tok, lengths, steps):
    """Greedy decode ``steps`` tokens in both packages from their caches,
    comparing the logits of every step."""
    for i in range(steps):
        batch = {"tokens": tok, "lengths": lengths}
        want, rcache = rm.decode_step(
            rp, {k: jnp.asarray(v) for k, v in batch.items()}, rcache)
        got, tcache = tm.decode_step(
            tp, {k: _t(v) for k, v in batch.items()}, tcache)
        _close(got, want, f"step {i}")
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
        lengths = lengths + 1


@pytest.mark.parametrize("name", DENSE)
def test_decode_steps_after_prefill_match(name):
    rm, rp, tm, tp = _pair(name, attention_impl="flash")
    toks = _tokens(rm.cfg, (2, 10))
    want, rcache = rm.prefill(rp, {"tokens": jnp.asarray(toks)}, 40)
    _, tcache = tm.prefill(tp, {"tokens": _t(toks)}, 40)
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    _decode_both(rm, rp, tm, tp, rcache, tcache, tok,
                 np.full((2,), 10, np.int32), 4)


def test_decode_with_a_scalar_length_matches():
    rm, rp, tm, tp = _pair("qwen3-4b")
    toks = _tokens(rm.cfg, (2, 6))
    want, rcache = rm.prefill(rp, {"tokens": jnp.asarray(toks)}, 12)
    _, tcache = tm.prefill(tp, {"tokens": _t(toks)}, 12)
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    _decode_both(rm, rp, tm, tp, rcache, tcache, tok, np.int32(6), 3)


def test_h2o_ring_buffer_decode_matches():
    """h2o's smoke window is 32: a 24-token prefill into a 32-slot cache
    (the window's size) makes the decode steps write a ring buffer, and
    12 steps wrap it."""
    rm, rp, tm, tp = _pair("h2o-danube-3-4b", attention_impl="flash")
    assert rm.cfg.sliding_window == 32
    toks = _tokens(rm.cfg, (2, 24))
    want, rcache = rm.prefill(rp, {"tokens": jnp.asarray(toks)}, 32)
    _, tcache = tm.prefill(tp, {"tokens": _t(toks)}, 32)
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    _decode_both(rm, rp, tm, tp, rcache, tcache, tok,
                 np.full((2,), 24, np.int32), 12)
    assert tm.init_cache(2, 100)["k"].shape[3] == 32


def test_prefill_launch_count_and_cache_length_checks():
    _, _, tm, tp = _pair("lm100m", attention_impl="flash")
    toks = _tokens(tm.cfg, (1, 8))
    ops.reset_launch_counts()
    tm.prefill(tp, {"tokens": _t(toks)}, 8)
    assert ops.launch_counts()["flash_attention"] == 0  # CPU: plain version
    with pytest.raises(ValueError, match="cache_len 7"):
        tm.prefill(tp, {"tokens": _t(toks)}, 7)


# -------------------------------------------------------------- server

def _serve(server_mod, model, params, reqs, slots, cache_len, **kw):
    server = server_mod.Server(model, params, slots, cache_len, **kw)
    if server_mod is r_serve:
        # The JAX server hands ``jnp.asarray(self.lengths)`` to an
        # asynchronous decode and then increments ``self.lengths`` in
        # place; on the CPU ``jnp.asarray`` aliases the numpy buffer, so
        # the decode may read the incremented lengths.  Waiting for each
        # decode before returning gives the lengths it was called with.
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


@pytest.mark.parametrize("name,prompt,max_new", [
    ("qwen2-1.5b", 8, 10), ("h2o-danube-3-4b", 12, 28)],
    ids=["qwen2-1.5b", "h2o-danube-3-4b_ring"])
def test_server_streams_match_jax(name, prompt, max_new):
    """Five requests on two slots: admission, the token-by-token prompt
    feed, slot reuse and (for h2o, cache 64 over a 32-token window) the
    ring buffer.  The greedy streams must be equal."""
    rm, rp, tm, tp = _pair(name)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, rm.cfg.vocab_size, prompt) for _ in range(5)]
    lens = [max_new, max_new // 2, max_new, 3, max_new]
    r_reqs = [r_serve.Request(i, p, n) for i, (p, n) in
              enumerate(zip(prompts, lens))]
    t_reqs = [t_serve.Request(i, p, n) for i, (p, n) in
              enumerate(zip(prompts, lens))]
    import repro.core.telemetry as r_tele
    r_srv = _serve(r_serve, rm, rp, r_reqs, 2, 64,
                   registry=r_tele.MetricsRegistry(), tracer=r_tele.Tracer())
    t_srv = _serve(t_serve, tm, tp, t_reqs, 2, 64,
                   registry=t_tele.MetricsRegistry(), tracer=t_tele.Tracer())
    assert [r.output for r in t_reqs] == [r.output for r in r_reqs]
    assert [len(r.output) for r in t_reqs] == lens
    want, got = r_srv.stats(), t_srv.stats()
    for key in ("rejected", "expired", "queued", "active", "tokens"):
        assert got[key] == want[key], key
    assert got["latency_s"]["count"] == 5


def test_server_sheds_past_the_queue_bound_and_expires_deadlines():
    _, _, tm, tp = _pair("lm100m")
    server = t_serve.Server(tm, tp, 1, 32, max_queue=2,
                            registry=t_tele.MetricsRegistry(),
                            tracer=t_tele.Tracer())
    reqs = [t_serve.Request(i, np.arange(4), 4) for i in range(3)]
    late = t_serve.Request(3, np.arange(4), 4, deadline_s=0.0)
    assert [server.submit(r) for r in reqs] == [True, True, False]
    server.queue.append(late)
    late.submitted_at = 0.0
    while server.busy:
        server.step()
    assert reqs[2].rejected and late.expired
    stats = server.stats()
    assert (stats["rejected"], stats["expired"], stats["tokens"]) == (1, 1, 8)
    assert server.record_guard_report("clean") == "clean"
    with pytest.raises(ValueError, match="unknown guard outcome"):
        server.record_guard_report("lost")


def test_serve_cli_runs_on_the_cpu(capsys):
    assert t_serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                         "--max-new", "4", "--prompt-len", "4"]) == 0
    assert "served 3 requests on cpu, 12 tokens" in capsys.readouterr().out

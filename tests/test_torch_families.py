"""The port's MoE, VLM-input and encoder-decoder serving paths against the
JAX package's.

Each model-level test converts a JAX ``Model.init`` tree (numpy leaves)
with ``convert.lm_params_from_numpy``, feeds both packages the same
numpy inputs and compares.  The configs are the smoke variants of
granite-moe-1b-a400m, llama4-scout-17b-a16e (``moe``), qwen2-vl-2b
(``vlm``) and whisper-large-v3 (``encdec``), in float32.  Tolerance
``rtol = atol = 1e-5``, as in ``test_torch_lm.py``: both packages
compute in float32, with their products and reductions summed in other
orders.  MoE routing decisions (expert, queue position, kept or dropped)
must be equal exactly, and greedy token streams too.
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
from repro.models import layers as r_layers
from repro.models.model import Model as RModel
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.core import telemetry as t_tele
from repro_torch.kernels import ops
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as t_layers
from repro_torch.models.model import Model as TModel

MOE = ["granite-moe-1b-a400m", "llama4-scout-17b-a16e"]
FAMILIES = MOE + ["qwen2-vl-2b", "whisper-large-v3"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **TOL)


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The JAX model's parameters and their numpy tree (float32)."""
    params = RModel(r_configs.get_smoke(name)).init(jax.random.key(0))
    return params, jax.tree.map(np.asarray, params)


def _pair(name, **overrides):
    """(JAX model, JAX params, port model, port params) of one config;
    ``overrides`` change no parameter shape."""
    params, tree = _jax_init(name)
    rcfg = dataclasses.replace(r_configs.get_smoke(name), **overrides)
    tcfg = dataclasses.replace(t_configs.get_smoke(name), **overrides)
    return (RModel(rcfg), params, TModel(tcfg, device="cpu"),
            convert.lm_params_from_numpy(tcfg, tree, device="cpu"))


def _mrope_positions(bsz, seq, rng):
    """Seeded (3, B, S) M-RoPE ids whose three components differ."""
    return rng.integers(0, 3 * seq, (3, bsz, seq)).astype(np.int32)


def _batch(cfg, bsz, seq, seed=1, positions=True):
    """Prefill inputs: tokens or embeds; seeded three-component positions
    with M-RoPE; an encoder-decoder's ``audio_embeds``."""
    rng = np.random.default_rng(seed)
    if cfg.input_embeds:
        b = {"embeds": rng.standard_normal(
            (bsz, seq, cfg.d_model)).astype(np.float32)}
    else:
        b = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (bsz, seq)).astype(np.int32)}
    if cfg.mrope and positions:
        b["positions"] = _mrope_positions(bsz, seq, rng)
    if cfg.family == "encdec":
        b["audio_embeds"] = rng.standard_normal(
            (bsz, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


# ------------------------------------------------------------------ moe

def _reference_routing(cfg, router, xt):
    """The JAX package's routing decisions of xt (G, Tg, D), in its own
    operations (``repro/models/layers.py:moe``): per (token, slot) the
    expert, the queue position and whether the slot was kept."""
    g, tg, _ = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(router), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    capacity = min(tg * k, max(1, int(cfg.capacity_factor * k * tg / e)))
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    flat = onehot.reshape(g, tg * k, e)
    pos = (jnp.cumsum(flat, axis=1) * flat - 1.0).reshape(g, tg, k, e)
    keep = (pos >= 0) & (pos < capacity)
    return (np.asarray(idx), np.asarray(pos.max(-1)).astype(np.int64),
            np.asarray(keep.any(-1)), capacity)


def _moe_pair(name, cf, group=0, zero_router=False, seq=12):
    cfg = dataclasses.replace(r_configs.get_smoke(name), capacity_factor=cf,
                              moe_group_size=group)
    p = jax.tree.map(np.asarray, r_layers.init_moe(cfg, jax.random.key(3)))
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    tcfg = dataclasses.replace(t_configs.get_smoke(name), capacity_factor=cf,
                               moe_group_size=group)
    tp = t_layers.MoE(tcfg)
    for key, arr in p.items():
        getattr(tp, key).data.copy_(_t(arr))
    x = np.random.default_rng(5).standard_normal(
        (2, seq, cfg.d_model)).astype(np.float32)
    return cfg, p, tcfg, tp, x


@pytest.mark.parametrize("cf,group", [(8.0, 0), (1.25, 0), (1.25, 4)],
                         ids=["dropless", "drops", "drops_groups_of_4"])
@pytest.mark.parametrize("name", MOE)
def test_moe_matches_the_reference(name, cf, group):
    """Output and aux loss within 1e-5; the routing equal exactly.
    Capacity factor 8.0 is dropless at the smoke shapes, 1.25 drops, and
    a group size of 4 routes the 12-token rows in three groups."""
    cfg, p, tcfg, tp, x = _moe_pair(name, cf, group)
    want_y, want_aux = r_layers.moe(cfg, p, jnp.asarray(x))
    got_y, got_aux = t_layers.moe(tcfg, tp, _t(x))
    _close(got_y, want_y, "y")
    _close(got_aux, want_aux, "aux")
    tg = t_layers.moe_group_size(tcfg, x.shape[1])
    assert tg == (group or x.shape[1])
    xt = x.reshape(-1, tg, x.shape[2])
    idx, pos, kept, cap = _reference_routing(cfg, p["router"], xt)
    r = t_layers.moe_routing(tcfg, tp.router, _t(xt))
    assert r.capacity == cap
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    np.testing.assert_array_equal(r.pos.numpy()[kept], pos[kept])
    assert bool(kept.all()) == (cf == 8.0)


@pytest.mark.parametrize("name", MOE)
def test_zero_router_ties_go_to_the_lower_experts(name):
    """A zero router makes every probability equal: ``jax.lax.top_k``
    then picks experts 0..k-1 for every token, and those queues overflow
    (capacity 7 of 12 tokens at granite's smoke shape)."""
    cfg, p, tcfg, tp, x = _moe_pair(name, 1.25, zero_router=True)
    want_y, want_aux = r_layers.moe(cfg, p, jnp.asarray(x))
    got_y, got_aux = t_layers.moe(tcfg, tp, _t(x))
    _close(got_y, want_y, "y")
    _close(got_aux, want_aux, "aux")
    r = t_layers.moe_routing(tcfg, tp.router, _t(x))
    k = cfg.top_k
    assert (r.idx == torch.arange(k)).all()
    idx, pos, kept, cap = _reference_routing(cfg, p["router"], x)
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    assert int((~r.kept).sum()) == 2 * k * (12 - cap) > 0


def test_topk_tie_rule_is_pinned_at_a_partial_tie():
    """Ties among some experts only, with larger ones around them: the
    tie goes to the lower index, as ``jax.lax.top_k`` gives it."""
    cfg = dataclasses.replace(t_configs.get_smoke("granite-moe-1b-a400m"),
                              n_experts=6, top_k=3, capacity_factor=8.0)
    router = torch.zeros((cfg.d_model, 6))
    router[0] = torch.tensor([0.0, 1.0, 0.5, 1.0, 0.5, 1.0])
    xt = torch.zeros((1, 2, cfg.d_model))
    xt[0, :, 0] = torch.tensor([1.0, -1.0])
    r = t_layers.moe_routing(cfg, router, xt)
    _, want = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(xt.numpy()) @ jnp.asarray(router.numpy()), -1), 3)
    assert r.idx.tolist() == [[[1, 3, 5], [0, 2, 4]]]
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(want))


def test_bf16_model_keeps_the_router_float32():
    """``init`` and the converter keep the router float32 in a bf16
    model, as the JAX package's ``init_moe`` does; the experts take the
    model's dtype, and granite's head stays tied to ``embed``."""
    cfg = dataclasses.replace(t_configs.get_smoke("granite-moe-1b-a400m"),
                              dtype="bfloat16")
    model = TModel(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    moe = params.stack[0].moe
    assert moe.router.dtype == torch.float32
    assert moe.w_gate.dtype == moe.w_down.dtype == torch.bfloat16
    assert params.lm_head is None and params.stack[0].mlp is None
    assert abs(moe.router.std().item() - cfg.d_model ** -0.5) \
        < 0.15 * cfg.d_model ** -0.5
    rcfg = dataclasses.replace(r_configs.get_smoke("granite-moe-1b-a400m"),
                               dtype="bfloat16")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        RModel(rcfg).init(jax.random.key(0)))
    conv = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    assert conv.stack[1].moe.router.dtype == torch.float32
    np.testing.assert_array_equal(conv.stack[1].moe.router.numpy(),
                                  tree["stack"]["moe"]["router"][1])
    toks = np.arange(8, dtype=np.int32).reshape(1, 8)
    logits, _ = model.prefill(params, {"tokens": _t(toks)}, 8)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(
        logits.float()).all()


# ----------------------------------------------------------- the models

@pytest.mark.parametrize("name", sorted(t_configs._MODULES)
                         + sorted(t_configs._EXTRAS))
def test_model_accepts_every_config(name):
    """Every config of the registry builds a ``Model``; the smoke
    variant's parameters have the JAX package's tree shapes."""
    TModel(t_configs.get(name), device="cpu")
    cfg = t_configs.get_smoke(name)
    shapes = jax.eval_shape(RModel(r_configs.get_smoke(name)).init,
                            jax.random.key(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    params = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    got = TModel(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert {n: p.shape for n, p in got.named_parameters()} == \
        {n: p.shape for n, p in params.named_parameters()}


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches(name):
    """Logits of every position, and a MoE stack's summed aux loss kept
    as ``_last_aux`` (0 for the VLM's dense stack, none for whisper)."""
    rm, rp, tm, tp = _pair(name)
    jb, tb = _both(_batch(rm.cfg, 2, 12))
    want = rm.forward(rp, jb)
    _close(tm.forward(tp, tb), want, "logits")
    if rm.cfg.family == "encdec":
        assert not hasattr(tm, "_last_aux")
    else:
        _close(torch.as_tensor(tm._last_aux), rm._last_aux, "aux")
        assert (float(tm._last_aux) > 0) == (rm.cfg.family == "moe")


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_matches(name, impl):
    """``flash`` runs the JAX package's Pallas kernel in interpret mode
    and the port's ``ops.flash_attention`` on the CPU (its plain
    version).  The cache, ``xk``/``xv`` included, must match too."""
    rm, rp, tm, tp = _pair(name, attention_impl=impl)
    jb, tb = _both(_batch(rm.cfg, 2, 12))
    want, wcache = rm.prefill(rp, jb, 16)
    ops.reset_launch_counts()
    got, gcache = tm.prefill(tp, tb, 16)
    assert ops.launch_counts()["flash_attention"] == 0  # CPU: plain version
    _close(got, want, "logits")
    assert sorted(gcache) == sorted(wcache)
    for key in wcache:
        assert tuple(gcache[key].shape) == wcache[key].shape, key
        _close(gcache[key], wcache[key], key)


def _decode_both(rm, rp, tm, tp, rcache, tcache, first, lengths, steps,
                 seed=9):
    """Greedy decode ``steps`` tokens in both packages from their caches
    (a VLM is fed seeded embeddings), comparing every step's logits."""
    rng = np.random.default_rng(seed)
    tok = first
    for i in range(steps):
        if rm.cfg.input_embeds:
            batch = {"embeds": rng.standard_normal(
                (len(tok), 1, rm.cfg.d_model)).astype(np.float32)}
        else:
            batch = {"tokens": tok}
        batch["lengths"] = lengths
        jb, tb = _both(batch)
        want, rcache = rm.decode_step(rp, jb, rcache)
        got, tcache = tm.decode_step(tp, tb, tcache)
        _close(got, want, f"step {i}")
        tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
        lengths = lengths + 1
    return rcache, tcache


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("name", FAMILIES)
def test_decode_steps_after_prefill_match(name, impl):
    """Four greedy steps after a 10-token prefill: MoE routes each step's
    rows as groups of one token; whisper's cross-attention reads the
    prefill's ``xk``/``xv`` (through ``run_attention``, so the flash
    kernel on the card)."""
    rm, rp, tm, tp = _pair(name, attention_impl=impl)
    jb, tb = _both(_batch(rm.cfg, 2, 10))
    want, rcache = rm.prefill(rp, jb, 24)
    _, tcache = tm.prefill(tp, tb, 24)
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    rcache, tcache = _decode_both(rm, rp, tm, tp, rcache, tcache, tok,
                                  np.full((2,), 10, np.int32), 4)
    for key in rcache:
        _close(tcache[key], rcache[key], key)


@pytest.mark.parametrize("name", MOE)
def test_moe_decode_with_a_scalar_length_matches(name):
    rm, rp, tm, tp = _pair(name)
    jb, tb = _both(_batch(rm.cfg, 3, 6))
    want, rcache = rm.prefill(rp, jb, 12)
    _, tcache = tm.prefill(tp, tb, 12)
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    _decode_both(rm, rp, tm, tp, rcache, tcache, tok, np.int32(6), 3)


# ------------------------------------------------------------------ vlm

def test_vlm_default_positions_broadcast_to_three_components():
    """Without ``positions`` both packages broadcast ``arange`` to (3, B,
    S); seeded three-component ids give other logits."""
    rm, rp, tm, tp = _pair("qwen2-vl-2b")
    b = _batch(rm.cfg, 2, 12, positions=False)
    jb, tb = _both(b)
    want = rm.forward(rp, jb)
    _close(tm.forward(tp, tb), want)
    assert tuple(tm._positions(tb, 12, 2).shape) == (3, 2, 12)
    b["positions"] = _mrope_positions(2, 12, np.random.default_rng(4))
    jb, tb = _both(b)
    other = rm.forward(rp, jb)
    _close(tm.forward(tp, tb), other)
    assert np.abs(np.asarray(other) - np.asarray(want)).max() > 1e-3


def test_vlm_has_no_embed_table_and_refuses_tokens():
    """With ``input_embeds`` the JAX package keeps no ``embed`` (the head
    is ``lm_head``), so a batch of tokens fails in both packages."""
    rm, rp, tm, tp = _pair("qwen2-vl-2b")
    assert "embed" not in rp and tp.embed is None
    assert tp.lm_head is not None
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(KeyError):
        rm.forward(rp, {"tokens": jnp.asarray(toks)})
    with pytest.raises(KeyError, match="embed"):
        tm.forward(tp, {"tokens": _t(toks)})


# -------------------------------------------------------------- whisper

@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_whisper_ragged_encoder_matches(impl):
    """A 20-frame encoder (off every power of two): prefill, ``xk``/
    ``xv`` of 20 rows, and decode steps over them."""
    rm, rp, tm, tp = _pair("whisper-large-v3", attention_impl=impl,
                           encoder_seq=20)
    jb, tb = _both(_batch(rm.cfg, 2, 7))
    want, rcache = rm.prefill(rp, jb, 12)
    got, tcache = tm.prefill(tp, tb, 12)
    _close(got, want)
    assert tcache["xk"].shape[3] == 20
    assert tuple(tm.init_cache(2, 12)["xv"].shape) == rcache["xv"].shape
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    _decode_both(rm, rp, tm, tp, rcache, tcache, tok,
                 np.array([7, 5], np.int32), 3)


def test_whisper_decoder_positions_pad_in_prefill_and_clamp_in_decode():
    """Past the 8192-row table a prefill adds zeros and a decode step
    the last row (the JAX package's two behaviours, kept): decode steps
    at fills 8191-8194 on a 16-slot cache (its writes clamp to the last
    slot, as ``dynamic_update_slice`` clamps) match the reference."""
    rm, rp, tm, tp = _pair("whisper-large-v3")
    pos = tm._dec_pos(tp, 8200)
    _close(pos, rm._dec_pos(rp, 8200))
    assert not pos[8192:].any() and pos[8191].abs().sum() > 0
    jb, tb = _both(_batch(rm.cfg, 2, 5))
    want, rcache = rm.prefill(rp, jb, 16)
    _, tcache = tm.prefill(tp, tb, 16)
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    _decode_both(rm, rp, tm, tp, rcache, tcache, tok,
                 np.array([8191, 8192], np.int32), 3)


# --------------------------------------------------------------- server

def _serve(server_mod, model, params, reqs, slots, cache_len, **kw):
    server = server_mod.Server(model, params, slots, cache_len, **kw)
    if server_mod is r_serve:
        # see test_torch_lm.py::_serve: the JAX server's asynchronous
        # decode may read lengths it increments afterwards
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


def test_granite_server_streams_match_jax():
    """Five requests on two slots at the published capacity factor 1.25:
    the token-by-token prompt feed routes each decode row as a group of
    one token (capacity 1 a queue; a token's k slots go to k distinct
    experts, so none drops), unlike a prefill's routing of the same
    prompt.  The greedy streams must be equal."""
    rm, rp, tm, tp = _pair("granite-moe-1b-a400m", capacity_factor=1.25)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, rm.cfg.vocab_size, 6) for _ in range(5)]
    lens = [8, 4, 8, 3, 8]
    r_reqs = [r_serve.Request(i, p, n) for i, (p, n) in
              enumerate(zip(prompts, lens))]
    t_reqs = [t_serve.Request(i, p, n) for i, (p, n) in
              enumerate(zip(prompts, lens))]
    _serve(r_serve, rm, rp, r_reqs, 2, 32, registry=r_tele.MetricsRegistry(),
           tracer=r_tele.Tracer())
    t_srv = _serve(t_serve, tm, tp, t_reqs, 2, 32,
                   registry=t_tele.MetricsRegistry(), tracer=t_tele.Tracer())
    assert [r.output for r in t_reqs] == [r.output for r in r_reqs]
    assert [len(r.output) for r in t_reqs] == lens
    assert t_srv.stats()["tokens"] == sum(lens)


def test_serve_cli_runs_granite_on_the_cpu(capsys):
    assert t_serve.main(["--arch", "granite-moe-1b-a400m", "--preset", "smoke",
                         "--device", "cpu", "--requests", "3", "--slots",
                         "2", "--max-new", "4", "--prompt-len", "4"]) == 0
    assert "served 3 requests on cpu, 12 tokens" in capsys.readouterr().out

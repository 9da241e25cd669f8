"""The port's checkpoints against the JAX package's: the same on-disk
format byte for byte, so that a checkpoint either package writes
restores in the other; the round trip, ``LATEST``, shape checks,
``gc_old`` and the async snapshot; resume equivalence within the port
and across the packages; the train state's conversion."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as r_ckpt
from repro import configs as r_configs
from repro import optim as r_optim
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import make_source as r_make_source
from repro.models.model import Model as RModel
from repro_torch import checkpoint as t_ckpt
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch import optim as t_optim
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.models.model import Model as TModel

import test_torch_train as tt


def make_tree(seed=0):
    """The JAX checkpoint test's tree, as port tensors."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(
            rng.standard_normal((8, 16)).astype(np.float32)),
                   "b": torch.from_numpy(rng.standard_normal(16).astype(
                       np.float32)).to(torch.bfloat16)},
        "opt": {"mu": {"w": torch.zeros(8, 16), "b": torch.ones(16)}},
        "step": torch.tensor(42, dtype=torch.int32),
    }


def jax_tree(tree):
    """The same values as the JAX package's arrays."""
    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())
    return jax.tree.map(conv, tree)


def assert_tree_equal(got, want):
    got_flat, want_flat = t_ckpt._flatten(got), t_ckpt._flatten(want)
    assert set(got_flat) == set(want_flat)
    for k, w in want_flat.items():
        g = got_flat[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


def skeleton(tree):
    return jax.tree.map(lambda t: torch.empty(t.shape, device="meta"), tree,
                        is_leaf=torch.is_tensor)


def test_roundtrip(tmp_path):
    tree = make_tree()
    t_ckpt.save(str(tmp_path), 42, tree, extra={"note": "hi"})
    restored, step, extra = t_ckpt.restore(str(tmp_path), skeleton(tree))
    assert step == 42 and extra["note"] == "hi"
    assert_tree_equal(restored, tree)
    assert restored["params"]["b"].dtype == torch.bfloat16


def test_numpy_scalar_and_empty_leaves(tmp_path):
    tree = {"a": np.arange(6, dtype=np.int64).reshape(2, 3),
            "s": np.float32(2.5), "e": torch.zeros(0, 3)}
    t_ckpt.save(str(tmp_path), 1, tree)
    got, _, _ = t_ckpt.restore(str(tmp_path), tree)
    assert got["a"].dtype == torch.int64 and got["a"].tolist() == [
        [0, 1, 2], [3, 4, 5]]
    assert got["s"].shape == () and float(got["s"]) == 2.5
    assert got["e"].shape == (0, 3)


def test_latest_pointer_and_resume(tmp_path):
    t1, t2 = make_tree(1), make_tree(2)
    t_ckpt.save(str(tmp_path), 10, t1)
    t_ckpt.save(str(tmp_path), 20, t2)
    assert t_ckpt.latest_step(str(tmp_path)) == 20
    restored, step, _ = t_ckpt.restore(str(tmp_path), skeleton(t2))
    assert step == 20
    assert_tree_equal(restored, t2)
    old, step, _ = t_ckpt.restore(str(tmp_path), skeleton(t1), step=10)
    assert step == 10
    assert_tree_equal(old, t1)
    assert t_ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(str(tmp_path / "none"), t1)


def test_shape_mismatch_rejected(tmp_path):
    t_ckpt.save(str(tmp_path), 1, {"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="checkpoint shape"):
        t_ckpt.restore(str(tmp_path), {"w": torch.zeros(8, 4)})


def test_gc_keeps_newest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        t_ckpt.save(str(tmp_path), s, {"x": torch.zeros(3)})
    removed = t_ckpt.gc_old(str(tmp_path), keep=2)
    assert len(removed) == 3
    assert t_ckpt.latest_step(str(tmp_path)) == 5
    remaining = sorted(d for d in os.listdir(tmp_path)
                       if d.startswith("step_"))
    assert remaining == ["step_00000004", "step_00000005"]


def test_async_checkpointer(tmp_path):
    ac = t_ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = make_tree(3)
    ac.save_async(7, tree)
    ac.wait()
    restored, step, _ = t_ckpt.restore(str(tmp_path), skeleton(tree))
    assert step == 7
    assert_tree_equal(restored, tree)


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_async_snapshot_isolated_from_mutation(tmp_path, kind):
    """The snapshot is taken at the call, before the in-place updates of
    the next steps."""
    ac = t_ckpt.AsyncCheckpointer(str(tmp_path))
    x = (torch.ones(1000, 100) if kind == "tensor"
         else np.ones((1000, 100), np.float32))
    ac.save_async(1, {"x": x})
    x *= 0.0
    ac.wait()
    restored, _, _ = t_ckpt.restore(str(tmp_path),
                                    {"x": torch.zeros(1000, 100)})
    assert bool((restored["x"] == 1.0).all())


# ----------------------------------------------- across the two packages

def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_on_disk_format_is_the_jax_packages_byte_for_byte(tmp_path):
    tree = make_tree(4)
    r_ckpt.save(str(tmp_path / "jax"), 42, jax_tree(tree), extra={"k": 1})
    t_ckpt.save(str(tmp_path / "port"), 42, tree, extra={"k": 1})
    jax_files, port_files = (_files(tmp_path / "jax"),
                             _files(tmp_path / "port"))
    assert set(jax_files) == set(port_files)
    assert set(port_files) >= {"LATEST", "step_00000042/manifest.json",
                               "step_00000042/arrays/params__b.npy"}
    for name, data in jax_files.items():
        assert port_files[name] == data, name


def test_jax_save_restores_in_the_port(tmp_path):
    tree = make_tree(5)
    r_ckpt.save(str(tmp_path), 9, jax_tree(tree), extra={"note": "jax"})
    restored, step, extra = t_ckpt.restore(str(tmp_path), skeleton(tree))
    assert (step, extra) == (9, {"note": "jax"})
    assert_tree_equal(restored, tree)


def test_port_save_restores_in_jax(tmp_path):
    tree = make_tree(6)
    t_ckpt.save(str(tmp_path), 11, tree)
    want = jax_tree(tree)
    restored, step, _ = r_ckpt.restore(
        str(tmp_path), jax.tree.map(np.zeros_like, want))
    assert step == 11
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        got = restored
        for p in path:
            got = got[p.key]
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(w, np.float32))


# ------------------------------------------------------------ train state

def _smoke_state(name="qwen2-1.5b", opt_name="adamw", seed=0):
    cfg = t_configs.get_smoke(name)
    model = TModel(cfg, "cpu")
    opt = t_optim.OptimizerConfig(name=opt_name, lr=1e-3, warmup_steps=2)
    return cfg, model, opt, t_optim.init_train_state(
        model, torch.Generator().manual_seed(seed), opt)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_params_to_numpy_inverts_from_numpy(name):
    tree = tt._jax_tree(name)
    cfg = t_configs.get_smoke(name)
    back = convert.lm_params_to_numpy(
        cfg, convert.lm_params_from_numpy(cfg, tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_bf16_params_go_to_ml_dtypes_and_back():
    cfg = dataclasses.replace(t_configs.get_smoke("qwen2-1.5b"),
                              dtype="bfloat16")
    params = TModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    tree = convert.lm_params_to_numpy(cfg, params)
    assert tree["embed"].dtype == ml_dtypes.bfloat16
    assert tree["final_norm"]["scale"].dtype == np.float32
    again = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    for (n, a), (_, b) in zip(params.named_parameters(),
                              again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
def test_train_state_round_trip(opt_name, tmp_path):
    cfg, model, opt, state = _smoke_state(opt_name=opt_name)
    step = t_optim.make_train_step(model, opt)
    batch = tt._torch_batch(tt._batch(cfg))
    step(state, batch)
    state["ef"] = {n: torch.full_like(m, 0.5)
                   for n, m in state["opt"]["master"].items()}
    tree = convert.train_state_to_numpy(cfg, state)
    assert set(tree["opt"]) == ({"master", "mu", "nu"} if opt_name == "adamw"
                                else {"master", "mu"})
    assert tree["step"].dtype == np.int32 and int(tree["step"]) == 1
    _, _, _, other = _smoke_state(opt_name=opt_name, seed=9)
    other["ef"] = {n: torch.zeros_like(m)
                   for n, m in other["opt"]["master"].items()}
    convert.train_state_from_numpy(cfg, tree, other)
    assert other["step"] == 1
    for a, b in ((state["params"].parameters(), other["params"].parameters()),):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for k in ("master", "mu") + (("nu",) if opt_name == "adamw" else ()):
        assert all(torch.equal(state["opt"][k][n], other["opt"][k][n])
                   for n in state["opt"][k])
    assert all(torch.equal(state["ef"][n], other["ef"][n])
               for n in state["ef"])
    # through a checkpoint: a meta skeleton, nothing copied for it
    t_ckpt.save(str(tmp_path), 1, convert.train_state_to_tree(cfg, state))
    skel = convert.train_state_to_tree(cfg, state, "meta")
    assert all(t.device.type == "meta" for t in t_ckpt._flatten(skel).values())
    restored, _, _ = t_ckpt.restore(str(tmp_path), skel)
    third = _smoke_state(opt_name=opt_name, seed=3)[3]
    third["ef"] = dict(other["ef"])
    convert.train_state_from_numpy(cfg, restored, third)
    assert all(torch.equal(x, y) for x, y in zip(
        state["params"].parameters(), third["params"].parameters()))
    with pytest.raises(ValueError, match="optimizer state"):
        convert.train_state_from_numpy(
            cfg, tree, _smoke_state(opt_name="sgd" if opt_name == "adamw"
                                    else "adamw")[3])


def test_port_resume_equivalence(tmp_path):
    """Training 6 steps == training 3, checkpointing, restoring into a
    fresh state and training 3 more, bit for bit."""
    cfg = t_configs.get_smoke("qwen2-1.5b")
    data = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4, seed=3))

    def run(state, step_fn, a, b):
        for s in range(a, b):
            batch = {k: torch.from_numpy(v) for k, v in
                     data.batch_at(s).items()}
            state, m = step_fn(state, batch)
        return state, float(m["loss"])

    _, model, opt, s0 = _smoke_state()
    step_fn = t_optim.make_train_step(model, opt)
    full, loss_full = run(s0, step_fn, 0, 6)
    _, _, _, mid = _smoke_state()
    mid, _ = run(mid, step_fn, 0, 3)
    t_ckpt.save(str(tmp_path), 3, convert.train_state_to_tree(cfg, mid))
    fresh = _smoke_state(seed=5)[3]
    tree, step, _ = t_ckpt.restore(
        str(tmp_path), convert.train_state_to_tree(cfg, fresh, "meta"))
    convert.train_state_from_numpy(cfg, tree, fresh)
    assert step == 3 and fresh["step"] == 3
    resumed, loss_resumed = run(fresh, step_fn, 3, 6)
    assert loss_full == loss_resumed
    assert all(torch.equal(a, b) for a, b in zip(
        full["params"].parameters(), resumed["params"].parameters()))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package trains 3 steps and saves; the port restores and
    trains 3 more.  Against the JAX package's own 6 steps: the loss
    within 1e-5 and the state as ``test_torch_train.assert_state_tracks_jax``
    holds it; against the port continuing from the JAX package's state
    in memory, bit for bit."""
    name = "qwen2-1.5b"
    rcfg, cfg = r_configs.get_smoke(name), t_configs.get_smoke(name)
    ropt = r_optim.OptimizerConfig(lr=1e-3, warmup_steps=2)
    topt = t_optim.OptimizerConfig(lr=1e-3, warmup_steps=2)
    rmodel = RModel(rcfg)
    data = r_make_source(RDataConfig(vocab_size=rcfg.vocab_size, seq_len=16,
                                     global_batch=4, seed=3))
    rstep = jax.jit(r_optim.make_train_step(rmodel, ropt))

    def rrun(state, a, b):
        for s in range(a, b):
            state, m = rstep(state, {k: jnp.asarray(v) for k, v in
                                     data.batch_at(s).items()})
        return state, float(m["loss"])

    full, loss_full = rrun(r_optim.init_train_state(
        rmodel, jax.random.key(0), ropt), 0, 6)
    mid, _ = rrun(r_optim.init_train_state(rmodel, jax.random.key(0), ropt),
                  0, 3)
    r_ckpt.save(str(tmp_path), 3, mid)

    model = TModel(cfg, "cpu")
    tstep = t_optim.make_train_step(model, topt)

    def trun(state, a, b):
        lrs = []
        for s in range(a, b):
            state, m = tstep(state, {k: torch.from_numpy(v) for k, v in
                                     data.batch_at(s).items()})
            lrs.append(m["lr"])
        return state, float(m["loss"]), lrs

    state = t_optim.init_train_state(model, torch.Generator().manual_seed(0),
                                     topt)
    tree, step, _ = t_ckpt.restore(
        str(tmp_path), convert.train_state_to_tree(cfg, state, "meta"))
    assert step == 3
    convert.train_state_from_numpy(cfg, tree, state)
    assert state["step"] == 3
    resumed, loss_resumed, lrs = trun(state, 3, 6)
    assert abs(loss_resumed - loss_full) < 1e-5
    tt.assert_state_tracks_jax(convert.train_state_to_numpy(cfg, resumed),
                               jax.tree.map(np.asarray, full),
                               [topt.lr] * 3 + lrs, "adamw")

    in_memory = t_optim.init_train_state(
        model, torch.Generator().manual_seed(1), topt)
    convert.train_state_from_numpy(cfg, jax.tree.map(np.asarray, mid),
                                   in_memory)
    in_memory, loss_mem, _ = trun(in_memory, 3, 6)
    assert loss_mem == loss_resumed
    assert all(torch.equal(a, b) for a, b in zip(
        in_memory["params"].parameters(), resumed["params"].parameters()))


def test_port_train_checkpoint_resumes_in_jax(tmp_path):
    """The port's launcher checkpoint restores into the JAX package's
    train state: every leaf equal."""
    from repro_torch.launch import train as t_train
    ckpt_dir = tmp_path / "ckpt"
    assert t_train.main(["--device", "cpu", "--steps", "3", "--seq-len",
                         "16", "--global-batch", "4", "--ckpt-dir",
                         str(ckpt_dir)]) == 0
    rmodel = RModel(r_configs.get_smoke("qwen2-1.5b"))
    skel = r_optim.init_train_state(
        rmodel, jax.random.key(0),
        r_optim.OptimizerConfig(lr=3e-3, warmup_steps=20))
    restored, step, _ = r_ckpt.restore(str(ckpt_dir), skel)
    assert step == 3 and int(restored["step"]) == 3
    tree, _, _ = t_ckpt.restore(str(ckpt_dir), skel)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b.numpy()), restored, tree)
    # the JAX step runs on it
    state = jax.tree.map(jnp.asarray, restored)
    data = r_make_source(RDataConfig(vocab_size=256, seq_len=16,
                                     global_batch=4, seed=0))
    _, m = jax.jit(r_optim.make_train_step(
        rmodel, r_optim.OptimizerConfig(lr=3e-3, warmup_steps=20)))(
        state, {k: jnp.asarray(v) for k, v in data.batch_at(3).items()})
    assert np.isfinite(float(m["loss"]))

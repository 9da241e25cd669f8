"""The port's sharding policy against the JAX package's.

For every architecture at full size (the port's parameters on ``meta``,
the JAX package's tree from ``jax.eval_shape``), the parameter, batch,
cache and optimizer specs equal the JAX ``ShardingPolicy``'s entry for
entry, on a 2 x 2 mesh and on the 16 x 16 production shape (both as
``AbstractMesh``es: a policy reads only axis names and sizes).  The JAX
package stacks each layer's parameters with a leading L dimension; the
port holds one module per layer, so its spec is the JAX spec without
those leading Nones.  Then a one-rank gloo world: a model under a 1 x 1
policy gives the outputs of the model without one.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as rconfigs
from repro.models.model import Model as RModel
from repro.sharding import ShardingPolicy as RPolicy
from repro_torch import configs
from repro_torch.configs.base import ALL_SHAPES, DECODE_32K, LONG_500K
from repro_torch.models.model import Model
from repro_torch.sharding import (AbstractMesh, PolicyOptions,
                                  ShardingPolicy, _param_path)

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model"))}


def policies(mesh_name, arch, options=None):
    shape, names = MESHES[mesh_name]
    return (ShardingPolicy(AbstractMesh(shape, names), configs.get(arch),
                           options),
            RPolicy(JaxAbstractMesh(shape, names), rconfigs.get(arch),
                    options and _jax_options(options)))


def _jax_options(opt):
    from repro.sharding import PolicyOptions as RO
    import dataclasses
    return RO(**dataclasses.asdict(opt))


@functools.lru_cache(maxsize=None)
def jax_param_shapes(arch):
    cfg = rconfigs.get(arch)
    return jax.eval_shape(lambda: RModel(cfg).init(jax.random.key(0)))


def flat_specs(tree):
    """{"stack/attn/wq": tuple(spec)} of a JAX tree of specs or shapes."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(leaf) if isinstance(leaf, P) else tuple(leaf.shape))
            for path, leaf in leaves}


def as_tuples(tree):
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_and_optimizer_specs_equal_the_jax_policys(arch, mesh_name):
    ours, theirs = policies(mesh_name, arch)
    params = Model(configs.get(arch), "meta").empty_params()
    specs = ours.param_specs(params)
    shapes = dict(params.named_parameters())
    jshapes = flat_specs(jax_param_shapes(arch))
    jspecs = flat_specs(theirs.param_specs(jax_param_shapes(arch)))
    assert len(specs) == sum(1 for _ in shapes)
    seen = set()
    for name, spec in specs.items():
        path = "/".join(_param_path(name))
        seen.add(path)
        js, jshape = jspecs[path], jshapes[path]
        extra = len(jshape) - shapes[name].ndim
        assert jshape[extra:] == tuple(shapes[name].shape), name
        assert all(e is None for e in js[:extra]), (name, js)
        assert spec == js[extra:], (name, spec, js)
        # ZeRO-1: the same rule on the same (stacked) layout
        assert (ours.optimizer_spec((None,) * extra + spec, jshape)
                == tuple(theirs.optimizer_spec(P(*js), jshape))), name
    assert seen == set(jspecs)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_batch_and_cache_specs_equal_the_jax_policys(arch, mesh_name):
    for shape_name, shape in ALL_SHAPES.items():
        if not configs.supports_shape(arch, shape_name):
            continue
        ours, theirs = policies(mesh_name, arch)
        got = ours.batch_specs(Model(configs.get(arch), "meta")
                               .input_specs(shape), shape)
        want = as_tuples(theirs.batch_specs(
            RModel(rconfigs.get(arch)).input_specs(shape), shape))
        assert got == want, (arch, shape_name)
        assert ours._decode_seq_axes == theirs._decode_seq_axes


def test_indivisible_dims_stay_replicated():
    ours, theirs = policies("2x2", "whisper-large-v3")
    assert ours._validated(("model",), (5,)) == (None,)
    assert ours._validated(("model",), (6,)) == ("model",)
    assert tuple(theirs._validated(P("model"), (5,))) == (None,)


def test_experts_sit_on_the_model_axis():
    ours, _ = policies("2x2", "granite-moe-1b-a400m")
    specs = ours.param_specs(Model(configs.get("granite-moe-1b-a400m"),
                                   "meta").empty_params())
    assert specs["stack.0.moe.w_up"] == ("model", None, None)
    assert specs["stack.0.moe.router"][-1] is None
    assert specs["stack.0.attn.wq"] == (None, "model")
    assert specs["stack.0.attn.wo"] == ("model", None)


def test_long500k_batch1_cache_uses_both_axes():
    ours, _ = policies("2x2", "zamba2-2.7b")
    specs = ours.batch_specs(Model(configs.get("zamba2-2.7b"), "meta")
                             .input_specs(LONG_500K), LONG_500K)
    assert specs["cache"]["attn"]["k"][3] == ("data", "model")
    assert ours._decode_seq_axes == ("data", "model")


def test_decode_cache_is_sequence_sharded():
    ours, _ = policies("2x2", "qwen2.5-32b")
    k = ours.batch_specs(Model(configs.get("qwen2.5-32b"), "meta")
                         .input_specs(DECODE_32K))["cache"]["k"]
    assert k[1] == "data" and k[3] == "model"
    off, _ = policies("2x2", "qwen2.5-32b",
                      PolicyOptions(seq_shard_decode=False))
    k = off.batch_specs(Model(configs.get("qwen2.5-32b"), "meta")
                        .input_specs(DECODE_32K))["cache"]["k"]
    assert k[3] is None


def test_placements_map_specs_onto_mesh_dimensions():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding import placements
    mesh = AbstractMesh((2, 2, 4), ("pod", "data", "model"))
    assert placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert placements((None, None), mesh) == [Replicate()] * 3
    assert placements((), mesh) == [Replicate()] * 3


# ------------------------------------------------ a one-rank gloo world

@pytest.fixture
def gloo_world(tmp_path):
    from repro_torch.launch import mesh as M
    M.init_world("gloo", 1, 0, str(tmp_path / "store"))
    try:
        yield M.make_host_mesh()
    finally:
        M.destroy_world()


def _batch(cfg, rng, b=2, s=16):
    batch = {}
    if cfg.input_embeds:
        batch["embeds"] = torch.as_tensor(
            rng.standard_normal((b, s, cfg.d_model)), dtype=torch.float32)
    else:
        batch["tokens"] = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (b, s)), dtype=torch.int32)
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.as_tensor(
            rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)),
            dtype=torch.float32)
    if cfg.mrope:
        batch["positions"] = torch.arange(s)[None, None].expand(
            3, b, s).contiguous()
    return batch


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b", "zamba2-2.7b",
                                  "whisper-large-v3", "qwen2-vl-2b"])
def test_a_one_rank_policy_gives_the_unsharded_outputs(gloo_world, arch):
    """forward, prefill and the loss with its gradient are equal; a decode
    step with the serve launcher's options (unsharded caches) agrees to
    float32 rounding."""
    cfg = configs.get_smoke(arch)
    policy = ShardingPolicy(gloo_world, cfg,
                            PolicyOptions(seq_shard_decode=False))
    m0, m1 = Model(cfg, "cpu"), Model(cfg, "cpu", policy=policy)
    p0 = m0.init(torch.Generator().manual_seed(0))
    p1 = m1.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg, np.random.default_rng(0))
    assert torch.equal(m0.forward(p0, batch), m1.forward(p1, batch)
                       .full_tensor())
    l0, c0 = m0.prefill(p0, batch, 32)
    l1, c1 = m1.prefill(p1, batch, 32)
    assert torch.equal(l0, l1.full_tensor())
    step = {"lengths": torch.tensor([16, 16], dtype=torch.int32)}
    if cfg.input_embeds:
        step["embeds"] = torch.ones(2, 1, cfg.d_model)
    else:
        step["tokens"] = l0.argmax(-1).to(torch.int32)
    d0, _ = m0.decode_step(p0, step, c0)
    d1, _ = m1.decode_step(p1, step, c1)
    # a decode row is one token: DTensor's matmul on a row-sharded wo
    # takes another BLAS path for the (B, 1, H*hd) product than the plain
    # tensor's, which rounds the float32 sums differently
    torch.testing.assert_close(d0, d1.full_tensor(), rtol=1e-5, atol=1e-5)
    from repro_torch.optim import value_and_grad
    labels = dict(batch, labels=torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)),
        dtype=torch.int32))
    p0.requires_grad_(True)
    p1.requires_grad_(True)
    loss0, g0 = value_and_grad(m0.loss, p0, labels)
    loss1, g1 = value_and_grad(m1.loss, p1, labels)
    assert torch.equal(loss0, loss1.full_tensor())
    # equal, but for leaves whose true gradient is 0 (whisper's and
    # qwen2's key biases: softmax is shift-invariant), where the float32
    # noise depends on the order of the batch sum
    top = max(g.abs().max().item() for g in g0.values())
    for n in g0:
        g = g1[n].full_tensor()
        if g0[n].abs().max().item() > 1e-6 * top:
            assert torch.equal(g0[n], g), n
        else:
            assert (g0[n] - g).abs().max().item() <= 1e-6 * top, n


SERVE_ARGS = ["--device", "cpu", "--requests", "3", "--slots", "2",
              "--max-new", "4"]


@pytest.mark.timeout(300)
def test_the_serve_launcher_runs_under_its_policy():
    """Two gloo ranks under ``torchrun --standalone`` (a free port): the
    launcher serves under a 1 x 2 host mesh and its policy, and rank 0
    alone reports."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         *SERVE_ARGS], env=dict(os.environ,
                                PYTHONPATH=os.path.join(root, "src")),
        capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.count("served 3 requests on cpu, 12 tokens") == 1


def test_the_serve_launcher_on_one_rank_serves_without_a_policy(
        monkeypatch):
    """One rank: the JAX launcher's 1 x 1 host mesh, whose policy shards
    nothing, so the port serves with no policy (and no process world)."""
    import torch.distributed as dist
    from repro_torch.launch import serve
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    served = []
    run = serve._serve

    def spy(args, cfg, model, verbose=True):
        served.append((model.policy, dist.is_initialized()))
        return run(args, cfg, model, verbose)
    monkeypatch.setattr(serve, "_serve", spy)
    assert serve.main(SERVE_ARGS) == 0
    assert served == [(None, False)]

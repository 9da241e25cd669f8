"""Eight gloo ranks on the CPU, a (2, 4) ("data", "model") mesh: the
port's distribution layer where one process cannot show it.

    PYTHONPATH=src python tests/torch_multirank_script.py WORKDIR

Run by ``tests/test_torch_multirank.py`` in a subprocess.  The ranks
rendezvous through a ``FileStore`` in WORKDIR (no TCP port).  Rank 0
prints ``OK <check>`` for each check that every rank passed, then
``ALL MULTIRANK CHECKS PASSED``.  The JAX package's decode attention is
the second yardstick of flash-decoding (rank 0 computes it).
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8


def say(rank, msg):
    if rank == 0:
        print(msg, flush=True)


def all_ok(ok: bool) -> bool:
    t = torch.tensor([1 if ok else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def check(rank, name, ok, detail=""):
    ok = all_ok(bool(ok))
    if not ok:
        raise AssertionError(f"rank {rank}: {name} failed {detail}")
    say(rank, f"OK {name} {detail}")


def flash_decoding(rank, mesh):
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.sharding import PolicyOptions, ShardingPolicy
    cfg = configs.get_smoke("qwen2-1.5b")
    policy = ShardingPolicy(mesh, cfg, PolicyOptions())
    policy._decode_seq_axes = ("model",)
    rng = np.random.default_rng(0)
    b, h, hkv, s, d = 4, 4, 2, 32, 16
    q = torch.as_tensor(rng.standard_normal((b, h, 1, d)), dtype=torch.float32)
    kc = torch.as_tensor(rng.standard_normal((b, hkv, s, d)),
                         dtype=torch.float32)
    vc = torch.as_tensor(rng.standard_normal((b, hkv, s, d)),
                         dtype=torch.float32)
    lengths = torch.tensor([s, s // 2, 7, s - 1], dtype=torch.int32)
    got = policy.sharded_decode_attention(q, kc, vc, lengths, None)
    got_w = policy.sharded_decode_attention(q, kc, vc, lengths, 6)
    got, got_w = got.full_tensor(), got_w.full_tensor()
    want = L.decode_attention(q, kc, vc, lengths, None)
    want_w = L.decode_attention(q, kc, vc, lengths, 6)
    err = max((got - want).abs().max().item(),
              (got_w - want_w).abs().max().item())
    ok = (torch.allclose(got, want, rtol=1e-5, atol=1e-5)
          and torch.allclose(got_w, want_w, rtol=1e-5, atol=1e-5))
    check(rank, "flash_decoding_vs_port", ok, f"max_abs_err={err:.3g}")
    ok_jax, jerr = True, 0.0
    if rank == 0:
        import jax.numpy as jnp
        from repro.models import layers as RL
        for win, g in ((None, got), (6, got_w)):
            ref = np.asarray(RL.decode_attention(
                jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()),
                jnp.asarray(vc.numpy()), jnp.asarray(lengths.numpy()), win))
            jerr = max(jerr, float(np.abs(g.numpy() - ref).max()))
            ok_jax &= np.allclose(g.numpy(), ref, rtol=1e-5, atol=1e-5)
    check(rank, "flash_decoding_vs_jax", ok_jax, f"max_abs_err={jerr:.3g}")


def compressed_psum_distinct(rank):
    from repro_torch.distributed import compressed_psum
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((WORLD, 64)), dtype=torch.float32)
    got = compressed_psum(x[rank].clone())
    want = x.mean(0)
    err = (got - want).abs().max().item()
    check(rank, "compressed_psum_distinct_shards",
          torch.allclose(got, want, atol=0.05), f"max_abs_err={err:.3g}")


def sharded_train(rank, mesh):
    """One train step under the (2, 4) mesh against one rank's, at the
    JAX multi-device test's tolerances; then the ZeRO-1 state."""
    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.optim import (OptimizerConfig, init_train_state,
                                   make_train_step, optimizer_specs)
    from repro_torch.sharding import ShardingPolicy, spec_of
    cfg = configs.get_smoke("qwen3-4b")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1)
    rng = np.random.default_rng(1)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 16)),
                                dtype=torch.int32)
             for k in ("tokens", "labels")}
    model0 = Model(cfg, "cpu")
    state0 = init_train_state(model0, torch.Generator().manual_seed(0), opt)
    s0, m0 = make_train_step(model0, opt)(state0, batch)
    policy = ShardingPolicy(mesh, cfg)
    model1 = Model(cfg, "cpu", policy=policy)
    state1 = init_train_state(model1, torch.Generator().manual_seed(0), opt)
    # ZeRO-1: every optimizer leaf reassembles to the unsharded state,
    # laid out by optimizer_spec
    specs = optimizer_specs(state1["params"], policy)
    fresh = init_train_state(Model(cfg, "cpu"),
                             torch.Generator().manual_seed(0), opt)
    ok = all(spec_of(state1["opt"][k][n]) == specs[n]
             and torch.equal(state1["opt"][k][n].full_tensor(),
                             fresh["opt"][k][n])
             for k in state1["opt"] for n in specs)
    on_data = sum("data" in str(s) for s in specs.values())
    check(rank, "zero1_shards_reassemble", ok and on_data > 0,
          f"leaves_on_data={on_data}/{len(specs)}")
    s1, m1 = make_train_step(model1, opt)(state1, batch)
    l0, l1 = float(m0["loss"]), float(m1["loss"].full_tensor())
    w0 = s0["params"].lm_head.detach()
    w1 = s1["params"].lm_head.detach().full_tensor()
    err = (w0 - w1).abs().max().item()
    # every updated leaf, at the same tolerances
    after = {n: p.detach().full_tensor()
             for n, p in s1["params"].named_parameters()}
    every = all(torch.allclose(p.detach(), after[n], rtol=5e-2, atol=5e-3)
                for n, p in s0["params"].named_parameters())
    check(rank, "sharded_train_step_matches_one_rank",
          abs(l0 - l1) / max(abs(l0), 1e-9) < 2e-2
          and torch.allclose(w0, w1, rtol=5e-2, atol=5e-3) and every,
          f"loss={l0:.6f}/{l1:.6f} lm_head_max_abs_err={err:.3g}")


def sharded_gradients(rank, mesh):
    """Every family's loss and gradient under the policy against one
    rank's: the loss within 1e-5 relative, each leaf of the gradient
    within 1e-4 of its largest |g| plus 1e-6 of the whole gradient's
    (the cross-package gradient tolerance of ``test_torch_train.py``).
    The mesh shards the batch, heads, d_inner, experts and the
    vocabulary, so every local region's gradient is summed over ranks."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models.model import Model
    from repro_torch.optim import value_and_grad
    from repro_torch.sharding import ShardingPolicy
    import dataclasses
    for arch in ("qwen2-1.5b", "mamba2-2.7b", "granite-moe-1b-a400m",
                 "zamba2-2.7b", "whisper-large-v3", "qwen2-vl-2b",
                 "qwen3-4b-vocab250"):
        if arch.endswith("vocab250"):
            # a vocabulary padded to 256 and sharded: the loss masks the
            # padding (qwen3-4b's head is untied, qwen2's below is tied)
            cfg = dataclasses.replace(configs.get_smoke("qwen3-4b"),
                                      vocab_size=250)
        else:
            cfg = configs.get_smoke(arch)
        batch = {k: torch.as_tensor(v) for k, v in make_source(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
            seed=0)).batch_at(0).items()}
        g = torch.Generator().manual_seed(1)
        if cfg.family == "encdec":
            batch["audio_embeds"] = torch.randn(8, cfg.encoder_seq,
                                                cfg.d_model, generator=g)
        elif cfg.input_embeds:
            batch["embeds"] = torch.randn(8, 32, cfg.d_model, generator=g)
            del batch["tokens"]
        m0 = Model(cfg, "cpu")
        m1 = Model(cfg, "cpu", policy=ShardingPolicy(mesh, cfg))
        p0 = m0.init(torch.Generator().manual_seed(0)).requires_grad_(True)
        p1 = m1.init(torch.Generator().manual_seed(0)).requires_grad_(True)
        l0, g0 = value_and_grad(m0.loss, p0, batch)
        l1, g1 = value_and_grad(m1.loss, p1, batch)
        l1 = l1.full_tensor()
        g1 = {n: t.full_tensor() for n, t in g1.items()}
        top = max(t.abs().max().item() for t in g0.values())
        errs = {n: (g0[n] - g1[n]).abs().max().item() for n in g0}
        ok = all(errs[n] <= 1e-4 * g0[n].abs().max().item() + 1e-6 * top
                 for n in g0)
        rel = abs(l0.item() - l1.item()) / abs(l0.item())
        worst = max(errs, key=errs.get)
        check(rank, f"{arch}_gradient_matches_one_rank",
              ok and rel <= 1e-5,
              f"loss_rel={rel:.3g} worst={worst}:{errs[worst] / top:.3g}")


def sharded_serving(rank, mesh):
    """Prefill and decode under the policy (sequence-sharded caches,
    flash-decoding) against one rank; a mamba2 prefill on local heads."""
    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.sharding import ShardingPolicy
    for arch in ("qwen2-1.5b", "mamba2-2.7b"):
        cfg = configs.get_smoke(arch)
        m0 = Model(cfg, "cpu")
        m1 = Model(cfg, "cpu", policy=ShardingPolicy(mesh, cfg))
        p0 = m0.init(torch.Generator().manual_seed(0))
        p1 = m1.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(3)
        b = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (4, 16)),
                                       dtype=torch.int32)}
        l0, c0 = m0.prefill(p0, b, 32)
        l1, c1 = m1.prefill(p1, b, 32)
        err = (l0 - l1.full_tensor()).abs().max().item()
        for step in range(2):
            tok = {"tokens": l0.argmax(-1).to(torch.int32),
                   "lengths": torch.full((4,), 16 + step, dtype=torch.int32)}
            l0, c0 = m0.decode_step(p0, tok, c0)
            l1, c1 = m1.decode_step(p1, tok, c1)
            err = max(err, (l0 - l1.full_tensor()).abs().max().item())
        check(rank, f"{arch}_prefill_and_decode_match_one_rank",
              err < 1e-4, f"max_abs_err={err:.3g}")


def kernels_refuse_dtensors(rank, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import ops
    q = distribute_tensor(torch.zeros(1, 2, 4, 8), mesh,
                          [Replicate(), Replicate()])
    refused = []
    for fn, args in ((ops.flash_attention, (q, q, q)),
                     (ops.ssd_scan, (torch.zeros(1, 4, 2, 8),
                                     distribute_tensor(
                                         torch.zeros(1, 4, 2), mesh,
                                         [Replicate(), Replicate()]),
                                     torch.zeros(2), torch.zeros(1, 4, 1, 8),
                                     torch.zeros(1, 4, 1, 8)))):
        try:
            fn(*args)
            refused.append(False)
        except TypeError:
            refused.append(True)
    check(rank, "kernels_refuse_dtensors", all(refused))


def worker(rank, store_path):
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as M
    M.init_world("gloo", WORLD, rank, store_path)
    try:
        mesh = M.make_compat_mesh((2, 4), ("data", "model"))
        flash_decoding(rank, mesh)
        compressed_psum_distinct(rank)
        sharded_train(rank, mesh)
        sharded_gradients(rank, mesh)
        sharded_serving(rank, mesh)
        kernels_refuse_dtensors(rank, mesh)
        say(rank, "ALL MULTIRANK CHECKS PASSED")
    finally:
        M.destroy_world()


if __name__ == "__main__":
    workdir = sys.argv[1]
    os.makedirs(workdir, exist_ok=True)
    mp.spawn(worker, args=(os.path.join(workdir, "store"),), nprocs=WORLD)

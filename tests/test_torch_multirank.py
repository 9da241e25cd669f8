"""The port's distribution layer on eight gloo ranks (a 2 x 4 mesh on
the CPU), run once in a subprocess (``torch_multirank_script.py``) that
rendezvouses through a ``FileStore`` under the test's own directory, so
that parallel workers never share a port.  Each test reads one check of
that run: flash-decoding against both packages' decode attention, a
sharded train step and every family's gradient against one rank's,
``compressed_psum`` with distinct shards, the ZeRO-1 state, sharded
serving, and the kernel wrappers refusing DTensors.  The train
launcher runs under ``torchrun --standalone``, which rendezvouses on a
free port."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def multirank_run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("multirank")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "torch_multirank_script.py"),
         str(workdir)], env=env, capture_output=True, text=True,
        timeout=600)
    return res


CHECKS = ["flash_decoding_vs_port", "flash_decoding_vs_jax",
          "compressed_psum_distinct_shards", "zero1_shards_reassemble",
          "sharded_train_step_matches_one_rank",
          "qwen2-1.5b_gradient_matches_one_rank",
          "mamba2-2.7b_gradient_matches_one_rank",
          "granite-moe-1b-a400m_gradient_matches_one_rank",
          "zamba2-2.7b_gradient_matches_one_rank",
          "whisper-large-v3_gradient_matches_one_rank",
          "qwen2-vl-2b_gradient_matches_one_rank",
          "qwen3-4b-vocab250_gradient_matches_one_rank",
          "qwen2-1.5b_prefill_and_decode_match_one_rank",
          "mamba2-2.7b_prefill_and_decode_match_one_rank",
          "kernels_refuse_dtensors"]


@pytest.mark.timeout(600)
def test_all_eight_ranks_pass(multirank_run):
    sys.stdout.write(multirank_run.stdout)
    sys.stderr.write(multirank_run.stderr[-4000:])
    assert multirank_run.returncode == 0
    assert "ALL MULTIRANK CHECKS PASSED" in multirank_run.stdout


@pytest.mark.parametrize("check", CHECKS)
def test_check_passed_on_every_rank(multirank_run, check):
    lines = multirank_run.stdout.splitlines()
    assert any(line.split()[:2] == ["OK", check] for line in lines), \
        multirank_run.stderr[-2000:]


@pytest.mark.timeout(600)
def test_train_launcher_on_four_ranks_checkpoints_as_one_card(tmp_path):
    """``torchrun`` with four gloo ranks, ``--data-par 2 --model-par 2``:
    the losses of the single-card run, and a checkpoint (gathered to rank
    0, the JAX package's format) that restores into a single-card state
    with the single-card run's values; the sharded run resumes from it."""
    import numpy as np
    from repro_torch import checkpoint as ckpt
    common = ["--device", "cpu", "--steps", "3", "--seq-len", "32",
              "--global-batch", "8", "--lr", "5e-3", "--warmup", "2",
              "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *common,
         "--ckpt-dir", str(tmp_path / "one")], env=env, capture_output=True,
        text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-2000:]
    four = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *common, "--data-par", "2",
         "--model-par", "2", "--ckpt-dir", str(tmp_path / "four")],
        env=env, capture_output=True, text=True, timeout=300)
    assert four.returncode == 0, four.stderr[-2000:]

    def losses(out):
        # {step: the losses printed for it}; the four ranks' lines may
        # interleave
        found = {}
        for step, loss in re.findall(r"step\s+(\d+) loss ([\d.]+)", out):
            found.setdefault(int(step), set()).add(loss)
        return found
    want = losses(one.stdout)
    assert len(want) == 3 and losses(four.stdout) == want
    import torch
    from repro_torch import configs, convert
    from repro_torch.models.model import Model
    from repro_torch.optim import OptimizerConfig, init_train_state
    cfg = configs.get_smoke("qwen2-1.5b")
    skeleton = convert.train_state_to_tree(cfg, init_train_state(
        Model(cfg, "cpu"), torch.Generator().manual_seed(0),
        OptimizerConfig()), "meta")
    a, step_a, _ = ckpt.restore(str(tmp_path / "one"), skeleton)
    b, step_b, _ = ckpt.restore(str(tmp_path / "four"), skeleton)
    assert step_a == step_b == 3

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(tree, np.float32)
    # AdamW moves an element whose gradient is float32 noise (the key
    # biases' true gradient is 0) by ~lr in a direction the noise picks,
    # so, as test_torch_train.assert_state_tracks_jax holds two packages:
    # at most 0.1 % of the elements beyond the resume tolerance, each
    # within 2 * the sum of the learning rates (2.5e-3 + 5e-3 + 5e-3)
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys()
    beyond = total = 0
    for k in la:
        diff = np.abs(la[k] - lb[k])
        assert diff.max() <= 2 * 1.25e-2, (k, diff.max())
        beyond += int((diff > 2e-6 + 2e-5 * np.abs(la[k])).sum())
        total += la[k].size
    assert beyond <= 1e-3 * total, (beyond, total)
    resumed = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         *[c if c != "3" else "4" for c in common], "--data-par", "2",
         "--model-par", "2", "--ckpt-dir", str(tmp_path / "four")],
        env=env, capture_output=True, text=True, timeout=300)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "resumed from step 3" in resumed.stdout


@pytest.mark.timeout(300)
def test_train_launcher_snapshots_on_every_rank_when_one_rank_asks(tmp_path):
    """Two gloo ranks, where only rank 1 sees a sustained straggler (after
    step 1) and a SIGTERM (during step 3): the ranks agree, so both take
    part in each snapshot's gathers instead of one waiting alone.  Rank 0
    writes the straggler snapshot at step 2 and the preemption snapshot
    at step 4, and both ranks stop there."""
    import json
    ck = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    # a hang is the failure this test looks for: the script ends its
    # ranks after 90 s, and torchrun tears down what is left on SIGTERM
    run = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2",
         os.path.join(ROOT, "tests", "torch_train_agreement_script.py"),
         "--device", "cpu", "--model-par", "2", "--steps", "6",
         "--seq-len", "32", "--global-batch", "4", "--ckpt-every", "0",
         "--log-every", "1", "--ckpt-dir", str(ck)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = run.communicate(timeout=150)
    except subprocess.TimeoutExpired:
        run.terminate()
        out, err = run.communicate(timeout=60)
    assert "Alarm clock" not in err and "SIGALRM" not in err, \
        f"the ranks hung:\n{err[-2000:]}"
    assert run.returncode != 0
    assert "preempted: saved step 4" in out, err[-2000:]
    assert "step     3 loss" not in out
    assert sorted(os.listdir(ck)) == ["LATEST", "step_00000002",
                                      "step_00000004"]
    with open(ck / "step_00000004" / "manifest.json") as f:
        assert json.load(f)["extra"] == {"preempted": True}
    with open(ck / "step_00000002" / "manifest.json") as f:
        assert json.load(f)["extra"] == {}

"""The int8 FC GEMM kernel's arithmetic, modelled on the CPU.

``csrc/qgemm.cu``'s swap-AB wgmma kernel cannot run here, so this file
holds an integer model of what it computes against the plain version and
the JAX package's oracle: the weight staged K-major by
``qgemm.stage_kmajor``, x's rows zero-padded to 16 bytes as the wrapper
pads them, tiles of (``bn`` output columns) x (``nw`` rows of x) that
read zeros past N, M and K as TMA does, the K split of ``qgemm.plan``
summed split by split, each block of a cluster finishing its own share
of the tile's (row, 4 columns) quads, then the requant.  Every
comparison is ``torch.equal``: integer sums are exact in any order (the
model sums in float64, exact below 2^53; every sum here is below 2^31,
as the kernel's int32 needs).

It also pins the staging (K-major round trip, zero padding, 16-byte
rows), the plan at the zoo's FC shapes, and that executors built with
and without the staged FC weight agree.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro_torch.core import pipeline as t_pipe
from repro_torch.core.synthesis import CNN2Gate as TGate
from repro_torch.kernels import qgemm
from repro_torch.kernels import ref as t_ref
from repro_torch.models import cnn as t_cnn


def kernel_model(x, w, b, *, shift, relu, sms=qgemm.H100_SMS):
    """What the wgmma kernel computes, tile by tile and split by split."""
    m, k = x.shape
    n = w.shape[1]
    pl = qgemm.plan(m, n, k, sms)
    assert pl.bn in (64, 128) and pl.nw in (8, 16, 32)
    kx = 16 * math.ceil(k / 16)
    assert kx <= pl.k_pad
    # the operands as TMA reads them: zeros past K, M and N
    xa = torch.zeros((pl.m_tiles * pl.nw, pl.k_pad), dtype=torch.float64)
    xa[:m, :kx] = torch.nn.functional.pad(x, (0, kx - k)).to(torch.float64)
    wa = torch.zeros((pl.n_tiles * pl.bn, pl.k_pad), dtype=torch.float64)
    wa[:n] = qgemm.stage_kmajor(w).to(torch.float64)
    acc = torch.zeros((m, n), dtype=torch.float64)
    owner = torch.zeros((m, n), dtype=torch.int64)
    quads = pl.bn // 4
    for nt in range(pl.n_tiles):
        for mt in range(pl.m_tiles):
            a_t = wa[nt * pl.bn:(nt + 1) * pl.bn]      # (bn, K_pad)
            b_t = xa[mt * pl.nw:(mt + 1) * pl.nw]      # (nw, K_pad)
            # each block of the cluster: its K tiles, yT = A . B^T
            parts = [a_t[:, s0 * qgemm.K_TILE:s1 * qgemm.K_TILE]
                     @ b_t[:, s0 * qgemm.K_TILE:s1 * qgemm.K_TILE].T
                     for s0, s1 in pl.split_ranges()]
            for p in parts:
                assert p.abs().max() < 2 ** 31
            items = pl.nw * quads
            share = math.ceil(items / pl.splits)
            for rank in range(pl.splits):
                for idx in range(rank * share, min(items, (rank + 1) * share)):
                    r, q = divmod(idx, quads)
                    row, col = mt * pl.nw + r, nt * pl.bn + 4 * q
                    if row >= m or col >= n:
                        continue
                    cols = slice(col, min(col + 4, n))
                    lanes = slice(4 * q, 4 * q + cols.stop - col)
                    # its own sums, then the others' over DSMEM
                    total = parts[rank][lanes, r].clone()
                    for o in range(pl.splits):
                        if o != rank:
                            total += parts[o][lanes, r]
                    acc[row, cols] = total
                    owner[row, cols] += 1
    assert bool((owner == 1).all())   # every output finished exactly once
    assert acc.abs().max() < 2 ** 31
    acc = acc.to(torch.int32)
    if b is not None:
        acc = acc + b
    return t_ref.requant(acc, shift, relu)


def _case(m, n, k, seed, per_col, with_bias=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    bound = int(2 * 5461 * math.sqrt(k))
    b = (torch.from_numpy(rng.integers(-bound, bound, (n,), dtype=np.int32))
         if with_bias else None)
    s = max(0, min(31, int(math.log2(5461 * math.sqrt(k) / 40))))
    shift = (tuple(int(v) for v in np.clip(s + rng.integers(-3, 4, n), 0,
                                           31)) if per_col else s)
    return x, w, b, shift


# M over every wgmma N (8, 16, 32) and its edges and past 32 (M tiles);
# N of 1, 10, 130 and 1000 (64- and 128-column tiles, ragged); K ragged
# (x padded to 16 bytes, the weight to 128) and whole
GRID = [(m, n, k) for m, n, k in zip(
    (1, 2, 7, 8, 9, 16, 17, 32, 69, 1, 8, 33),
    (1, 10, 130, 1000, 10, 1000, 130, 1, 1000, 1000, 130, 10),
    (777, 130, 2500, 512, 1001, 64, 3001, 200, 515, 4096, 33, 1500))]
GRID_IDS = [f"{m}x{k}x{n}" for m, n, k in GRID]


@pytest.mark.parametrize("m,n,k", GRID, ids=GRID_IDS)
@pytest.mark.parametrize("sms", [qgemm.H100_SMS, 1])
def test_kernel_model_equals_the_plain_version(m, n, k, sms):
    """Tiles, padding, the K split (sms 132: split to fill a wave; sms 1:
    never) and the cluster's shares of the epilogue: equal to
    ``qgemm_plain`` bit for bit, with per-column and scalar shifts."""
    for per_col in (False, True):
        x, w, b, shift = _case(m, n, k, seed=m * 7 + n + k, per_col=per_col,
                               with_bias=per_col or m % 2 == 0)
        for relu in (False, True):
            got = kernel_model(x, w, b, shift=shift, relu=relu, sms=sms)
            want = qgemm.qgemm_plain(x, w, b, shift=shift, relu=relu)
            assert torch.equal(got, want)


@pytest.mark.parametrize("m,n,k", GRID, ids=GRID_IDS)
def test_kernel_model_equals_the_jax_oracle(m, n, k):
    """The same model against the JAX package's ``qgemm_ref``."""
    x, w, b, shift = _case(m, n, k, seed=k, per_col=m % 2 == 1)
    got = kernel_model(x, w, b, shift=shift, relu=True)
    s = jnp.asarray(shift, jnp.int32) if isinstance(shift, tuple) else shift
    want = r_ref.qgemm_ref(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                           jnp.asarray(b.numpy()), s, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k,n", [(4096, 1000), (512, 1000), (64, 10),
                                 (777, 5), (130, 1), (9216, 64)])
def test_fc_kmajor_staging_round_trips_and_pads_with_zeros(k, n):
    w = torch.from_numpy(np.random.default_rng(k + n).integers(
        -128, 128, (k, n), dtype=np.int8))
    wk = qgemm.stage_kmajor(w)
    assert wk.dtype == torch.int8 and wk.is_contiguous()
    assert wk.shape == (n, qgemm.k_padded(k))
    assert wk.shape[1] % qgemm.K_TILE == 0 and wk.shape[1] % 16 == 0
    assert wk.shape[1] - k < qgemm.K_TILE
    assert not wk[:, k:].any()
    assert torch.equal(wk[:, :k].t(), w)


# (K, N) of the zoo's FC layers: VGG-16, AlexNet (224x224: 256x6x6 in),
# ResNet-18 and mobilenet_tiny
ZOO_FC = [(25088, 4096), (4096, 4096), (4096, 1000), (9216, 4096),
          (512, 1000), (64, 10)]


@pytest.mark.parametrize("m", [1, 8, 32, 69])
@pytest.mark.parametrize("k,n", ZOO_FC)
def test_the_plan_covers_n_and_k_within_one_wave(m, k, n):
    pl = qgemm.plan(m, n, k)
    assert pl.nw == (8 if m <= 8 else 16 if m <= 16 else 32)
    assert pl.m_tiles * pl.nw >= m > (pl.m_tiles - 1) * pl.nw
    assert pl.n_tiles * pl.bn >= n > (pl.n_tiles - 1) * pl.bn
    assert pl.k_pad == qgemm.k_padded(k)
    ranges = pl.split_ranges()
    assert len(ranges) == pl.splits <= qgemm.MAX_SPLITS
    assert all(s1 > s0 for s0, s1 in ranges)            # none is empty
    assert ranges[0][0] == 0 and ranges[-1][1] == pl.k_tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if pl.splits > 1:
        assert pl.blocks <= qgemm.H100_SMS
    else:   # a wave of tiles already, one K tile, or no room for two
        assert pl.tiles > qgemm.H100_SMS // 2 or pl.k_tiles == 1


@pytest.mark.parametrize("k,n", ZOO_FC[:4])
@pytest.mark.parametrize("m", [1, 8])
def test_the_large_fc_layers_fill_nine_tenths_of_the_card(m, k, n):
    """VGG-16's and AlexNet's FC layers at batch 1 and 8 run one wave of
    at least 90 % of 132 SMs: fc8 (N 1000) on 64-column tiles."""
    pl = qgemm.plan(m, n, k)
    assert 0.9 * qgemm.H100_SMS <= pl.blocks <= qgemm.H100_SMS
    assert pl.bn == (64 if n == 1000 else 128)


def test_the_plan_is_worked_out_once_per_shape():
    qgemm.plan.cache_clear()
    for _ in range(3):
        qgemm.plan(8, 4096, 25088)
    info = qgemm.plan.cache_info()
    assert (info.misses, info.hits) == (1, 2)


def _strip_staged(qm):
    qm2 = t_pipe.QuantizedModel(qm.name, [], qm.input_m, qm.output_m,
                                qm.parsed, qm.device)
    for ql in qm.layers:
        qm2.layers.append(t_pipe.QuantizedLayer(
            ql.info, ql.spec, ql.w_q, ql.b_q, ql.operand_shifts,
            ql.merge_spec, None if ql.info.kind == "fc" else ql.w_k,
            ql.shift_vec))
    return qm2


@pytest.mark.parametrize("net,per_channel", [("tiny_cnn", False),
                                             ("tiny_cnn", True),
                                             ("resnet_tiny", True),
                                             ("mobilenet_tiny", False)])
def test_executors_with_and_without_the_staged_fc_weight_agree(net,
                                                             per_channel):
    graph = getattr(t_cnn, net)(batch=2, seed=4)
    hw = graph.inputs[0].shape[2]
    x = np.random.default_rng(6).standard_normal(
        (2, 3, hw, hw)).astype(np.float32)
    gate = TGate.from_graph(graph, device="cpu")
    gate.calibrate_quantization(x, per_channel=per_channel)
    qm = gate.quantized
    fcs = [ql for ql in qm.layers if ql.info.kind == "fc"]
    assert fcs
    for ql in fcs:
        assert torch.equal(ql.w_k, qgemm.stage_kmajor(ql.w_q))
    staged = t_pipe.make_executor(qm)(x)
    plain = t_pipe.make_executor(_strip_staged(qm))(x)
    assert torch.equal(staged, plain)


def test_the_plain_version_ignores_the_staged_weight():
    x, w, b, shift = _case(5, 12, 100, seed=3, per_col=True)
    junk = torch.full((12, qgemm.k_padded(100)), 7, dtype=torch.int8)
    want = t_ref.qgemm_ref(x, w, b, shift, True)
    assert torch.equal(qgemm.qgemm_plain(x, w, b, shift=shift, relu=True,
                                         w_k=junk), want)
    assert torch.equal(qgemm.qgemm(x, w, b, shift=shift, relu=True,
                                   w_k=junk), want)

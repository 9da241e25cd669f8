"""Packed groups on the grouped conv route (``qconv.qgconv2d``): P groups
narrower than the 64-column tile run as one group whose weight is
block-diagonal.

On the CPU: the choice of P (``qconv.groups_per_tile``), the staging of the
packed weight against the block-diagonal weight built here by a loop, the
grouped conv as G/P groups of that weight against the conv of G groups,
the plan's packed K and groups, the index map that ``faults.trial_weights``
flips bits by, and the counter.  On the card (``cuda`` marker): the packed
launch ``torch.equal`` to its plain version at ResNeXt-50's four widths
(stride 2, pads, the trial form), the grouped kernel's name where G/P is 1,
and no packing at AlexNet's two-tower widths.  This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import faults as TF
from repro_torch.core import pipeline as t_pipe
from repro_torch.core.synthesis import CNN2Gate
from repro_torch.kernels import ops, qconv, qgemm
from repro_torch.kernels import ref as t_ref
from repro_torch.models import cnn


def _i8(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))


def block_diagonal(w, groups, pack):
    """The HWIO weight (KH, KW, P*Cin/G, Cout) of G/P groups that packs each
    P neighbouring groups of ``w`` (KH, KW, Cin/G, Cout): output channel c
    keeps its weights at its own group's inputs, zeros at the others'."""
    kh, kw, cin_g, cout = w.shape
    cout_g = cout // groups
    bd = torch.zeros((kh, kw, pack * cin_g, cout), dtype=w.dtype)
    for c in range(cout):
        p = (c // cout_g) % pack
        bd[:, :, p * cin_g:(p + 1) * cin_g, c] = w[:, :, :, c]
    return bd


@pytest.mark.parametrize("groups,cout_g,pack", [
    (32, 4, 16), (32, 8, 8), (32, 16, 4), (32, 32, 2),   # ResNeXt-50
    (2, 48, 1), (2, 64, 1), (2, 192, 1), (2, 128, 1),    # AlexNet 2-tower
    (7, 20, 1), (5, 16, 1),                # no divisor of G above 1 fits
    (3, 16, 3), (3, 2, 3), (2, 4, 2), (64, 1, 64), (1, 4, 1), (1, 512, 1)])
def test_groups_per_tile(groups, cout_g, pack):
    assert qconv.groups_per_tile(groups, cout_g) == pack


def test_the_depthwise_route_never_packs():
    """A depthwise conv (G = Cin, one input a group) goes to the depthwise
    kernel, which stages no K-major weight and takes no plan of groups."""
    graph = cnn.mobilenet_tiny(batch=1)
    gate = CNN2Gate.from_graph(graph, device="cpu")
    gate.calibrate_quantization(np.zeros(graph.inputs[0].shape, np.float32))
    dw = [ql for ql in gate.quantized.layers if ql.info.is_dw_kernel]
    assert dw
    for ql in dw:
        assert ops.conv_route(ql.info.group, ql.info.c_in,
                              ql.w_q.shape) == "depthwise"
        assert ql.w_k is None and t_pipe.stage_kmajor(ql.info, ql.w_q) is None
    geo = qconv._geometry("qdwconv", "qdwconv2d", (1, 8, 8, 32),
                          (3, 3, 1, 32), (1, 8, 8, 32), 32, (1, 1), None, 0,
                          None, None, (0, 0, 0, 0), None, False,
                          (1, 1, 1, 1))
    assert isinstance(geo.plan, qconv.DwPlan)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "trials"])
@pytest.mark.parametrize("groups,cin_g,cout", [
    (32, 4, 128), (32, 8, 256), (32, 16, 512), (32, 32, 1024), (3, 3, 6),
    (2, 48, 96), (1, 16, 8)])
def test_the_packed_staging_is_the_block_diagonal_weight(groups, cin_g, cout,
                                                         lead):
    """``stage_kmajor(w, G)`` equals the plain K-major staging of the
    block-diagonal weight of the packed groups (at P = 1, of ``w``
    itself); a trials' stack stages image by image."""
    rng = np.random.default_rng(cout + cin_g)
    w = _i8(rng, lead + (3, 3, cin_g, cout))
    pack = qconv.groups_per_tile(groups, cout // groups)
    got = qconv.stage_kmajor(w, groups)
    images = [w[t] for t in range(lead[0])] if lead else [w]
    want = torch.stack([qgemm.stage_kmajor(
        block_diagonal(wi, groups, pack).reshape(-1, cout))
        for wi in images])
    assert torch.equal(got, want if lead else want[0])
    assert got.shape[-1] == qconv.k_padded(9 * pack * cin_g)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cin_g", [4, 8, 16, 32])
def test_the_block_diagonal_conv_of_g_over_p_groups_is_the_grouped_conv(
        cin_g, stride):
    """The plain version over G/P groups of the block-diagonal weight equals
    it over the G groups of the weight, bit for bit, at ResNeXt-50's
    widths, pads 1."""
    rng = np.random.default_rng(cin_g * 10 + stride)
    c = 32 * cin_g
    x = _i8(rng, (2, 7, 7, c))
    w = _i8(rng, (3, 3, cin_g, c))
    b = torch.from_numpy(rng.integers(-4000, 4000, c, np.int32))
    pack = qconv.groups_per_tile(32, cin_g)
    kw = dict(strides=(stride, stride), pads=(1, 1, 1, 1),
              shift=int(np.log2(9 * cin_g)) + 6)
    want = qconv.qconv2d_plain(x, w, b, groups=32, **kw)
    got = qconv.qconv2d_plain(x, block_diagonal(w, 32, pack), b,
                              groups=32 // pack, **kw)
    assert torch.equal(got, want)
    assert torch.equal(
        t_ref.int_conv_nhwc(t_ref.pad_nhwc(x, (1, 1, 1, 1)),
                            block_diagonal(w, 32, pack), (stride, stride),
                            32 // pack),
        t_ref.int_conv_nhwc(t_ref.pad_nhwc(x, (1, 1, 1, 1)), w,
                            (stride, stride), 32))
    assert 0 < int((want > 0).sum()) < want.numel()


#: (H of the padded input, C, stride, packed groups, K, K_pad, tiles):
#: ResNeXt-50's grouped 3x3s at batch 512, 32 groups of C / 32 channels
RESNEXT_PLANS = [
    (58, 128, 1, 2, 576, 640, 2 * 12544),
    (58, 256, 2, 4, 576, 640, 4 * 3136),
    (30, 256, 1, 4, 576, 640, 4 * 3136),
    (30, 512, 2, 8, 576, 640, 8 * 784),
    (16, 512, 1, 8, 576, 640, 8 * 784),
    (16, 1024, 2, 16, 576, 640, 16 * 196),
    (9, 1024, 1, 16, 576, 640, 16 * 196),
]


@pytest.mark.parametrize("case", RESNEXT_PLANS, ids=lambda c: str(c[:3]))
def test_the_plan_reports_the_packed_groups(case):
    """The plan of a packed conv: G/P groups, their K and K_pad, 64-column
    tiles, as many tiles as the dense conv of 64 channels a group; the
    geometry's gather is the packed group's 16-byte one."""
    hp, c, s, groups, k, k_pad, tiles = case
    pl = qconv.plan(512, hp, hp, c, 3, 3, c, (s, s), None, 32)
    assert (pl.groups, pl.k, pl.k_pad, pl.bn) == (groups, k, k_pad, 64)
    assert pl.tiles == tiles and pl.n_tiles == 1 and pl.splits == 1
    ho = (hp - 3) // s + 1
    geo = qconv._geometry("qconv", "qgconv2d", (512, hp - 2, hp - 2, c),
                          (3, 3, c // 32, c), (512, ho, ho, c), 32, (s, s),
                          None, 0, None, None, (0, 0, 0, 0), None, False,
                          (1, 1, 1, 1))
    assert geo.plan == pl and geo.width == 16


def test_an_unpacked_grouped_plan_is_as_before():
    """AlexNet two-tower's conv2 (G = 2, 128 outputs a group): P = 1, the
    groups and K of the conv itself."""
    pl = qconv.plan(64, 31, 31, 96, 5, 5, 256, (1, 1), (3, 2), 2)
    assert (pl.groups, pl.k, pl.bn, pl.n_tiles) == (2, 5 * 5 * 48, 128, 1)


@pytest.mark.parametrize("groups,cin_g,cout", [
    (32, 4, 128), (32, 32, 1024), (3, 3, 6), (2, 48, 96), (1, 16, 8),
    (1, 300, 70)])
def test_kmajor_position_is_where_the_staging_puts_each_element(
        groups, cin_g, cout):
    """Every element lands where ``kmajor_position`` says, and nothing else
    of the staging is non-zero; (1, 300, 70) is an FC's (K, N) weight, the
    case ``cin_g`` = K."""
    rng = np.random.default_rng(cout)
    fc = cin_g == 300
    w = _i8(rng, (cin_g, cout) if fc else (3, 3, cin_g, cout))
    w[w == 0] = 1
    staged = qgemm.stage_kmajor(w) if fc else qconv.stage_kmajor(w, groups)
    rows, cols = qconv.kmajor_position(torch.arange(w.numel()), cin_g, cout,
                                       groups)
    assert torch.equal(staged[rows, cols], w.reshape(-1))
    assert int((staged != 0).sum()) == w.numel()


def _grouped_net():
    """Two grouped convs packed into one tile each (8 groups of 4 outputs,
    P = 8; 16 groups of 2 inputs and 4 outputs, P = 16) between dense
    ones."""
    b = cnn.GraphBuilder("packed", (1, 3, 10, 10), 9)
    b.conv(32, 3, pad=1)
    b.conv(32, 3, pad=1, group=8)
    b.conv(64, 3, stride=2, pad=1, group=16)
    b.global_avgpool()
    b.fc(4, relu=False, softmax=True)
    return b.build()


def test_trial_weights_flip_the_packed_staging_as_inject_does():
    """Each weight element of the packed layers flipped in some trial (and
    tiles dropped): every trial's ``w_k`` image is ``inject``'s restaged
    ``w_k``, byte for byte, so a flip lands where the kernel reads it."""
    g = CNN2Gate.from_graph(_grouped_net(), device="cpu")
    g.calibrate_quantization((np.random.default_rng(4).standard_normal(
        g.parsed.input_shape) * 0.5).astype(np.float32))
    qm = g.quantized
    packed = [ql for ql in qm.layers if ql.info.group > 1]
    assert [qconv.groups_per_tile(ql.info.group, ql.info.c_out
                                  // ql.info.group) for ql in packed] \
        == [8, 16]
    names = [ql.info.name for ql in packed]
    plans = []
    for t in range(7):
        faults = []
        for ql in packed:
            size = ql.w_q.numel()
            faults += [TF.Fault(TF.WEIGHT_BIT, ql.info.name, index=i,
                                bit=(i + t) % 8)
                       for i in range(t, size, 7)]
        if t == 3:
            faults.append(TF.Fault(TF.DROPPED_TILE, names[1], tile=(5, 13)))
        plans.append(TF.FaultPlan(tuple(faults)))
    stacks = TF.trial_weights(qm, plans, names)
    for t, plan in enumerate(plans):
        inj = {ql.info.name: ql for ql in TF.inject(qm, plan).layers}
        for n, (w, wk) in stacks.items():
            assert torch.equal(w[t], inj[n].w_q), (t, n)
            assert torch.equal(wk[t], inj[n].w_k), (t, n)
            assert not torch.equal(wk[t], qm.layers[[
                ql.info.name for ql in qm.layers].index(n)].w_k)


def test_the_pack_counter_counts_kernel_launches_only():
    """Plain-version calls leave ``group_pack`` empty, and
    ``ops.reset_launch_counts`` empties it."""
    qconv.group_pack["16"] = 3
    ops.reset_launch_counts()
    assert qconv.group_pack == {}
    rng = np.random.default_rng(0)
    qconv.qgconv2d(_i8(rng, (1, 5, 5, 128)), _i8(rng, (3, 3, 4, 128)), None,
                   groups=32, pads=(1, 1, 1, 1), shift=8)
    assert qconv.group_pack == {}


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the grouped route runs a CUDA "
                    "kernel (the packing's CPU tests above run here)")
    return torch.device("cuda", 0)


def _operands(dev, n, h, c, cin_g, seed, trials=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead = () if trials is None else (trials,)
    x = torch.randint(-128, 128, ((trials or 1) * n, h, h, c), generator=gen,
                      device=dev, dtype=torch.int8)
    w = torch.randint(-128, 128, lead + (3, 3, cin_g, c), generator=gen,
                      device=dev, dtype=torch.int8)
    b = torch.randint(-4000, 4000, (c,), generator=gen, device=dev,
                      dtype=torch.int32)
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("pads", [(1, 1, 1, 1), (0, 1, 2, 1)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cin_g", [4, 8, 16, 32])
def test_the_packed_launch_equals_its_plain_version(card, cin_g, stride,
                                                    pads):
    """ResNeXt-50's four widths at batch 16, stride 1 and 2, its pads and
    asymmetric ones, with and without a staged weight, and the trial form
    (T = 3): ``torch.equal`` to the plain version, each launch counted
    under its P."""
    c, h = 32 * cin_g, {4: 20, 8: 14, 16: 10, 32: 7}[cin_g]
    pack = str(qconv.groups_per_tile(32, cin_g))
    kw = dict(groups=32, strides=(stride, stride), pads=pads,
              shift=int(np.log2(9 * cin_g)) + 6)
    x, w, b = _operands(card, 16, h, c, cin_g, seed=cin_g * 10 + stride)
    ops.reset_launch_counts()
    staged = qconv.qgconv2d(x, w, b, w_k=qconv.stage_kmajor(w, 32), **kw)
    own = qconv.qgconv2d(x, w, b, **kw)
    want = qconv.qconv2d_plain(x, w, b, **kw)
    xt, wt, bt = _operands(card, 4, h, c, cin_g, seed=cin_g, trials=3)
    trials = qconv.qgconv2d_trials(xt, wt, bt, **kw)
    want_t = t_ref.qconv2d_trials_ref(xt, wt, bt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(staged, want) and torch.equal(own, want)
    assert torch.equal(trials, want_t)
    assert 0 < int((want > 0).sum()) < want.numel()
    assert qconv.group_pack == {pack: 3}
    assert qconv.launches["qgconv2d"] == 2
    assert qconv.launches["qgconv2d_trials"] == 1


@pytest.mark.cuda
def test_one_packed_group_keeps_the_grouped_kernels_name(card):
    """16 groups of 4 channels pack into one (G/P = 1): the launches are
    still ``qconv_grouped_wgmma_kernel`` in a device trace, never the
    dense kernel, and equal their plain version.  Eight launches, of which
    the trace must hold one or more: a profile late in a long process can
    drop kernel records (one of four kept, after the README's other card
    files)."""
    from torch.profiler import ProfilerActivity, profile
    x, w, b = _operands(card, 8, 12, 64, 4, seed=3)
    kw = dict(groups=16, pads=(1, 1, 1, 1), shift=8)
    assert qconv.plan(8, 14, 14, 64, 3, 3, 64, (1, 1), None, 16).groups == 1
    w_k = qconv.stage_kmajor(w, 16)
    qconv.qgconv2d(x, w, b, w_k=w_k, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            y = qconv.qgconv2d(x, w, b, w_k=w_k, **kw)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    grouped = sum("qconv_grouped_wgmma_kernel" in n for n in names)
    assert 1 <= grouped <= 8, names
    assert not any("qconv_wgmma_kernel" in n for n in names), names
    assert torch.equal(y, qconv.qconv2d_plain(x, w, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("cin_g,cout_g", [(48, 128), (192, 192), (48, 64)])
def test_groups_of_64_channels_or_more_do_not_pack(card, cin_g, cout_g):
    """AlexNet two-tower's groups (and one of 64 outputs): P = 1, nothing
    counted under ``group_pack``, the result the plain version's."""
    gen = torch.Generator(device=card).manual_seed(cout_g)
    x = torch.randint(-128, 128, (4, 13, 13, 2 * cin_g), generator=gen,
                      device=card, dtype=torch.int8)
    w = torch.randint(-128, 128, (3, 3, cin_g, 2 * cout_g), generator=gen,
                      device=card, dtype=torch.int8)
    kw = dict(groups=2, pads=(1, 1, 1, 1), shift=12)
    ops.reset_launch_counts()
    y = qconv.qgconv2d(x, w, None, **kw)
    torch.cuda.synchronize()
    assert qconv.group_pack == {} and qconv.launches["qgconv2d"] == 1
    assert torch.equal(y, qconv.qconv2d_plain(x, w, None, **kw))

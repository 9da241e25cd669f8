"""The int8 tensor-core conv kernel's arithmetic, modelled on the CPU.

``csrc/qconv.cu``'s wgmma kernel cannot run here, so this file holds an
integer model of what it computes against the plain version and the JAX
package's oracle: 128-row tiles of (pooled pixel, window tap) pairs, the
im2col rows zero-padded in K, the K-major weight from
``qconv.stage_kmajor``, the K split that ``qconv.plan`` picks summed
split by split, then ``qconv.epilogue_plain`` and each tile's window max.
Every comparison is ``torch.equal``: integer sums are exact in any order
(the model sums in float64, exact below 2^53; every sum here is below
2^31, as the kernel's int32 needs).

It also pins the staging (K-major round trip, zero padding, 16-byte
rows), the tile and split chooser, and that executors built with and
without the staged operands agree.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro_torch.core import pipeline as t_pipe
from repro_torch.core.synthesis import CNN2Gate as TGate
from repro_torch.kernels import ops, qconv, qgemm
from repro_torch.kernels import ref as t_ref
from repro_torch.models import cnn as t_cnn


def _shapes(n, hp, wp, kh, kw, strides, pool):
    ho, wo = (hp - kh) // strides[0] + 1, (wp - kw) // strides[1] + 1
    pw, ps = pool if pool is not None else (1, 1)
    return ho, wo, pw, ps, (ho - pw) // ps + 1, (wo - pw) // ps + 1


def kernel_model(x, w, b, *, strides=(1, 1), shift=0, relu=True, pool=None,
                 groups=1, skip=None, skip_shifts=(0, 0), merge_shift=0,
                 merge_relu=False, out_buf=None, out_off=0, concat_shift=0,
                 concat_relu=False, sms=qconv.H100_SMS):
    """What the wgmma kernel computes, tile by tile, on the CPU."""
    n, hp, wp, cin = x.shape
    kh, kw, cin_g, cout = w.shape
    pl = qconv.plan(n, hp, wp, cin, kh, kw, cout, tuple(strides), pool,
                    groups, sms)
    assert pl.bn in (64, 128)
    ho, wo, pw, ps, oh, ow = _shapes(n, hp, wp, kh, kw, strides, pool)
    cout_g, k, bn = cout // groups, kh * kw * cin_g, pl.bn
    taps = pw * pw
    per_block = qconv.TILE_M // taps
    n_pooled = n * oh * ow
    wk = qconv.stage_kmajor(w).to(torch.float64)
    xf = x.to(torch.float64)
    acc = torch.full((n, ho, wo, cout), float("nan"), dtype=torch.float64)
    tiles_rows = []
    for blk in range(pl.m_tiles):
        # the tile's rows: (pooled pixel, tap) pairs, then the pixel each
        # computes; rows past the last window stay zero
        rows = []
        for r in range(qconv.TILE_M):
            p = blk * per_block + r // taps
            if r >= per_block * taps or p >= n_pooled:
                rows.append(None)
                continue
            t = r % taps
            img, rem = divmod(p, oh * ow)
            rows.append((img, (rem // ow) * ps + t // pw,
                         (rem % ow) * ps + t % pw))
        tiles_rows.append(rows)
        for g in range(groups):
            a = torch.zeros((qconv.TILE_M, pl.k_pad), dtype=torch.float64)
            for r, pix in enumerate(rows):
                if pix is not None:
                    img, ch, cw = pix
                    i0, j0 = ch * strides[0], cw * strides[1]
                    a[r, :k] = xf[img, i0:i0 + kh, j0:j0 + kw,
                                  g * cin_g:(g + 1) * cin_g].reshape(-1)
            for nt in range(pl.n_tiles):
                c0 = g * cout_g + nt * bn
                bt = torch.zeros((bn, pl.k_pad), dtype=torch.float64)
                live = min(bn, cout - c0)   # TMA reads zeros past Cout
                bt[:live] = wk[c0:c0 + live]
                tile = sum(a[:, s0 * qconv.K_TILE:s1 * qconv.K_TILE]
                           @ bt[:, s0 * qconv.K_TILE:s1 * qconv.K_TILE].T
                           for s0, s1 in pl.split_ranges())
                ncols = min(bn, cout_g - nt * bn)   # the group's edge
                for r, pix in enumerate(rows):
                    if pix is None:
                        continue
                    got = tile[r, :ncols]
                    prev = acc[pix + (slice(c0, c0 + ncols),)]
                    # a tap shared by two windows is computed twice, alike
                    assert torch.isnan(prev).all() or torch.equal(prev, got)
                    acc[pix + (slice(c0, c0 + ncols),)] = got
    # conv pixels that no window reads stay NaN; the rest fit int32
    assert acc[~torch.isnan(acc)].abs().max() < 2 ** 31
    y = qconv.epilogue_plain(
        torch.nan_to_num(acc).to(torch.int32), b, shift=shift, relu=relu,
        skip=skip, skip_shifts=skip_shifts, merge_shift=merge_shift,
        merge_relu=merge_relu, concat_shift=concat_shift,
        concat_relu=concat_relu)
    out = torch.empty((n, oh, ow, cout), dtype=torch.int8)
    for blk, rows in enumerate(tiles_rows):
        for pw_ in range(per_block):
            p = blk * per_block + pw_
            if p >= n_pooled:
                break
            win = [y[rows[pw_ * taps + t]] for t in range(taps)]
            img, rem = divmod(p, oh * ow)
            out[img, rem // ow, rem % ow] = torch.stack(win).max(0).values
    if out_buf is None:
        return out
    out_buf[..., out_off:out_off + cout] = out
    return out_buf


def _case_inputs(c, seed):
    """Seeded numpy operands of a case: (x, w, b, keywords)."""
    rng = np.random.default_rng(seed)
    g = c.get("groups", 1)
    hp = c["h"] + 2 * c.get("p", 0)
    cin_g = c["cin"] // g
    x = rng.integers(-128, 128, (c["n"], hp, hp, c["cin"]), dtype=np.int8)
    w = rng.integers(-128, 128, (c["k"], c["k"], cin_g, c["cout"]),
                     dtype=np.int8)
    depth = c["k"] * c["k"] * cin_g
    bound = int(2 * 5461 * math.sqrt(depth))
    b = rng.integers(-bound, bound, (c["cout"],), dtype=np.int32)
    s = max(0, min(31, int(math.log2(5461 * math.sqrt(depth) / 40))))
    shift = (tuple(int(v) for v in np.clip(
        s + rng.integers(-3, 4, c["cout"]), 0, 31))
        if c.get("per_lane") else s)
    kw = dict(strides=(c.get("s", 1),) * 2, shift=shift,
              relu=c.get("relu", True), pool=c.get("pool"), groups=g)
    if c.get("skip"):
        ho = (hp - c["k"]) // c.get("s", 1) + 1
        kw.update(skip=torch.from_numpy(rng.integers(
            -128, 128, (c["n"], ho, ho, c["cout"]), dtype=np.int8)),
            skip_shifts=(1, 0), merge_shift=1, merge_relu=True)
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), kw


# Layer shapes of VGG-16, AlexNet (one tower and two) and ResNet-18 at a
# reduced spatial size, and the ragged cases: Cin 3, Cin/G 9, Cout 130,
# 3 groups, pools 3/2 and 2/2, strides 2 and 4, skip, per-lane shifts;
# and googlenet_tiny's narrow convs, 4-12 channels (2 a group) on a
# 64-channel tile.
CASES = [
    dict(name="vgg_conv1_1_cin3", n=1, h=9, cin=3, cout=64, k=3, p=1),
    dict(name="vgg_conv1_2_pool", n=1, h=8, cin=64, cout=64, k=3, p=1,
         pool=(2, 2)),
    dict(name="vgg_conv3_1", n=1, h=6, cin=128, cout=256, k=3, p=1),
    dict(name="vgg_conv5_3_pool", n=1, h=5, cin=512, cout=512, k=3, p=1,
         pool=(2, 2)),
    dict(name="vgg_conv5_1_batch2", n=2, h=4, cin=512, cout=512, k=3, p=1),
    dict(name="alexnet_conv1_11x11_s4_pool3s2", n=1, h=31, cin=3, cout=64,
         k=11, s=4, p=2, pool=(3, 2)),
    dict(name="alexnet_2tower_conv2_g2_pool3s2", n=1, h=7, cin=96, cout=256,
         k=5, p=2, groups=2, pool=(3, 2)),
    dict(name="alexnet_2tower_conv4_g2_cout_g192", n=1, h=5, cin=384,
         cout=384, k=3, p=1, groups=2, per_lane=True),
    dict(name="resnet18_conv1_7x7_s2", n=1, h=16, cin=3, cout=64, k=7, s=2,
         p=3),
    dict(name="resnet18_block_skip", n=1, h=6, cin=64, cout=64, k=3, p=1,
         skip=True, relu=False),
    dict(name="resnet18_down_1x1_s2", n=1, h=8, cin=64, cout=128, k=1, s=2),
    dict(name="resnet18_conv_s2", n=1, h=8, cin=128, cout=256, k=3, s=2,
         p=1),
    dict(name="groups3_cin_g9", n=2, h=7, cin=27, cout=48, k=3, p=1,
         groups=3, pool=(2, 2)),
    dict(name="cout130_cin6", n=2, h=6, cin=6, cout=130, k=3, p=1,
         relu=False),
    dict(name="skip_pool_per_lane", n=2, h=6, cin=32, cout=48, k=3, p=1,
         skip=True, pool=(2, 2), per_lane=True),
    dict(name="per_lane_pool3s2", n=1, h=9, cin=16, cout=96, k=3, p=1,
         pool=(3, 2), per_lane=True),
    dict(name="googlenet_1x1_cout4", n=2, h=6, cin=16, cout=4, k=1),
    dict(name="googlenet_5x5_cout6_pool", n=2, h=8, cin=4, cout=6, k=5,
         p=2, pool=(2, 2)),
    dict(name="googlenet_3x3_cout12_into_pool", n=2, h=7, cin=8, cout=12,
         k=3, p=1, pool=(2, 2)),
    dict(name="groups3_cout_g2_per_lane", n=2, h=6, cin=9, cout=6, k=3,
         p=1, groups=3, per_lane=True),
]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
@pytest.mark.parametrize("sms", [qconv.H100_SMS, 1])
def test_kernel_model_equals_the_plain_version(case, sms):
    """Tiles, zero padding, the K split (sms 132: split where the grid is
    under a wave; sms 1: never), the epilogue and the windows: equal to
    ``qconv2d_plain`` bit for bit."""
    x, w, b, kw = _case_inputs(case, seed=len(case["name"]))
    got = kernel_model(x, w, b, sms=sms, **kw)
    want = qconv.qconv2d_plain(x, w, b, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [c for c in CASES if not c.get("skip")],
                         ids=[c["name"] for c in CASES if not c.get("skip")])
def test_kernel_model_equals_the_jax_oracle(case):
    """The same model against the JAX package's ``qconv2d_ref``."""
    x, w, b, kw = _case_inputs(case, seed=len(case["name"]))
    got = kernel_model(x, w, b, **kw)
    s = kw["shift"]
    want = r_ref.qconv2d_ref(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()), kw["strides"],
        jnp.asarray(s, jnp.int32) if isinstance(s, tuple) else s,
        kw["relu"], kw["pool"], kw["groups"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("off,c_tot,pool", [(17, 70, (2, 2)), (3, 40, None),
                                            (3, 131, (3, 2))])
def test_kernel_model_writes_its_concat_slice_only(off, c_tot, pool):
    """out_buf at odd offsets: the slice equals the plain version's and
    the sibling channels keep their sentinel."""
    case = dict(name=f"into{off}", n=2, h=8, cin=32, cout=30, k=3, p=1,
                pool=pool)
    x, w, b, kw = _case_inputs(case, seed=off)
    kw.update(concat_shift=1, concat_relu=True)
    _ho, _wo, _pw, _ps, oh, ow = _shapes(2, 10, 10, 3, 3, (1, 1), pool)
    sentinel = torch.full((2, oh, ow, c_tot), 77, dtype=torch.int8)
    got = kernel_model(x, w, b, out_buf=sentinel.clone(), out_off=off, **kw)
    want = qconv.qconv2d_plain(x, w, b, out_buf=sentinel.clone(),
                               out_off=off, **kw)
    assert torch.equal(got, want)
    others = torch.cat([got[..., :off], got[..., off + 30:]], dim=-1)
    assert bool((others == 77).all())


@pytest.mark.parametrize("shape", [(3, 3, 3, 64), (3, 3, 512, 512),
                                   (11, 11, 3, 96), (5, 5, 48, 256),
                                   (1, 1, 16, 8), (3, 3, 9, 130)])
def test_kmajor_staging_round_trips_and_pads_with_zeros(shape):
    kh, kw, cin_g, cout = shape
    w = torch.from_numpy(np.random.default_rng(cout).integers(
        -128, 128, shape, dtype=np.int8))
    wk = qconv.stage_kmajor(w)
    k = kh * kw * cin_g
    assert wk.dtype == torch.int8 and wk.is_contiguous()
    assert wk.shape == (cout, qconv.k_padded(k))
    assert wk.shape[1] % qconv.K_TILE == 0 and wk.shape[1] % 16 == 0
    assert wk.shape[1] - k < qconv.K_TILE
    assert not wk[:, k:].any()
    assert torch.equal(wk[:, :k].t().reshape(kh, kw, cin_g, cout), w)


# (N, Hp, Wp, Cin, KH, KW, Cout, strides, pool, groups) of the zoo's convs
VGG16 = [(224, 3, 64, None), (224, 64, 64, (2, 2)), (112, 64, 128, None),
         (112, 128, 128, (2, 2)), (56, 128, 256, None),
         (56, 256, 256, None), (56, 256, 256, (2, 2)), (28, 256, 512, None),
         (28, 512, 512, None), (28, 512, 512, (2, 2)), (14, 512, 512, None),
         (14, 512, 512, None), (14, 512, 512, (2, 2))]
PLAN_SHAPES = (
    [(n, h + 2, h + 2, cin, 3, 3, cout, (1, 1), pool, 1)
     for n in (1, 8) for h, cin, cout, pool in VGG16]
    + [(2, 228, 228, 3, 11, 11, 96, (4, 4), (3, 2), 1),
       (2, 31, 31, 96, 5, 5, 256, (1, 1), (3, 2), 2),
       (2, 15, 15, 256, 3, 3, 384, (1, 1), None, 1),
       (2, 15, 15, 384, 3, 3, 384, (1, 1), None, 2),
       (2, 15, 15, 384, 3, 3, 256, (1, 1), (3, 2), 2),
       (1, 230, 230, 3, 7, 7, 64, (2, 2), None, 1),
       (1, 58, 58, 64, 3, 3, 64, (1, 1), None, 1),
       (1, 28, 28, 128, 1, 1, 256, (2, 2), None, 1),
       (2, 14, 14, 27, 3, 3, 48, (1, 1), (2, 2), 3),
       (2, 12, 12, 16, 1, 1, 8, (1, 1), None, 1)])


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_the_split_covers_k_and_stays_within_a_wave(shape):
    n, hp, wp, cin, kh, kw, cout, strides, pool, groups = shape
    pl = qconv.plan(n, hp, wp, cin, kh, kw, cout, strides, pool, groups)
    assert pl.bn == (128 if cout // groups >= 128 else 64)
    ranges = pl.split_ranges()
    assert len(ranges) == pl.splits <= qconv.MAX_SPLITS
    assert all(s1 > s0 for s0, s1 in ranges)           # none is empty
    assert ranges[0][0] == 0 and ranges[-1][1] == pl.k_tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if pl.splits > 1:
        assert pl.tiles < qconv.H100_SMS and pl.blocks <= qconv.H100_SMS
        # no smaller chunk fits within a wave and the split cap
        smaller = pl.chunk - 1
        assert smaller == 0 or (
            math.ceil(pl.k_tiles / smaller)
            > min(qconv.H100_SMS // pl.tiles, qconv.MAX_SPLITS))
    else:   # a wave of tiles already, one K tile, or no room for two
        assert pl.tiles >= qconv.H100_SMS or pl.k_tiles == 1 \
            or qconv.H100_SMS // pl.tiles == 1


@pytest.mark.parametrize("h", [14, 28])
def test_the_late_vgg_layers_split_k_at_batch_1(h):
    """14x14x512 and 28x28x512 at batch 1 have 8 and 28 tiles of 128 x 128:
    their K is split so that the grid comes near one wave of 132 SMs, as
    near as ``MAX_SPLITS`` allows."""
    for pool in (None, (2, 2)):
        pl = qconv.plan(1, h + 2, h + 2, 512, 3, 3, 512, (1, 1), pool, 1)
        assert pl.splits > 1
        assert min(qconv.H100_SMS // 2, pl.tiles * qconv.MAX_SPLITS) \
            <= pl.blocks <= qconv.H100_SMS


def test_a_launch_works_out_each_shape_once():
    """Shape checks, the plan and the integer launch arguments are kept
    per distinct call: a second call of a shape finds them (here on
    ``meta`` tensors, which then fail the device check)."""
    x = torch.empty((1, 16, 16, 64), dtype=torch.int8, device="meta")
    w = torch.empty((3, 3, 64, 128), dtype=torch.int8, device="meta")
    qconv._geometry.cache_clear()
    for _ in range(3):
        with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
            qconv.qconv2d(x, w, None, shift=7, pool=(2, 2))
    info = qconv._geometry.cache_info()
    assert (info.misses, info.hits) == (1, 2)
    geo = qconv._geometry(
        "qconv", "qconv2d", x.shape, w.shape, (1, 7, 7, 128), 1, (1, 1),
        (2, 2), 0, None, None, (0, 0, 0, 0), None)
    assert geo.plan == qconv.plan(1, 16, 16, 64, 3, 3, 128, (1, 1), (2, 2))
    assert geo.head == (1, 16, 16, 64, 3, 3, 128, 1, 1, 2, 2)
    assert (geo.tail, geo.width, geo.wide) == ((128, 0), 16, True)
    with pytest.raises(ValueError, match="skip_shifts"):
        qconv.qconv2d(x, w, None, shift=7, skip_shifts=(32, 0),
                      skip=torch.empty((1, 14, 14, 128), dtype=torch.int8,
                                       device="meta"))


# ------------------------------------------ the narrow gather (Cin/G % 4)

def chunk_offsets_model(k0, kw, cin, cin_g, wp):
    """``csrc/qconv.cu:chunk_offsets``: the offsets of contraction bytes
    ``k0 .. k0 + 15`` from the window's first byte, walked a byte at a
    time from one division pair (past K too: the gather's mask leaves
    those bytes unloaded)."""
    t, ci = divmod(k0, cin_g)
    kh_, kw_ = divmod(t, kw)
    off = (kh_ * wp + kw_) * cin + ci
    o = []
    for e in range(16):
        o.append(off)
        off += 1
        ci += 1
        if ci == cin_g:
            ci = 0
            off += cin - cin_g
            kw_ += 1
            if kw_ == kw:
                kw_ = 0
                off += (wp - kw) * cin
    return o


def narrow_mapping(kv):
    """The narrow gather's threads over a K step whose first ``kv`` bytes
    hold data: the power-of-two chunk count ``nc``, the (row, chunk)
    pairs the 256 threads gather (thread t keeps chunk t % nc) and the
    (row, chunk) pairs they zero."""
    nc = 1
    while nc < 8 and 16 * nc < kv:
        nc *= 2
    gathered = [(r, t & (nc - 1)) for t in range(256)
                for r in range(t // nc, qconv.TILE_M, 256 // nc)]
    zeros = [(i >> 3, i & 7) for t in range(256)
             for i in range(t, qconv.TILE_M * 8, 256) if (i & 7) >= nc]
    return nc, gathered, zeros


def narrow_tile(x, blk, g, kb, *, kh, kw, strides, pool, groups):
    """The A tile (128 rows x one 128-byte K step) that the narrow gather
    of block ``blk``, group ``g`` builds from ``x``'s flat bytes, by the
    kernel's mapping and offsets; rows past the last window are zero."""
    n, hp, wp, cin = x.shape
    cin_g = cin // groups
    k_total = kh * kw * cin_g
    _ho, _wo, pw, ps, oh, ow = _shapes(n, hp, wp, kh, kw, strides, pool)
    taps = pw * pw
    per_block = qconv.TILE_M // taps
    flat = x.reshape(-1)
    row_off = []
    for r in range(qconv.TILE_M):
        p = blk * per_block + r // taps
        if r >= per_block * taps or p >= n * oh * ow:
            row_off.append(-1)
            continue
        img, rem = divmod(p, oh * ow)
        t = r % taps
        ch, cw = (rem // ow) * ps + t // pw, (rem % ow) * ps + t % pw
        row_off.append(((img * hp + ch * strides[0]) * wp + cw * strides[1])
                       * cin + g * cin_g)
    tile = torch.full((qconv.TILE_M, qconv.K_TILE), 99, dtype=torch.int8)
    _nc, gathered, zeros = narrow_mapping(k_total - kb)
    for r, c in gathered:
        o = chunk_offsets_model(kb + 16 * c, kw, cin, cin_g, wp)
        for e, oe in enumerate(o):
            ok = row_off[r] >= 0 and kb + 16 * c + e < k_total
            tile[r, 16 * c + e] = flat[row_off[r] + oe] if ok else 0
    for r, c in zeros:
        tile[r, 16 * c:16 * c + 16] = 0
    return tile, row_off


@pytest.mark.parametrize("kv", [1, 9, 16, 17, 27, 32, 33, 64, 65, 107, 128,
                                147, 363])
def test_the_narrow_gather_covers_each_row_chunk_once(kv):
    """Every (row, chunk) of a K step is gathered or zeroed exactly once,
    and every chunk that holds data is gathered, by a thread that keeps
    one chunk over all its rows."""
    nc, gathered, zeros = narrow_mapping(kv)
    assert nc in (1, 2, 4, 8) and (16 * nc >= min(kv, 128))
    pairs = gathered + zeros
    assert len(pairs) == len(set(pairs)) == qconv.TILE_M * 8
    assert {c for _r, c in gathered} == set(range(nc))
    assert all(16 * c >= kv for _r, c in zeros)


# (name, N, Hp, Cin, K, stride, pool, groups, Cout): the stems at full
# width (AlexNet's 11x11/4 with its fused 3x3/2 pool, VGG-16's 3x3 and
# ResNet-18's 7x7/2, all Cin 3) and the ragged cases of CASES
NARROW = [
    ("alexnet_conv1_11x11_s4_pool3s2", 1, 228, 3, 11, 4, (3, 2), 1, 64),
    ("vgg16_conv1_3x3_cin3", 1, 226, 3, 3, 1, None, 1, 64),
    ("resnet18_conv1_7x7_s2", 1, 230, 3, 7, 2, None, 1, 64),
    ("cout130_cin6", 2, 8, 6, 3, 1, None, 1, 130),
    ("groups3_cin_g9", 2, 9, 27, 3, 1, (2, 2), 3, 48),
]


@pytest.mark.parametrize("case", NARROW, ids=[c[0] for c in NARROW])
def test_the_narrow_gather_reads_the_windows_of_the_plain_conv(case):
    """The tiles that the narrow gather's mapping and offsets build hold
    each row's window, zero past K and past the last window: their
    products with the K-major weight are ``ref.int_conv_nhwc``'s sums at
    every row's pixel (the first, a middle and the last block of each
    conv, every group and K step)."""
    _name, n, hp, cin, k, s, pool, groups, cout = case
    rng = np.random.default_rng(hp + cin)
    x = torch.from_numpy(rng.integers(-128, 128, (n, hp, hp, cin),
                                      dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k, k, cin // groups, cout),
                                      dtype=np.int8))
    strides = (s, s)
    assert qconv._geometry("qconv", "t", x.shape, w.shape,
                           (n,) + _shapes(n, hp, hp, k, k, strides, pool)[4:]
                           + (cout,), groups, strides, pool, 0, None, None,
                           (0, 0, 0, 0), None).width == 1
    acc = t_ref.int_conv_nhwc(x, w, strides, groups)
    pl = qconv.plan(n, hp, hp, cin, k, k, cout, strides, pool, groups)
    wk = qconv.stage_kmajor(w).to(torch.int64)
    cout_g, k_total = cout // groups, k * k * (cin // groups)
    _ho, wo, _pw, _ps, _oh, _ow = _shapes(n, hp, hp, k, k, strides, pool)
    ho = acc.shape[1]
    for blk in sorted({0, pl.m_tiles // 2, pl.m_tiles - 1}):
        for g in range(groups):
            steps = [narrow_tile(x, blk, g, kb, kh=k, kw=k, strides=strides,
                                 pool=pool, groups=groups)
                     for kb in range(0, pl.k_pad, qconv.K_TILE)]
            a = torch.cat([t for t, _ro in steps], dim=1).to(torch.int64)
            row_off = steps[0][1]
            assert not a[:, k_total:].any()
            sums = a @ wk[g * cout_g:(g + 1) * cout_g].T
            for r, ro in enumerate(row_off):
                if ro < 0:
                    assert not a[r].any()
                    continue
                pix = (ro - g * (cin // groups)) // cin
                img, rem = divmod(pix, hp * hp)
                i0, j0 = divmod(rem, hp)
                want = acc[img, i0 // s, j0 // s,
                           g * cout_g:(g + 1) * cout_g]
                assert i0 // s < ho and j0 // s < wo
                assert torch.equal(sums[r].to(torch.int32), want)


@pytest.mark.parametrize("cin,groups,width", [
    (3, 1, 1), (6, 1, 1), (27, 3, 1), (9, 3, 1), (18, 2, 1),
    (4, 1, 4), (12, 1, 4), (8, 2, 4), (48, 1, 16), (64, 1, 16),
    (96, 2, 16), (384, 2, 16), (512, 1, 16)])
def test_geometry_picks_the_gather_by_the_groups_channels(cin, groups,
                                                          width):
    """Cin/G % 16 == 0: 16-byte cp.async; % 4 == 0: 4-byte; else the
    narrow gather (width 1), which the launch also takes for an input
    pointer that is not 4-byte aligned."""
    cout = 12 * groups
    geo = qconv._geometry("qconv", "qconv2d", (1, 10, 10, cin),
                          (3, 3, cin // groups, cout), (1, 8, 8, cout),
                          groups, (1, 1), None, 0, None, None, (0, 0, 0, 0),
                          None)
    assert geo.width == width


def test_the_narrow_gathers_offsets_must_fit_32_bits():
    xs, ws = (1, 12, 2 ** 26, 3), (11, 11, 3, 64)
    with pytest.raises(ValueError, match="32 bits"):
        qconv._geometry("qconv", "qconv2d", xs, ws, (1, 2, 2 ** 26 - 10, 64),
                        1, (1, 1), None, 0, None, None, (0, 0, 0, 0), None)


def test_the_gather_counter_counts_kernel_launches_only():
    """Plain-version calls leave ``gather_launches`` alone, as they leave
    ``launches``; ``ops.reset_launch_counts`` zeroes both."""
    qconv.gather_launches["narrow"] += 3
    ops.reset_launch_counts()
    assert qconv.gather_launches == {"16": 0, "4": 0, "narrow": 0}
    for c in CASES[:2]:
        x, w, b, kw = _case_inputs(c, seed=1)
        qconv.qconv2d(x, w, b, **{k: v for k, v in kw.items()
                                  if k != "groups"})
    assert qconv.gather_launches == {"16": 0, "4": 0, "narrow": 0}


# ------------------------------- the conv's zero padding in the A gathers

KFAR = -(1 << 29)   # csrc/qconv.cu:kFar, the origin of a row past the end


def padded_rows(xs, blk, g, *, kh, kw, strides, pads, pool, groups):
    """``csrc/qconv.cu``'s row set-up for block ``blk``, group ``g``, over
    the UNPADDED input of shape ``xs``: each row's window origin
    ``row_org`` (kFar past the last window), ``row_off`` (its first byte,
    negative where the origin lies above the first image) and the image
    it reads; and the kernel's ``interior`` flag of each row."""
    n, h, w, cin = xs
    pt, pl, pb, pr = pads
    _ho, _wo, pw, ps, oh, ow = _shapes(n, h + pt + pb, w + pl + pr, kh, kw,
                                       strides, pool)
    taps = pw * pw
    per_block = qconv.TILE_M // taps
    cin_g = cin // groups
    org, off, img_of = [], [], []
    for r in range(qconv.TILE_M):
        p = blk * per_block + r // taps
        if r >= per_block * taps or p >= n * oh * ow:
            org.append((KFAR, KFAR))
            off.append(0)
            img_of.append(-1)
            continue
        img, rem = divmod(p, oh * ow)
        t = r % taps
        ch, cw = (rem // ow) * ps + t // pw, (rem % ow) * ps + t % pw
        ih, iw = ch * strides[0] - pt, cw * strides[1] - pl
        org.append((ih, iw))
        off.append(((img * h + ih) * w + iw) * cin + g * cin_g)
        img_of.append(img)
    org = torch.tensor(org, dtype=torch.int64)
    interior = ((org[:, 0] >= 0) & (org[:, 0] <= h - kh)
                & (org[:, 1] >= 0) & (org[:, 1] <= w - kw))
    return org, torch.tensor(off, dtype=torch.int64), img_of, interior


def tap_walk(k0, kw, cin, cin_g, w):
    """:func:`chunk_offsets_model` over the unpadded width ``w``, and the
    tap (kh, kw) of each of the 16 bytes, walked from the chunk's first
    tap: the test a byte at a time that ``border_mask`` must equal."""
    o = chunk_offsets_model(k0, kw, cin, cin_g, w)
    t, ci = divmod(k0, cin_g)
    kh_, kw_ = divmod(t, kw)
    taps = []
    for _e in range(16):
        taps.append((kh_, kw_))
        ci += 1
        if ci == cin_g:
            ci = 0
            kw_ += 1
            if kw_ == kw:
                kw_ = 0
                kh_ += 1
    return o, taps


def border_mask_model(org, kh0, p0, *, kh, kw, h, w, cin_g):
    """``csrc/qconv.cu:border_mask`` for each row of ``org`` (rows, 2): bit
    e set where contraction byte k0 + e (the chunk that starts ``p0``
    bytes into kh row ``kh0`` of the window) has its tap inside the
    image; a mask of each kh row the chunk meets."""
    kh_lo = (-org[:, 0]).clamp_min(0)
    kh_hi = (h - org[:, 0]).clamp_max(kh)
    b0 = (-org[:, 1]).clamp_min(0) * cin_g
    b1 = (w - org[:, 1]).clamp_max(kw) * cin_g
    one = torch.ones_like(b0)
    m = torch.zeros_like(b0)
    kh_, e0 = kh0, -p0
    while e0 < 16:
        lo = (e0 + b0).clamp(0, 16)
        hi = (e0 + b1).clamp(0, 16)
        bits = ((one << hi) - 1) & ~((one << lo) - 1)
        m |= torch.where((kh_ >= kh_lo) & (kh_ < kh_hi) & (lo < hi), bits, 0)
        kh_, e0 = kh_ + 1, e0 + kw * cin_g
    return m


def padded_tile(x, blk, g, *, kh, kw, strides, pads, pool, groups, width):
    """The A rows (128 x K_pad) that the gather of ``width`` (16 or 4:
    cp.async, one tap a chunk, tested per (row, chunk); 1: the narrow
    gather, interior rows unmasked and border rows under
    :func:`border_mask_model`) builds from the unpadded ``x`` for block
    ``blk``, group ``g``."""
    n, h, w, cin = x.shape
    cin_g = cin // groups
    k_total = kh * kw * cin_g
    k_pad = qconv.k_padded(k_total)
    org, off, img_of, interior = padded_rows(
        x.shape, blk, g, kh=kh, kw=kw, strides=strides, pads=pads,
        pool=pool, groups=groups)
    flat = x.reshape(-1)
    plane = h * w * cin
    image = torch.tensor(img_of, dtype=torch.int64)

    def tap_in(khs, kws):          # (rows, taps) of csrc/qconv.cu:tap_in
        ih = org[:, :1] + torch.as_tensor(khs)[None, :]
        iw = org[:, 1:] + torch.as_tensor(kws)[None, :]
        return (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)

    def read(idx, mask):           # bytes at idx where mask, else 0
        assert bool(((idx >= 0) & (idx < flat.numel()))[mask].all())
        return torch.where(mask, flat[idx.clamp(0, flat.numel() - 1)],
                           torch.zeros((), dtype=torch.int8))

    a = torch.full((qconv.TILE_M, k_pad), 99, dtype=torch.int8)
    for kb in range(0, k_pad, qconv.K_TILE):
        if width > 1:
            for c in range(qconv.K_TILE // width):
                k = kb + width * c
                cols = slice(k, k + width)
                if k >= k_total:
                    a[:, cols] = 0
                    continue
                t, ci = divmod(k, cin_g)
                kh_, kw_ = divmod(t, kw)
                assert ci + width <= cin_g          # one tap a chunk
                ko = (kh_ * w + kw_) * cin + ci
                ok = tap_in([kh_], [kw_])          # (rows, 1)
                idx = off[:, None] + ko + torch.arange(width)[None, :]
                a[:, cols] = read(idx, ok.expand(-1, width))
            continue
        _nc, gathered, zeros = narrow_mapping(k_total - kb)
        for c in sorted({c for _r, c in gathered}):
            k0 = kb + 16 * c
            o, taps = tap_walk(k0, kw, cin, cin_g, w)
            o = torch.tensor(o, dtype=torch.int64)
            idx = off[:, None] + o[None, :]
            kin = (k0 + torch.arange(16) < k_total)[None, :]
            kh0 = k0 // cin_g // kw
            bm = border_mask_model(org, kh0, k0 - kh0 * kw * cin_g, kh=kh,
                                   kw=kw, h=h, w=w, cin_g=cin_g)
            border = ((bm[:, None] >> torch.arange(16)[None, :]) & 1).bool()
            # the mask is the taps' own test, byte by byte, on every row
            assert torch.equal(
                kin & border,
                kin & tap_in([t[0] for t in taps], [t[1] for t in taps]))
            mask = torch.where(interior[:, None], kin, kin & border)
            # an interior row's bytes, under K's mask alone, lie in its image
            inside = (idx >= image[:, None] * plane) \
                & (idx < (image[:, None] + 1) * plane)
            assert bool(inside[interior[:, None] & kin].all())
            a[:, kb + 16 * c:kb + 16 * c + 16] = read(idx, mask)
        for r, c in zeros:
            a[r, kb + 16 * c:kb + 16 * c + 16] = 0
    return a, org, interior


def im2col_rows(xp, blk, g, *, kh, kw, strides, pool, groups, k_pad):
    """The im2col rows of block ``blk``, group ``g`` over the padded input
    ``xp``: each row's window, zero past K and for rows past the end."""
    n, hp, wp, cin = xp.shape
    cin_g = cin // groups
    _ho, _wo, pw, ps, oh, ow = _shapes(n, hp, wp, kh, kw, strides, pool)
    taps = pw * pw
    per_block = qconv.TILE_M // taps
    a = torch.zeros((qconv.TILE_M, k_pad), dtype=torch.int8)
    windows = []
    for r in range(qconv.TILE_M):
        p = blk * per_block + r // taps
        if r >= per_block * taps or p >= n * oh * ow:
            windows.append(None)
            continue
        img, rem = divmod(p, oh * ow)
        t = r % taps
        i0 = ((rem // ow) * ps + t // pw) * strides[0]
        j0 = ((rem % ow) * ps + t % pw) * strides[1]
        a[r, :kh * kw * cin_g] = xp[img, i0:i0 + kh, j0:j0 + kw,
                                    g * cin_g:(g + 1) * cin_g].reshape(-1)
        windows.append((i0, j0))
    return a, windows


# (name, N, H, Cin, K, stride, pads, groups): the padded convs of VGG-16,
# AlexNet (one tower and the two-tower grouped conv2) and ResNet-18 at
# full size, one of each distinct shape, and asymmetric pads
PADDED = (
    [(f"vgg16_{h}x{h}x{cin}", 2, h, cin, 3, 1, (1, 1, 1, 1), 1)
     for h, cin in ((224, 3), (224, 64), (112, 64), (112, 128), (56, 128),
                    (56, 256), (28, 256), (28, 512), (14, 512))]
    + [("alexnet_conv1_11x11_s4", 2, 224, 3, 11, 4, (2, 2, 2, 2), 1),
       ("alexnet_conv2_5x5", 2, 27, 64, 5, 1, (2, 2, 2, 2), 1),
       ("alexnet_conv3_3x3", 2, 13, 192, 3, 1, (1, 1, 1, 1), 1),
       ("alexnet_conv4_3x3", 2, 13, 384, 3, 1, (1, 1, 1, 1), 1),
       ("alexnet_conv5_3x3", 2, 13, 256, 3, 1, (1, 1, 1, 1), 1),
       ("alexnet_2tower_conv2_g2", 2, 27, 96, 5, 1, (2, 2, 2, 2), 2),
       ("resnet18_conv1_7x7_s2", 2, 224, 3, 7, 2, (3, 3, 3, 3), 1)]
    + [(f"resnet18_{h}x{h}x{cin}_s{s}", 2, h, cin, 3, s, (1, 1, 1, 1), 1)
       for h, cin, s in ((56, 64, 1), (56, 64, 2), (28, 128, 1),
                         (28, 128, 2), (14, 256, 1), (14, 256, 2),
                         (7, 512, 1))]
    + [("asymmetric_cin3_1201", 2, 9, 3, 3, 1, (1, 2, 0, 1), 1),
       ("asymmetric_cin32_1201", 2, 9, 32, 3, 1, (1, 2, 0, 1), 1),
       ("asymmetric_cin32_s2_1201", 2, 10, 32, 3, 2, (1, 2, 0, 1), 1)])


@pytest.mark.parametrize("pool", [None, "fused"])
@pytest.mark.parametrize("case", PADDED, ids=[c[0] for c in PADDED])
def test_the_gathers_take_the_pads_of_the_padded_im2col(case, pool):
    """Each gather the conv's channels allow (16- and 4-byte cp.async with
    one predicate a (row, chunk), the narrow gather with one a byte on
    border rows), reading the UNPADDED input, builds the im2col rows of
    ``ref.pad_nhwc``'s output: in the first, a middle and the last block,
    and the block of the first image's last window, every group and K
    step.  The interior flag marks no row whose window crosses the
    border, and the padded convs have border rows."""
    name, n, h, cin, k, s, pads, groups = case
    pool = None if pool is None else (3, 2) if "alexnet" in name else (2, 2)
    rng = np.random.default_rng(h * cin + k)
    x = torch.from_numpy(rng.integers(-128, 128, (n, h, h, cin),
                                      dtype=np.int8))
    xp = t_ref.pad_nhwc(x, pads)
    strides = (s, s)
    cin_g = cin // groups
    widths = [wd for wd in (16, 4) if cin_g % wd == 0] + [1]
    pl = qconv.plan(n, *xp.shape[1:], k, k, 64 * groups, strides, pool,
                    groups)
    _ho, _wo, pw, _ps, oh, ow = _shapes(n, *xp.shape[1:3], k, k, strides,
                                        pool)
    per_block = qconv.TILE_M // (pw * pw)
    blocks = sorted({0, pl.m_tiles // 2, pl.m_tiles - 1,
                     (oh * ow - 1) // per_block})
    borders = 0
    for blk in blocks:
        for g in range(groups):
            want, windows = im2col_rows(xp, blk, g, kh=k, kw=k,
                                        strides=strides, pool=pool,
                                        groups=groups, k_pad=pl.k_pad)
            for width in widths:
                got, org, interior = padded_tile(
                    x, blk, g, kh=k, kw=k, strides=strides, pads=pads,
                    pool=pool, groups=groups, width=width)
                assert torch.equal(got, want), (blk, g, width)
            for r, win in enumerate(windows):
                assert (win is None) == (int(org[r, 0]) == KFAR)
                if win is None:
                    assert not interior[r]
                    continue
                i0, j0 = win   # the window in the padded input
                crosses = (i0 < pads[0] or i0 + k > pads[0] + h
                           or j0 < pads[1] or j0 + k > pads[1] + h)
                assert not (interior[r] and crosses)
                assert bool(interior[r]) == (not crosses)
                borders += crosses
    assert borders > 0


@pytest.mark.parametrize("pads,hw", [((0, 0, 0, 0), 8), ((1, 1, 1, 1), 8),
                                     ((2, 0, 1, 3), 9), ((3, 3, 3, 3), 4)])
def test_the_geometry_plans_the_padded_shape(pads, hw):
    """``_geometry`` takes the unpadded input and the pads: the plan is
    that of the padded shape, the launch's head keeps the unpadded one,
    and pads are part of the key (two pads, two entries)."""
    xs, ws = (2, hw, hw, 32), (3, 3, 32, 64)
    hp, wp = hw + pads[0] + pads[2], hw + pads[1] + pads[3]
    ho, wo = hp - 2, wp - 2
    geo = qconv._geometry("qconv", "qconv2d", xs, ws, (2, ho, wo, 64), 1,
                          (1, 1), None, 0, None, None, (0, 0, 0, 0), None,
                          False, pads)
    assert geo.plan == qconv.plan(2, hp, wp, 32, 3, 3, 64)
    assert geo.head[:3] == (2, hw, hw) and geo.pads == pads
    with pytest.raises(ValueError, match="cannot hold"):
        qconv._geometry("qconv", "qconv2d", xs, ws, (2, hw - 2, hw - 2, 64),
                        1, (1, 1), None, 0, None, None, (0, 0, 0, 0), None,
                        False, (0, 0, 0, 1) if any(pads) else (1, 0, 0, 0))
    with pytest.raises(ValueError, match="pads"):
        qconv._geometry("qconv", "qconv2d", xs, ws, (2, ho, wo, 64), 1,
                        (1, 1), None, 0, None, None, (0, 0, 0, 0), None,
                        False, (-1, 0, 0, 0))


def test_the_depthwise_kernel_refuses_pads():
    """The depthwise kernel stages halo bands of a pre-padded input: its
    caller pads (``ops.qconv2d_nhwc``), and ``_geometry`` refuses pads."""
    with pytest.raises(ValueError, match="pads"):
        qconv._geometry("qdwconv", "qdwconv2d", (1, 8, 8, 16), (3, 3, 1, 16),
                        (1, 8, 8, 16), 16, (1, 1), None, 0, None, None,
                        (0, 0, 0, 0), None, False, (1, 1, 1, 1))


@pytest.mark.parametrize("pads", [(1, 1, 1, 1), (1, 2, 0, 1)])
def test_the_cpu_path_pads_before_the_plain_version(pads):
    """On the CPU ``qconv2d(x, pads=...)`` and its into, grouped and trial
    forms are the plain version over ``ref.pad_nhwc(x, pads)``; a padded
    call counts no ``padded_launches``."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(sum(pads))
    x = torch.from_numpy(rng.integers(-128, 128, (4, 7, 7, 8), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (3, 3, 8, 6), dtype=np.int8))
    wg = torch.from_numpy(rng.integers(-128, 128, (3, 3, 4, 6),
                                       dtype=np.int8))
    xp = t_ref.pad_nhwc(x, pads)
    kw = dict(shift=9, pool=(2, 2))
    assert torch.equal(qconv.qconv2d(x, w, None, pads=pads, **kw),
                       qconv.qconv2d_plain(xp, w, None, **kw))
    buf = torch.zeros((4,) + qconv.qconv2d_plain(xp, w, None, **kw)
                      .shape[1:3] + (9,), dtype=torch.int8)
    assert torch.equal(
        qconv.qconv2d(x, w, None, pads=pads, out_buf=buf.clone(), out_off=3,
                      **kw),
        qconv.qconv2d_plain(xp, w, None, out_buf=buf.clone(), out_off=3,
                            **kw))
    assert torch.equal(qconv.qgconv2d(x, wg, None, groups=2, pads=pads, **kw),
                       qconv.qconv2d_plain(xp, wg, None, groups=2, **kw))
    ws = torch.stack([w, w.flip(0)])
    assert torch.equal(qconv.qconv2d_trials(x, ws, None, pads=pads, **kw),
                       t_ref.qconv2d_trials_ref(xp, ws, None, **kw))
    wgs = torch.stack([wg, -wg.clamp_min(-127)])
    assert torch.equal(
        qconv.qgconv2d_trials(x, wgs, None, groups=2, pads=pads, **kw),
        t_ref.qconv2d_trials_ref(xp, wgs, None, groups=2, **kw))
    assert qconv.padded_launches == {"16": 0, "4": 0, "narrow": 0}


def _strip_staged(qm):
    qm2 = t_pipe.QuantizedModel(qm.name, [], qm.input_m, qm.output_m,
                                qm.parsed, qm.device)
    for ql in qm.layers:
        qm2.layers.append(t_pipe.QuantizedLayer(
            ql.info, ql.spec, ql.w_q, ql.b_q, ql.operand_shifts,
            ql.merge_spec))
    return qm2


@pytest.mark.parametrize("net,per_channel", [("resnet_tiny", True),
                                             ("resnet_tiny", False),
                                             ("googlenet_tiny", True),
                                             ("mobilenet_tiny", True)])
def test_executors_with_and_without_staged_operands_agree(net, per_channel):
    graph = getattr(t_cnn, net)(batch=2, seed=3)
    hw = graph.inputs[0].shape[2]
    x = np.random.default_rng(5).standard_normal(
        (2, 3, hw, hw)).astype(np.float32)
    gate = TGate.from_graph(graph, device="cpu")
    gate.calibrate_quantization(x, per_channel=per_channel)
    qm = gate.quantized
    convs = [ql for ql in qm.layers if ql.info.kind == "conv"]
    for ql in convs:
        dw = ql.info.group > 1 and ql.w_q.shape[2] == 1 \
            and ql.info.group == ql.info.c_in
        assert (ql.w_k is None) == dw
        if ql.w_k is not None:
            assert torch.equal(ql.w_k, qconv.stage_kmajor(ql.w_q))
    weighted = [ql for ql in qm.layers if ql.info.kind in ("conv", "fc")]
    for ql in weighted:
        assert (ql.shift_vec is not None) == per_channel
        if per_channel:
            assert ql.shift_vec.dtype == torch.int32
            assert ql.shift_vec.tolist() == list(ql.spec.requant_shift)
    staged = t_pipe.make_executor(qm)(x)
    plain = t_pipe.make_executor(_strip_staged(qm))(x)
    assert torch.equal(staged, plain)


def test_shift_args_takes_a_staged_vector_as_it_is():
    lanes = (3, 0, 31, 7)
    staged = qgemm.stage_shift(lanes, 4, "cpu")
    s, vec = qgemm.shift_args(lanes, 4, "cpu", staged)
    assert s == 0 and vec is staged
    assert qgemm.stage_shift(5, 4, "cpu") is None
    with pytest.raises(ValueError):
        qgemm.shift_args(lanes, 5, "cpu", staged)
    with pytest.raises(ValueError):
        qgemm.shift_args(5, 4, "cpu", staged)
    with pytest.raises(ValueError):
        qgemm.stage_shift((3, 32, 0, 0), 4, "cpu")


def test_the_plain_versions_ignore_the_staged_copies():
    case = dict(name="staged", n=1, h=6, cin=16, cout=24, k=3, p=1,
                per_lane=True, pool=(2, 2))
    x, w, b, kw = _case_inputs(case, seed=9)
    vec = qgemm.stage_shift(kw["shift"], 24, "cpu")
    want = qconv.qconv2d_plain(x, w, b, **kw)
    kw.pop("groups")
    got = qconv.qconv2d(x, w, b, w_k=qconv.stage_kmajor(w), shift_vec=vec,
                        **kw)
    assert torch.equal(got, want)
    xm = torch.from_numpy(np.random.default_rng(2).integers(
        -128, 128, (3, 40), dtype=np.int8))
    wm = torch.from_numpy(np.random.default_rng(3).integers(
        -128, 128, (40, 4), dtype=np.int8))
    lanes = (2, 3, 4, 5)
    assert torch.equal(
        qgemm.qgemm(xm, wm, None, shift=lanes,
                    shift_vec=qgemm.stage_shift(lanes, 4, "cpu")),
        t_ref.qgemm_ref(xm, wm, None, lanes, False))

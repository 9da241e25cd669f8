"""The depthwise conv kernel's band tiling, modelled in integers on the CPU.

``csrc/qdwconv.cu`` cannot run here, so this file holds an integer model
of what it computes, block by block, against the plain version and the
JAX package's oracles: each block of ``qconv.dw_plan`` stages its band
of input rows and columns, halo included, from the unpadded input, a
pixel in the conv's pads as zeros, with column ``cl`` holding
input channel ``(c0 + cl) // m`` (zero past Cout); it computes the
band's conv values in 4-channel lanes over runs of ``DW_RUN`` output
columns; the epilogue (``qconv.epilogue_plain``) runs on them; a fused
pool takes each window's max from the band's own conv values (a window
that straddles two bands sees the halo rows each band computes for
itself); the block writes its channel slice of its output rows.  The
oracles are ``repro.kernels.ref.qconv2d_ref`` with groups = Cin,
``qadd_ref``, ``qconcat_ref`` and ``maxpool2d_ref``, composed as in
``tests/test_torch_dwconv.py``.  Every comparison is ``torch.equal``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro_torch.kernels import qconv
from repro_torch.kernels import ref as t_ref


def band_model(x, w, b, *, strides=(1, 1), pads=(0, 0, 0, 0), shift=0,
               relu=True, pool=None, skip=None, skip_shifts=(0, 0),
               merge_shift=0, merge_relu=False, out_buf=None, out_off=0,
               concat_shift=0, concat_relu=False, sms=qconv.H100_SMS,
               smem_cap=qconv.DW_SMEM):
    """What the depthwise kernel computes, block by block, over the
    unpadded ``x`` and the conv's ``pads`` (top, left, bottom, right)."""
    n, h, wd, cin = x.shape
    pt, pl_, pb, pr = pads
    hp, wp = h + pt + pb, wd + pl_ + pr
    kh, kw, _, cout = w.shape
    m = cout // cin
    sh, sw = strides
    pw, ps = pool if pool is not None else (1, 1)
    pooled = (pw, ps) != (1, 1)
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    oh, ow = (ho - pw) // ps + 1, (wo - pw) // ps + 1
    pl = qconv.dw_plan(n, hp, wp, cin, kh, kw, cout, tuple(strides), pool,
                       sms, smem_cap)
    assert pl.cb % 4 == 0 and pl.cb <= 32
    assert pl.smem == qconv.dw_smem(pl.rp, pl.cp, pl.cb, kh, kw, strides,
                                    pool) <= smem_cap
    out = (torch.empty((n, oh, ow, cout), dtype=torch.int8)
           if out_buf is None else out_buf)
    written = torch.zeros((n, oh, ow, cout), dtype=torch.int64)
    xf, wf = x.to(torch.int64), w.to(torch.int64)
    for img in range(n):
        for rb in range(pl.row_bands):
            for cbd in range(pl.col_bands):
                for g in range(pl.groups):
                    p0, q0, c0 = rb * pl.rp, cbd * pl.cp, g * pl.cb
                    rp, cp = min(pl.rp, oh - p0), min(pl.cp, ow - q0)
                    rc, wc = (rp - 1) * ps + pw, (cp - 1) * ps + pw
                    ri, wi = (rc - 1) * sh + kh, (wc - 1) * sw + kw
                    cr0, cc0 = p0 * ps, q0 * ps
                    chans = [c for c in range(c0, c0 + pl.cb) if c < cout]
                    # the stage: padded-input pixel (cr0*sh + r, cc0*sw +
                    # col) is pixel (iy, ix) of x, zeros outside x; input
                    # channel c // m at column c - c0
                    iy = torch.arange(ri) + cr0 * sh - pt
                    ix = torch.arange(wi) + cc0 * sw - pl_
                    ry = ((iy >= 0) & (iy < h)).nonzero()[:, 0]
                    rx = ((ix >= 0) & (ix < wd)).nonzero()[:, 0]
                    band = torch.zeros((ri, wi, pl.cb), dtype=torch.int64)
                    band[ry[:, None], rx[None, :], :len(chans)] = xf[
                        img][iy[ry][:, None], ix[rx][None, :]][
                        ..., [c // m for c in chans]]
                    taps = torch.zeros((kh, kw, pl.cb), dtype=torch.int64)
                    taps[..., :len(chans)] = wf[:, :, 0, c0:c0 + len(chans)]
                    conv = torch.zeros((rc, wc, pl.cb), dtype=torch.int64)
                    # 4-channel lanes; the kernel's runs of DW_RUN conv
                    # columns split the band's columns among its threads,
                    # and each column's sums read that column's taps
                    # alone, so the model sums every column at once
                    for qd in range(pl.cb // 4):
                        if c0 + 4 * qd >= cout:
                            continue
                        ln = slice(4 * qd, 4 * qd + 4)
                        for i in range(kh):
                            for j in range(kw):
                                conv[..., ln] += (
                                    band[i:i + (rc - 1) * sh + 1:sh,
                                         j:j + (wc - 1) * sw + 1:sw, ln]
                                    * taps[i, j, ln])
                    assert conv.abs().max() < 2 ** 31
                    sl = slice(c0, c0 + len(chans))
                    kw_ = dict(relu=relu, merge_shift=merge_shift,
                               merge_relu=merge_relu,
                               concat_shift=concat_shift,
                               concat_relu=concat_relu,
                               shift=(tuple(shift[c] for c in chans)
                                      if isinstance(shift, tuple)
                                      else shift))
                    if skip is not None:
                        kw_.update(skip=skip[img, cr0:cr0 + rc,
                                             cc0:cc0 + wc, sl],
                                   skip_shifts=skip_shifts)
                    v = qconv.epilogue_plain(
                        conv[..., :len(chans)].to(torch.int32),
                        None if b is None else b[sl], **kw_)
                    if pooled:   # windows from the band's own values
                        y = torch.stack([torch.stack([
                            v[pr * ps:pr * ps + pw,
                              q * ps:q * ps + pw].reshape(-1, len(chans))
                            .max(0).values for q in range(cp)])
                            for pr in range(rp)])
                    else:
                        y = v
                    out[img, p0:p0 + rp, q0:q0 + cp,
                        out_off + c0:out_off + c0 + len(chans)] = y
                    written[img, p0:p0 + rp, q0:q0 + cp, sl] += 1
    assert bool((written == 1).all())   # every output written once
    return out


def _case(c, seed):
    """Seeded operands of case ``c``.  Without ``pads`` in it, x is the
    padded input itself (``p`` a side); with them, x is unpadded and
    ``pads`` go to the call."""
    rng = np.random.default_rng(seed)
    pads = c.get("pads")
    if pads is None:
        hp = wp = xh = c["h"] + 2 * c.get("p", 1)
    else:
        xh = c["h"]
        hp, wp = xh + pads[0] + pads[2], xh + pads[1] + pads[3]
    cout = c["cin"] * c.get("m", 1)
    x = torch.from_numpy(rng.integers(-128, 128, (c["n"], xh, xh, c["cin"]),
                                      dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (c["k"], c["k"], 1, cout),
                                      dtype=np.int8))
    b = torch.from_numpy(rng.integers(-2 ** 12, 2 ** 12, (cout,),
                                      dtype=np.int32))
    base = max(0, int(np.log2(74 * 74 * c["k"] / 40)))
    shift = (tuple(int(v) for v in rng.integers(max(0, base - 2), base + 3,
                                                cout))
             if c.get("per_lane") else base)
    kw = dict(strides=(c.get("s", 1),) * 2, shift=shift,
              relu=c.get("relu", True), pool=c.get("pool"))
    if pads is not None:
        kw.update(pads=pads)
    if c.get("skip"):
        ho = (hp - c["k"]) // c.get("s", 1) + 1
        wo = (wp - c["k"]) // c.get("s", 1) + 1
        kw.update(skip=torch.from_numpy(rng.integers(
            -128, 128, (c["n"], ho, wo, cout), dtype=np.int8)),
            skip_shifts=(1, 0), merge_shift=1, merge_relu=True)
    return x, w, b, kw


# mobilenet_tiny's three depthwise layers at a reduced size; strides 1, 2
# and 3; m = 2, 3 and 4; pools 2/2, 3/2 (3x3/2 windows straddle one-row
# bands) and 3/3; 130 and 15 channels (a last lane group of 2 and 3
# channels), 130 with the skip; a 5x5 window
CASES = [
    dict(name="mobilenet_dw1_s1", n=1, h=14, cin=16, k=3),
    dict(name="mobilenet_dw2_s2", n=1, h=14, cin=32, k=3, s=2),
    dict(name="mobilenet_dw3_s1_batch2", n=2, h=7, cin=64, k=3,
         per_lane=True),
    dict(name="stride3", n=2, h=13, cin=16, k=3, s=3),
    dict(name="m2", n=2, h=9, cin=12, m=2, k=3),
    dict(name="m4_s2_per_lane", n=1, h=11, cin=8, m=4, k=3, s=2,
         per_lane=True),
    dict(name="pool2s2", n=2, h=10, cin=32, k=3, pool=(2, 2)),
    dict(name="m2_pool3s2_per_lane", n=1, h=11, cin=16, m=2, k=3,
         pool=(3, 2), per_lane=True),
    dict(name="pool3s2_batch4", n=4, h=12, cin=8, k=3, pool=(3, 2)),
    dict(name="c130_skip", n=1, h=8, cin=130, k=3, skip=True, relu=False),
    dict(name="c130_skip_pool2s2_per_lane", n=1, h=8, cin=130, k=3,
         skip=True, pool=(2, 2), per_lane=True, relu=False),
    dict(name="c20_ragged_lanes", n=2, h=9, cin=20, k=3, per_lane=True),
    dict(name="k5", n=1, h=9, cin=24, k=5, p=2),
    dict(name="m3_c5_s2_pool3s3", n=2, h=15, cin=5, m=3, k=3, s=2,
         pool=(3, 3)),
]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
@pytest.mark.parametrize("sms", [qconv.H100_SMS, 3, 1])
def test_band_model_equals_the_plain_version(case, sms):
    """sms 132: one-row bands narrowed into column bands at batch 1;
    sms 3 and 1: several rows a band, so pool windows fall inside and
    across band edges."""
    x, w, b, kw = _case(case, seed=len(case["name"]))
    got = band_model(x, w, b, sms=sms, **kw)
    want = qconv.qdwconv2d_plain(x, w, b, **kw)
    assert torch.equal(got, want)


# MobileNetV2's depthwise convs, 3x3 with pad 1: (H, C, stride) of each
# distinct shape of its 17 at 224x224; then asymmetric pads, pads on
# each staging (16- and 4-byte copies, m > 1's byte gather), several rows
# a band (sms 3), a fused pool, a skip and a 5x5 window
MOBILENET_V2_DW = ((112, 32, 1), (112, 96, 2), (56, 144, 1), (56, 144, 2),
                   (28, 192, 1), (28, 192, 2), (14, 384, 1), (14, 576, 1),
                   (14, 576, 2), (7, 960, 1))
PADDED_CASES = (
    [dict(name=f"mobilenet_v2_{h}x{c}_s{s}", n=1 if h > 28 else 2, h=h,
          cin=c, k=3, s=s, pads=(1, 1, 1, 1), relu=True)
     for h, c, s in MOBILENET_V2_DW]
    + [dict(name="asym_1201", n=2, h=9, cin=16, k=3, pads=(1, 2, 0, 1)),
       dict(name="asym_1201_s2_sms3", n=2, h=10, cin=32, k=3, s=2,
            pads=(1, 2, 0, 1), sms=3),
       dict(name="asym_0031_c20_sms1", n=1, h=8, cin=20, k=3,
            pads=(0, 0, 3, 1), per_lane=True, sms=1),
       dict(name="m2_byte_gather", n=2, h=9, cin=12, m=2, k=3,
            pads=(1, 1, 1, 1)),
       dict(name="m3_c5_s2_asym", n=1, h=11, cin=5, m=3, k=3, s=2,
            pads=(1, 2, 0, 1)),
       dict(name="pool2s2_sms3", n=2, h=10, cin=32, k=3, pool=(2, 2),
            pads=(1, 1, 1, 1), sms=3),
       dict(name="m2_pool3s2_asym", n=1, h=11, cin=16, m=2, k=3,
            pool=(3, 2), pads=(1, 2, 0, 1), per_lane=True),
       dict(name="c130_skip_pool2s2", n=1, h=8, cin=130, k=3, skip=True,
            pool=(2, 2), pads=(1, 1, 1, 1), relu=False),
       dict(name="k5_p2_sms3", n=1, h=9, cin=24, k=5, pads=(2, 2, 2, 2),
            sms=3)])


@pytest.mark.parametrize("case", PADDED_CASES,
                         ids=[c["name"] for c in PADDED_CASES])
def test_the_padded_band_staging_equals_the_plain_version(case):
    """The kernel's band staging takes the conv's pads: the model over
    the unpadded x and ``pads`` equals the plain version over
    ``ref.pad_nhwc(x, pads)``, so no padded copy is needed."""
    x, w, b, kw = _case(case, seed=len(case["name"]) + 3)
    pads = kw.pop("pads")
    got = band_model(x, w, b, pads=pads, sms=case.get("sms", qconv.H100_SMS),
                     **kw)
    want = qconv.qdwconv2d_plain(t_ref.pad_nhwc(x, pads), w, b, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", CASES[:9] + CASES[11:],
                         ids=[c["name"] for c in CASES[:9] + CASES[11:]])
def test_band_model_equals_the_jax_oracle(case):
    x, w, b, kw = _case(case, seed=len(case["name"]) + 1)
    got = band_model(x, w, b, **kw)
    s = kw["shift"]
    want = r_ref.qconv2d_ref(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()), kw["strides"],
        jnp.asarray(s, jnp.int32) if isinstance(s, tuple) else s,
        kw["relu"], kw["pool"], x.shape[-1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pool", [None, (2, 2)], ids=["nopool", "pool2s2"])
def test_band_model_with_skip_equals_the_jax_oracles(pool):
    """The fused skip: the conv, ``qadd_ref`` and the pool in sequence."""
    case = dict(name="skip", n=2, h=9, cin=20, k=3, skip=True, relu=False,
                pool=pool)
    x, w, b, kw = _case(case, seed=11)
    got = band_model(x, w, b, **kw)
    conv = r_ref.qconv2d_ref(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                             jnp.asarray(b.numpy()), (1, 1), kw["shift"],
                             False, None, 20)
    want = r_ref.qadd_ref([conv, jnp.asarray(kw["skip"].numpy())],
                          kw["skip_shifts"], kw["merge_shift"],
                          kw["merge_relu"])
    if pool is not None:
        want = r_ref.maxpool2d_ref(want, *pool)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("off,c_tot,pool", [(17, 70, (2, 2)), (3, 40, None),
                                            (5, 29, (3, 2))])
def test_band_model_writes_its_concat_slice_only(off, c_tot, pool):
    """out_buf at odd offsets and an odd channel stride: the slice equals
    the plain version's and ``qconcat_ref``'s, the siblings keep their
    sentinel."""
    case = dict(name=f"into{off}", n=2, h=9, cin=12, m=2, k=3, pool=pool,
                relu=False)
    x, w, b, kw = _case(case, seed=off)
    kw.update(concat_shift=1, concat_relu=True)
    ho = 9
    oh = ho if pool is None else (ho - pool[0]) // pool[1] + 1
    sentinel = torch.full((2, oh, oh, c_tot), 77, dtype=torch.int8)
    got = band_model(x, w, b, out_buf=sentinel.clone(), out_off=off, **kw)
    want = qconv.qdwconv2d_plain(x, w, b, out_buf=sentinel.clone(),
                                 out_off=off, **kw)
    assert torch.equal(got, want)
    others = torch.cat([got[..., :off], got[..., off + 24:]], dim=-1)
    assert bool((others == 77).all())
    conv = r_ref.qconv2d_ref(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                             jnp.asarray(b.numpy()), (1, 1), kw["shift"],
                             False, None, 12)
    ref = r_ref.qconcat_ref([conv], [1], axis=-1, relu=True)
    if pool is not None:
        ref = r_ref.maxpool2d_ref(ref, *pool)
    np.testing.assert_array_equal(got[..., off:off + 24].numpy(),
                                  np.asarray(ref))


# (N, Hp, Wp, Cin, KH, KW, Cout, strides, pool): mobilenet_tiny@224's
# three depthwise layers at batch 1 and 8, dw_concat's and odd shapes
PLAN_SHAPES = (
    [(n, h + 2, h + 2, c, 3, 3, c, (s, s), None)
     for n in (1, 8) for h, c, s in ((112, 16, 1), (112, 32, 2),
                                     (56, 64, 1))]
    + [(2, 14, 14, 8, 3, 3, 16, (1, 1), None),
       (8, 58, 58, 32, 3, 3, 32, (1, 1), (3, 2)),
       (1, 20, 20, 130, 3, 3, 130, (1, 1), (2, 2)),
       (3, 40, 40, 33, 7, 7, 99, (3, 3), (3, 3))])


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_the_bands_cover_the_output_once(shape):
    n, hp, wp, cin, kh, kw, cout, strides, pool = shape
    pl = qconv.dw_plan(n, hp, wp, cin, kh, kw, cout, strides, pool)
    ho, wo = (hp - kh) // strides[0] + 1, (wp - kw) // strides[1] + 1
    pw, ps = pool if pool is not None else (1, 1)
    oh, ow = (ho - pw) // ps + 1, (wo - pw) // ps + 1
    assert pl.row_bands * pl.rp >= oh > (pl.row_bands - 1) * pl.rp
    assert pl.col_bands * pl.cp >= ow > (pl.col_bands - 1) * pl.cp
    assert pl.groups * pl.cb >= cout > (pl.groups - 1) * pl.cb
    assert pl.cb % 4 == 0 and 4 <= pl.cb <= 32
    assert pl.smem <= qconv.DW_SMEM
    if n == 1 and pool is None and cout >= 16:
        # batch 1: blocks narrowed until the card is covered or a block's
        # (row, run, lane group) items fit its threads once
        items = math.ceil(pl.cp / qconv.DW_RUN) * pl.cb // 4
        assert (pl.blocks_per_image >= qconv.H100_SMS
                or items <= qconv.DW_THREADS)


def test_a_tight_shared_memory_cap_narrows_the_band_then_the_channels():
    wide = qconv.dw_plan(1, 40, 40, 32, 7, 7, 32, (1, 1), (3, 3), 1)
    cols = qconv.dw_plan(1, 40, 40, 32, 7, 7, 32, (1, 1), (3, 3), 1,
                         smem_cap=wide.smem // 2)
    assert cols.rp == 1 and cols.cp < wide.cp and cols.cb == wide.cb
    tiny = qconv.dw_plan(1, 40, 40, 32, 7, 7, 32, (1, 1), (3, 3), 1,
                         smem_cap=1200)
    assert tiny.cp == 1 and tiny.cb < 32 and tiny.smem <= 1200
    with pytest.raises(ValueError, match="shared memory"):
        qconv.dw_plan(1, 40, 40, 32, 7, 7, 32, (1, 1), (3, 3), 1,
                      smem_cap=100)
    x, w, b, kw = _case(dict(name="tight", n=1, h=12, cin=8, k=5, p=2,
                             pool=(3, 3)), seed=5)
    got = band_model(x, w, b, sms=1, smem_cap=700, **kw)
    assert torch.equal(got, qconv.qdwconv2d_plain(x, w, b, **kw))


def test_the_copy_width_follows_the_channel_runs():
    """16-byte copies where m == 1 and Cin and the channel group are
    multiples of 16, 4-byte ones where Cin is a multiple of 4, bytes
    otherwise (every m > 1)."""
    def width(cin, cout):
        x = torch.empty((1, 10, 10, cin), dtype=torch.int8, device="meta")
        w = torch.empty((3, 3, 1, cout), dtype=torch.int8, device="meta")
        return qconv._geometry(
            "qdwconv", "qdwconv2d", x.shape, w.shape, (1, 8, 8, cout), cin,
            (1, 1), None, 0, None, None, (0, 0, 0, 0), None).width
    assert width(32, 32) == 16
    assert width(16, 16) == 16
    assert width(20, 20) == 4
    assert width(130, 130) == 1
    assert width(12, 24) == 1
    assert width(16, 32) == 1

"""The int8 conv kernels' zero padding, taken in the kernels, on the card.

``csrc/qconv.cu`` reads a padded conv's UNPADDED input: a row whose
window crosses the image's border zeroes each tap outside it (one test a
(row, chunk) in the 16- and 4-byte ``cp.async`` gathers, one a byte in the
narrow gather), so no padded copy is made.  ``csrc/qdwconv.cu`` does the
same in its band staging: a stage pixel outside the image is a copy of
source size 0 or a zero word.  Every test here needs a card
(``cuda`` marker) and holds ``qconv.qconv2d(x, pads=...)`` and its into,
grouped and trial forms ``torch.equal`` to the plain version over
``ref.pad_nhwc(x, pads)``: every padded conv of VGG-16, AlexNet and
ResNet-18 at batch 1 and 64 (their fused pools among them), the skip
epilogue, a concat buffer, grouped convs, trial forms, an input one byte
off a word and asymmetric pads; the depthwise kernel at MobileNetV2's
shapes; then ``qconv.padded_launches`` over an eager forward and the
captured graph's one device operation a conv stage, depthwise ones
included.  The CPU models of the padded gathers and of the padded band
staging are in ``tests/test_torch_qconv_tiles.py`` and
``tests/test_torch_dwconv_tiles.py``.
This file imports no JAX, so it runs on a card host without it.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.synthesis import CNN2Gate
from repro_torch.kernels import ops, qconv, ref
from repro_torch.models import cnn

# (name, H = W unpadded, Cin, Cout, K, stride, pad, fused pool): every
# padded conv of the three configs, one of each distinct shape
CONVS = (
    [(f"vgg16_{h}x{cin}_{cout}{'_pool' if pool else ''}", h, cin, cout, 3,
      1, 1, pool)
     for h, cin, cout, pool in (
         (224, 3, 64, None), (224, 64, 64, (2, 2)), (112, 64, 128, None),
         (112, 128, 128, (2, 2)), (56, 128, 256, None),
         (56, 256, 256, None), (56, 256, 256, (2, 2)), (28, 256, 512, None),
         (28, 512, 512, None), (28, 512, 512, (2, 2)),
         (14, 512, 512, None), (14, 512, 512, (2, 2)))]
    + [("alexnet_conv1_11x11_s4_pool", 224, 3, 64, 11, 4, 2, (3, 2)),
       ("alexnet_conv2_5x5_pool", 27, 64, 192, 5, 1, 2, (3, 2)),
       ("alexnet_conv3", 13, 192, 384, 3, 1, 1, None),
       ("alexnet_conv4", 13, 384, 256, 3, 1, 1, None),
       ("alexnet_conv5_pool", 13, 256, 256, 3, 1, 1, (3, 2)),
       ("resnet18_conv1_7x7_s2", 224, 3, 64, 7, 2, 3, None)]
    + [(f"resnet18_{h}x{cin}_{cout}_s{s}", h, cin, cout, 3, s, 1, None)
       for h, cin, cout, s in ((56, 64, 64, 1), (56, 64, 128, 2),
                               (28, 128, 128, 1), (28, 128, 256, 2),
                               (14, 256, 256, 1), (14, 256, 512, 2),
                               (7, 512, 512, 1))])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the padded gathers are CUDA code "
                    "(their CPU model is in test_torch_qconv_tiles.py)")
    return torch.device("cuda", 0)


def _operands(dev, n, h, cin, cout, k, groups=1, trials=None, seed=0):
    """Seeded x (n images, or trials * n), w, b and a shift that keeps the
    requantized values off the int8 rails."""
    rng = np.random.default_rng(seed)
    lead = () if trials is None else (trials,)
    rows = n if trials is None else trials * n
    x = rng.integers(-128, 128, (rows, h, h, cin), dtype=np.int8)
    wt = rng.integers(-128, 128, lead + (k, k, cin // groups, cout),
                      dtype=np.int8)
    depth = k * k * cin // groups
    b = rng.integers(-6000, 6000, (cout,), dtype=np.int32)
    shift = max(0, min(31, int(math.log2(5461 * math.sqrt(depth) / 40))))
    return (torch.from_numpy(x).to(dev), torch.from_numpy(wt).to(dev),
            torch.from_numpy(b).to(dev), shift)


def _gather(cin_g, x):
    width = 16 if cin_g % 16 == 0 else 4 if cin_g % 4 == 0 else 1
    while x.data_ptr() % width:
        width //= 4
    return "narrow" if width == 1 else str(width)


def _check(x, pads, call, plain, cin_g):
    """``call(x, pads)`` equals ``plain(ref.pad_nhwc(x, pads))`` and counts
    one padded launch of the gather it takes."""
    gather = _gather(cin_g, x)
    before = dict(qconv.padded_launches)
    got = call(x, pads)
    torch.cuda.synchronize()
    assert qconv.padded_launches[gather] == before[gather] + 1
    want = plain(ref.pad_nhwc(x.contiguous(), pads))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("conv", CONVS, ids=[c[0] for c in CONVS])
def test_every_padded_conv_equals_the_plain_version(card, conv, n):
    _name, h, cin, cout, k, s, p, pool = conv
    x, w, b, shift = _operands(card, n, h, cin, cout, k, seed=h + cin)
    kw = dict(strides=(s, s), shift=shift, relu=True, pool=pool)
    _check(x, (p,) * 4, lambda x, pads: qconv.qconv2d(x, w, b, pads=pads,
                                                      **kw),
           lambda xp: qconv.qconv2d_plain(xp, w, b, **kw), cin)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
def test_the_skip_epilogue_with_pads(card, n):
    """ResNet-18 layer1_0's conv2, which takes the residual add."""
    x, w, b, shift = _operands(card, n, 56, 64, 64, 3, seed=11)
    skip = torch.randint(-128, 128, (n, 56, 56, 64), dtype=torch.int8,
                         generator=torch.Generator().manual_seed(n)).to(card)
    kw = dict(shift=shift, relu=False, skip=skip, skip_shifts=(1, 0),
              merge_shift=1, merge_relu=True)
    before = qconv.skip_launches["qconv"]
    _check(x, (1, 1, 1, 1),
           lambda x, pads: qconv.qconv2d(x, w, b, pads=pads, **kw),
           lambda xp: qconv.qconv2d_plain(xp, w, b, **kw), 64)
    assert qconv.skip_launches["qconv"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cin,off,c_tot,pool", [(16, 17, 70, (2, 2)),
                                                (3, 3, 40, None),
                                                (12, 5, 131, (3, 2))])
def test_a_concat_buffer_with_pads(card, cin, off, c_tot, pool):
    """The into form at odd offsets, on each gather: the slice equals the
    plain version's and the sibling channels keep their sentinel."""
    x, w, b, shift = _operands(card, 2, 15, cin, 30, 3, seed=off)
    kw = dict(shift=shift, pool=pool, concat_shift=1, concat_relu=True)
    oh = 15 if pool is None else (15 - pool[0]) // pool[1] + 1
    buf = torch.full((2, oh, oh, c_tot), 77, dtype=torch.int8, device=card)
    _check(x, (1, 1, 1, 1),
           lambda x, pads: qconv.qconv2d(x, w, b, pads=pads,
                                         out_buf=buf.clone(), out_off=off,
                                         **kw),
           lambda xp: qconv.qconv2d_plain(xp, w, b, out_buf=buf.clone(),
                                          out_off=off, **kw), cin)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("h,cin,cout,k,p,pool", [
    (27, 96, 256, 5, 2, (3, 2)), (13, 256, 384, 3, 1, None),
    (13, 384, 384, 3, 1, None), (13, 384, 256, 3, 1, (3, 2))])
def test_the_grouped_convs_of_alexnet_2tower(card, h, cin, cout, k, p, pool,
                                             n):
    x, w, b, shift = _operands(card, n, h, cin, cout, k, groups=2, seed=h)
    kw = dict(groups=2, shift=shift, pool=pool)
    _check(x, (p,) * 4,
           lambda x, pads: qconv.qgconv2d(x, w, b, pads=pads, **kw),
           lambda xp: qconv.qconv2d_plain(xp, w, b, **kw), cin // 2)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dense", "into", "grouped"])
@pytest.mark.parametrize("cin", [3, 12, 64])
def test_the_trial_forms_with_pads(card, form, cin):
    groups = 3 if form == "grouped" else 1
    cin = cin * groups
    x, w, b, shift = _operands(card, 2, 20, cin, 48, 3, groups=groups,
                               trials=4, seed=cin)
    kw = dict(shift=shift, pool=(2, 2))
    if form == "grouped":
        kw["groups"] = groups
        call = qconv.qgconv2d_trials
    else:
        call = qconv.qconv2d_trials
    if form == "into":
        buf = torch.full((8, 10, 10, 53), 5, dtype=torch.int8, device=card)
        kw.update(out_buf=buf, out_off=3)

    def copy(kw):   # a fresh buffer a call
        return dict(kw, out_buf=kw["out_buf"].clone()) if "out_buf" in kw \
            else kw

    _check(x, (1, 1, 1, 1),
           lambda x, pads: call(x, w, b, pads=pads, **copy(kw)),
           lambda xp: ref.qconv2d_trials_ref(xp, w, b, **copy(kw)),
           cin // groups)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,k,s,p", [(3, 11, 4, 2), (3, 7, 2, 3),
                                       (64, 3, 1, 1), (12, 5, 1, 2)])
def test_an_input_one_byte_off_a_word_with_pads(card, cin, k, s, p):
    """x one byte into its buffer takes the narrow gather, whose border
    rows test each byte's tap."""
    x, w, b, shift = _operands(card, 2, 40, cin, 64, k, seed=k)
    buf = torch.empty(x.numel() + 1, dtype=torch.int8, device=card)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    assert xm.data_ptr() % 4 == 1
    kw = dict(strides=(s, s), shift=shift, pool=(2, 2))
    _check(xm, (p,) * 4,
           lambda x, pads: qconv.qconv2d(x, w, b, pads=pads, **kw),
           lambda xp: qconv.qconv2d_plain(xp, w, b, **kw), cin)


@pytest.mark.cuda
@pytest.mark.parametrize("pads", [(1, 2, 0, 1), (0, 0, 3, 1), (2, 0, 0, 0),
                                  (3, 3, 3, 3)])
@pytest.mark.parametrize("cin,h", [(3, 9), (12, 9), (64, 9), (16, 2)])
def test_asymmetric_pads(card, pads, cin, h):
    """ONNX pads (top, left, bottom, right) that differ, on each gather;
    a 2x2 image under a 3x3 window has no interior row at all."""
    x, w, b, shift = _operands(card, 3, h, cin, 24, 3, seed=sum(pads) + cin)
    for pool, s in ((None, 1), ((2, 2), 1), (None, 2)):
        hp, wp = h + pads[0] + pads[2], h + pads[1] + pads[3]
        ho, wo = (hp - 3) // s + 1, (wp - 3) // s + 1
        if min(hp, wp) < 3 or pool is not None and min(ho, wo) < pool[0]:
            continue   # the window or the pool does not fit
        kw = dict(strides=(s, s), shift=shift, pool=pool)
        _check(x, pads,
               lambda x, pads: qconv.qconv2d(x, w, b, pads=pads, **kw),
               lambda xp: qconv.qconv2d_plain(xp, w, b, **kw), cin)


# (name, batch, H = W unpadded, C, stride, fused pool, pads, form): a
# 14x14x32 conv with a pool in each form under symmetric and asymmetric
# pads; then each distinct depthwise conv of MobileNetV2 (3x3, pad 1) at
# batch 1 and 8
DW_PADDED = (
    [(f"{form}_{''.join(map(str, pads))}", 2, 14, 32, 1, (2, 2), pads, form)
     for pads in ((1, 1, 1, 1), (1, 2, 0, 1))
     for form in ("single", "into", "trials")]
    + [(f"mobilenet_v2_{h}x{c}_s{s}_b{n}", n, h, c, s, None, (1, 1, 1, 1),
        "single")
       for h, c, s in ((112, 32, 1), (112, 96, 2), (56, 144, 1),
                       (56, 144, 2), (28, 192, 1), (28, 192, 2),
                       (14, 384, 1), (14, 576, 1), (14, 576, 2),
                       (7, 960, 1))
       for n in (1, 8)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_PADDED, ids=[c[0] for c in DW_PADDED])
def test_the_depthwise_wrapper_pads_for_its_kernel(card, case):
    """The depthwise kernel takes the pads in its band staging, over the
    unpadded input: ``qdwconv2d(x, pads=p)`` (its into and trial forms,
    and ``ops.qconv2d_nhwc`` on the depthwise route) equals the same call
    on ``ref.pad_nhwc(x, p)`` and the plain version over ``x`` and ``p``,
    and counts one ``padded_launches["qdwconv"]``."""
    _name, n, h, c, s, pool, pads, form = case
    trials = 3 if form == "trials" else None
    x, w, b, shift = _operands(card, n, h, c, c, 3, groups=c,
                               trials=trials, seed=sum(pads) + h + c)
    kw = dict(strides=(s, s), shift=shift, pool=pool)
    fn, plain = qconv.qdwconv2d, qconv.qdwconv2d_plain
    if trials:
        fn, plain = qconv.qdwconv2d_trials, ref.qdwconv2d_trials_ref
    if form == "into":
        oh = (h + pads[0] + pads[2] - 2) // 2
        ow = (h + pads[1] + pads[3] - 2) // 2
        buf = torch.full((n, oh, ow, c + 8), 77, dtype=torch.int8,
                         device=card)
        kw.update(out_off=4, concat_shift=1)

    def copy(kw):   # a fresh buffer a call
        return dict(kw, out_buf=buf.clone()) if form == "into" else kw

    before = qconv.padded_launches["qdwconv"]
    got = fn(x, w, b, pads=pads, **copy(kw))
    torch.cuda.synchronize()
    assert qconv.padded_launches["qdwconv"] == before + 1
    assert torch.equal(got, fn(ref.pad_nhwc(x, pads), w, b, **copy(kw)))
    assert torch.equal(got, plain(x, w, b, pads=pads, **copy(kw)))
    via_ops = ops.qconv2d_nhwc(x, w, b, pads=pads, groups=c, **copy(kw))
    torch.cuda.synchronize()
    assert torch.equal(got, via_ops)


def _gate(net, dev):
    graph = getattr(cnn, net)(batch=1, seed=0)
    gate = CNN2Gate.from_graph(graph, device=dev)
    rng = np.random.default_rng(0)
    gate.calibrate_quantization(
        rng.standard_normal((1, 3, 224, 224)).astype(np.float32))
    return gate, rng.standard_normal((1, 3, 224, 224)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("net,want", [
    ("vgg16", {"16": 12, "4": 0, "narrow": 1, "qdwconv": 0}),
    ("alexnet", {"16": 4, "4": 0, "narrow": 1, "qdwconv": 0}),
    ("resnet18", {"16": 16, "4": 0, "narrow": 1, "qdwconv": 0}),
    ("mobilenet_v2", {"16": 0, "4": 0, "narrow": 1, "qdwconv": 17})])
def test_padded_launches_of_an_eager_forward(card, net, want):
    """Every padded conv launches the kernel on its unpadded input; the
    1x1 convs (no pads: ResNet-18's projections, MobileNetV2's expansions
    and projections) count under ``gather_launches`` alone."""
    gate, x = _gate(net, card)
    run = gate.build("emulation")
    ops.reset_launch_counts()
    run(torch.as_tensor(x, device=card))
    torch.cuda.synchronize()
    assert qconv.padded_launches == want
    convs = sum(qconv.gather_launches.values())
    assert convs == {"vgg16": 13, "alexnet": 5, "resnet18": 20,
                     "mobilenet_v2": 35}[net]


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["vgg16", "alexnet", "resnet18",
                                 "mobilenet_v2"])
def test_a_conv_stage_is_one_device_operation(card, net):
    """In the captured graph a conv stage, padded or not, dense or
    depthwise, is its kernel alone: no pad fill, no pad copy."""
    gate, x = _gate(net, card)
    full = gate.build("fullflow")
    rows = full.stage_map[tuple(x.shape)]
    convs = [n for _stage, kind, n in rows if kind == "conv"]
    assert len(convs) == {"vgg16": 13, "alexnet": 5, "resnet18": 20,
                          "mobilenet_v2": 52}[net]
    assert convs == [1] * len(convs)
    assert torch.equal(full(x), gate.build("emulation")(x))

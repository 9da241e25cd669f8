"""The int8 conv kernel's narrow gather on the card.

Convs whose Cin/G is not a multiple of 4 (the Cin-3 stems of AlexNet,
VGG-16 and ResNet-18), and any conv whose input pointer is not 4-byte
aligned, gather their im2col rows through the narrow gather of
``csrc/qconv.cu``.  Every test here needs a card (``cuda`` marker) and
holds the kernel ``torch.equal`` to :func:`qconv.qconv2d_plain` at the
stems' full sizes, batch 1 and 64, misaligned, in the trial form, and
counts ``qconv.gather_launches`` over an eager forward.  Its CPU model
(offsets, thread mapping) is in ``tests/test_torch_qconv_tiles.py``.
This file imports no JAX, so it runs on a card host without it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.synthesis import CNN2Gate
from repro_torch.kernels import ops, qconv, ref
from repro_torch.models import cnn

# (name, padded H = W, KH = KW, stride, fused pool): Cin 3, Cout 64
STEMS = [("alexnet_conv1_11x11_s4_pool3s2", 228, 11, 4, (3, 2)),
         ("vgg16_conv1_3x3", 226, 3, 1, None),
         ("resnet18_conv1_7x7_s2", 230, 7, 2, None)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the narrow gather is CUDA code "
                    "(its CPU model is in test_torch_qconv_tiles.py)")
    return torch.device("cuda", 0)


def _operands(stem, n, dev, trials=None, seed=0):
    _name, hp, k, s, pool = stem
    rng = np.random.default_rng(seed + n)
    lead = () if trials is None else (trials,)
    rows = n if trials is None else trials * n
    x = rng.integers(-128, 128, (rows, hp, hp, 3), dtype=np.int8)
    w = rng.integers(-128, 128, lead + (k, k, 3, 64), dtype=np.int8)
    b = rng.integers(-6000, 6000, (64,), dtype=np.int32)
    kw = dict(strides=(s, s), shift=10, relu=True, pool=pool)
    return (torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev),
            torch.from_numpy(b).to(dev), kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("stem", STEMS, ids=[s[0] for s in STEMS])
def test_the_stems_equal_the_plain_version(card, stem, n):
    x, w, b, kw = _operands(stem, n, card)
    before = qconv.gather_launches["narrow"]
    got = qconv.qconv2d(x, w, b, **kw)
    assert qconv.gather_launches["narrow"] == before + 1
    assert torch.equal(got, qconv.qconv2d_plain(x, w, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("stem", STEMS, ids=[s[0] for s in STEMS])
def test_an_input_one_byte_off_a_word_is_gathered_alike(card, stem):
    """x one byte into its buffer: the stems, and a Cin-64 conv that
    would take the 16-byte gather, take the narrow one and stay equal."""
    x, w, b, kw = _operands(stem, 2, card)
    wide = torch.from_numpy(np.random.default_rng(7).integers(
        -128, 128, (3, 3, 64, 64), dtype=np.int8)).to(card)
    xw = torch.from_numpy(np.random.default_rng(8).integers(
        -128, 128, (2, 30, 30, 64), dtype=np.int8)).to(card)
    for xx, ww, kk in ((x, w, kw), (xw, wide, dict(shift=12, pool=(2, 2)))):
        buf = torch.empty(xx.numel() + 1, dtype=torch.int8, device=card)
        xm = buf[1:].view(xx.shape)
        xm.copy_(xx)
        assert xm.data_ptr() % 4 == 1
        before = qconv.gather_launches["narrow"]
        got = qconv.qconv2d(xm, ww, b, **kk)
        assert qconv.gather_launches["narrow"] == before + 1
        assert torch.equal(got, qconv.qconv2d_plain(xx, ww, b, **kk))


@pytest.mark.cuda
@pytest.mark.parametrize("stem", STEMS, ids=[s[0] for s in STEMS])
def test_the_trial_form_at_the_stems(card, stem):
    x, w, b, kw = _operands(stem, 2, card, trials=4)
    got = qconv.qconv2d_trials(x, w, b, **kw)
    assert torch.equal(got, ref.qconv2d_trials_ref(x, w, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("net,convs", [("vgg16", 13), ("alexnet", 5)])
def test_one_narrow_launch_a_forward(card, net, convs):
    """An eager VGG-16 or AlexNet forward launches the conv kernel once a
    conv: the Cin-3 stem through the narrow gather, every other conv
    (Cin 64 and up) through the 16-byte one."""
    graph = getattr(cnn, net)(batch=1, seed=0)
    gate = CNN2Gate.from_graph(graph, device=card)
    rng = np.random.default_rng(0)
    gate.calibrate_quantization(
        rng.standard_normal((1, 3, 224, 224)).astype(np.float32))
    run = gate.build("emulation")
    x = torch.as_tensor(rng.standard_normal((1, 3, 224, 224))
                        .astype(np.float32), device=card)
    ops.reset_launch_counts()
    run(x)
    launched = sum(qconv.launches[k] for k in ("qconv2d", "qconv2d_into",
                                               "qgconv2d"))
    assert launched == convs
    assert qconv.gather_launches == {"16": convs - 1, "4": 0, "narrow": 1}

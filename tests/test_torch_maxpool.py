"""The standalone int8 NHWC max-pool kernel (``csrc/pool.cu``).

The kernel reads the UNPADDED input: a thread owns one output pixel and
one chunk of its channels (16, 4 or 1 bytes, :func:`pool.chunk_width`),
walks the window's taps and skips each tap outside the input, from a
running max that starts at INT8_MIN.  It cannot run here, so the CPU
tests hold a numpy model of that index arithmetic equal to the plain
version ``ref.maxpool2d_ref`` (a padded copy at INT8_MIN, then an amax
over the windows) over a grid of channels, windows, strides and pads, at
every chunk width the channels allow; then the chunk choice, the
wrapper's refusals and the CPU path.  The tests marked ``cuda`` hold the
kernel ``torch.equal`` to the plain version on the card, count its
launches over an eager ResNet-18 forward and find its stage one device
operation in the captured graph.  This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.synthesis import CNN2Gate
from repro_torch.kernels import ops, pool, ref
from repro_torch.models import cnn

# (window, stride, pads): unpadded 2x2/2 and 3x3/2, ResNet-18's padded
# 3x3/2, ONNX's asymmetric pads, windows made only of pads (top rows and
# right columns) and a 3x3/3 over them
WINDOWS = [(2, 2, (0, 0, 0, 0)), (3, 2, (0, 0, 0, 0)), (3, 2, (1, 1, 1, 1)),
           (3, 2, (1, 0, 1, 2)), (3, 3, (1, 0, 1, 2)), (2, 2, (2, 0, 0, 2))]
CHANNELS = [1, 3, 17, 20, 64, 130]


def _kernel_model(x: np.ndarray, window: int, stride: int, pads,
                  width: int) -> np.ndarray:
    """``csrc/pool.cu:maxpool_nhwc_kernel<width>`` in numpy, every item of
    an image at once: item i is output chunk i of the image (pixel
    i // chunks, chunk i % chunks); its taps are read at chunk
    ``(item - pix * chunks) + ih * row_chunks + iw * chunks`` of the
    image, in chunk units, where the bounds check passes; its max starts
    at INT8_MIN and lands at chunk ``item`` of the output."""
    n, h, w, c = x.shape
    oh, ow = ref.out_hw(h, w, window, window, (stride, stride), pads)
    chunks = c // width
    per_image = oh * ow * chunks
    row_chunks = w * chunks
    image = x.reshape(n, h * w * c)
    item = np.arange(per_image)
    pix = item // chunks
    r = pix // ow
    ih0 = r * stride - pads[0]
    iw0 = (pix - r * ow) * stride - pads[1]
    origin = item - pix * chunks
    lanes = np.arange(width)
    acc = np.full((n, per_image, width), -128, dtype=np.int8)
    for dh in range(window):
        ih = ih0 + dh
        for dw in range(window):
            iw = iw0 + dw
            inside = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
            at = np.where(inside, origin + ih * row_chunks + iw * chunks, 0)
            taps = image[:, at[:, None] * width + lanes]
            acc = np.where(inside[None, :, None], np.maximum(acc, taps), acc)
    return acc.reshape(n, oh, ow, c)


def _widths(c):
    return [wd for wd in (16, 4, 1) if c % wd == 0]


@pytest.mark.parametrize("win", WINDOWS, ids=lambda v: f"{v[0]}s{v[1]}p"
                         + "".join(map(str, v[2])))
@pytest.mark.parametrize("c", CHANNELS)
def test_the_kernel_model_equals_the_plain_version(c, win):
    window, stride, pads = win
    rng = np.random.default_rng(c * 31 + window)
    for hw in (5, 13, 56):
        x = rng.integers(-128, 128, (2, hw, hw, c), dtype=np.int8)
        want = ref.maxpool2d_ref(torch.from_numpy(x), window, stride,
                                 pads).numpy()
        for width in _widths(c):
            got = _kernel_model(x, window, stride, pads, width)
            np.testing.assert_array_equal(got, want, err_msg=f"{hw} {width}")


@pytest.mark.parametrize("shape,window,stride,pads", [
    ((1, 112, 112, 64), 3, 2, (1, 1, 1, 1)),   # ResNet-18's stem output
    ((2, 13, 13, 20), 3, 2, (0, 0, 0, 0)),     # ragged edges
    ((3, 7, 7, 17), 7, 1, (0, 0, 0, 0)),       # a global window
    ((1, 9, 6, 4), 2, 2, (0, 3, 1, 0)),        # a column made only of pads
])
def test_the_kernel_model_at_the_edges(shape, window, stride, pads):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-128, 128, shape, dtype=np.int8)
    x[0, :2] = -128                            # a patch at the rail
    want = ref.maxpool2d_ref(torch.from_numpy(x), window, stride,
                             pads).numpy()
    for width in _widths(shape[-1]):
        np.testing.assert_array_equal(
            _kernel_model(x, window, stride, pads, width), want)


@pytest.mark.parametrize("value", [-128, 127])
def test_the_kernel_model_on_the_rails(value):
    x = np.full((1, 9, 9, 64), value, dtype=np.int8)
    for width in (16, 4, 1):
        got = _kernel_model(x, 3, 2, (1, 1, 1, 1), width)
        assert (got == value).all()


@pytest.mark.parametrize("c,addresses,want", [
    (64, (0, 256), 16), (64, (4, 256), 4), (64, (0, 8), 4),
    (64, (1, 0), 1), (64, (0, 2), 1), (20, (0, 0), 4), (48, (16, 32), 16),
    (130, (0, 0), 1), (17, (0, 0), 1), (3, (0, 0), 1), (1, (0, 0), 1)])
def test_the_chunk_follows_the_channels_and_the_pointers(c, addresses, want):
    assert pool.chunk_width(c, *addresses) == want


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((1, 8, 8, 4), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        pool.maxpool2d(x.float(), 2, 2)
    with pytest.raises(ValueError, match="NHWC"):
        pool.maxpool2d(x[0], 2, 2)
    with pytest.raises(ValueError, match="NHWC"):
        ops.maxpool2d_nhwc(x[None], 2, 2)
    for window, stride, pads in ((9, 1, (0, 0, 0, 0)), (2, 0, (0, 0, 0, 0)),
                                 (2, 2, (0, -1, 0, 0)), (0, 1, (0, 0, 0, 0)),
                                 (2, 2, (0, 0, 0))):
        with pytest.raises(ValueError, match="maxpool2d"):
            pool.maxpool2d(x, window, stride, pads)


def test_a_cpu_tensor_takes_the_plain_version():
    """No launch is counted, the result is the plain version's, and the
    executor probes still see the stage."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-128, 128, (2, 13, 13, 20),
                                      dtype=np.int8))
    with ops.recording() as calls:
        got = ops.maxpool2d_nhwc(x, 3, 2, (1, 0, 1, 2))
    assert calls == [("maxpool2d_nhwc", 1)]
    assert torch.equal(got, ref.maxpool2d_ref(x, 3, 2, (1, 0, 1, 2)))
    nchw = x.permute(0, 3, 1, 2)
    assert torch.equal(ops.maxpool2d_nchw(nchw, 3, 2, (1, 1, 1, 1)),
                       ref.maxpool2d_ref(x, 3, 2, (1, 1, 1, 1))
                       .permute(0, 3, 1, 2))
    assert ops.launch_counts()["maxpool2d"] == 0
    pool.launches["maxpool2d"] += 1
    ops.reset_launch_counts()
    assert ops.launch_counts()["maxpool2d"] == 0


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the max-pool kernel is CUDA code "
                    "(its CPU model is in this file)")
    return torch.device("cuda", 0)


def _check(x, window, stride, pads, width=None):
    """The kernel equals the plain version on the same tensor and counts
    one launch; with ``width``, the input's and the output's pointers
    gave the kernel that chunk."""
    before = ops.launch_counts()["maxpool2d"]
    got = ops.maxpool2d_nhwc(x, window, stride, pads)
    torch.cuda.synchronize()
    assert ops.launch_counts()["maxpool2d"] == before + 1
    if width is not None:
        assert pool.chunk_width(x.shape[-1], x.data_ptr(),
                                got.data_ptr()) == width
    assert torch.equal(got, ref.maxpool2d_ref(x, window, stride, pads))
    return got


def _rand(dev, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-128, 128, shape,
                                         dtype=np.int8)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64])
def test_resnet18_stem_output(card, n):
    _check(_rand(card, (n, 112, 112, 64), n), 3, 2, (1, 1, 1, 1), 16)


@pytest.mark.cuda
@pytest.mark.parametrize("win", WINDOWS, ids=lambda v: f"{v[0]}s{v[1]}p"
                         + "".join(map(str, v[2])))
@pytest.mark.parametrize("c", CHANNELS)
def test_every_chunk_width_on_the_card(card, c, win):
    for hw in (5, 13, 56):
        _check(_rand(card, (3, hw, hw, c), c + hw), *win)


@pytest.mark.cuda
@pytest.mark.parametrize("off,width", [(1, 1), (4, 4), (16, 16)])
def test_an_input_off_a_word(card, off, width):
    """A contiguous view ``off`` bytes into its storage takes the chunk
    its pointer allows."""
    shape = (2, 28, 28, 64)
    base = _rand(card, (int(np.prod(shape)) + off,), off)
    x = base[off:].view(shape)
    assert x.data_ptr() % 16 == off % 16
    _check(x, 3, 2, (1, 1, 1, 1), width)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window,stride,pads", [
    ((2, 13, 13, 64), 3, 2, (0, 0, 0, 0)),     # ragged edges
    ((2, 14, 14, 64), 2, 2, (0, 0, 0, 0)),
    ((2, 7, 7, 512), 7, 1, (0, 0, 0, 0)),      # a global window
    ((2, 13, 13, 20), 3, 2, (1, 0, 1, 2)),     # asymmetric pads
    ((2, 9, 6, 64), 2, 2, (2, 3, 1, 0)),       # windows made only of pads
])
def test_the_edges_on_the_card(card, shape, window, stride, pads):
    got = _check(_rand(card, shape, sum(shape)), window, stride, pads)
    if pads[0] >= window:
        assert bool((got[:, 0] == -128).all())


@pytest.mark.cuda
@pytest.mark.parametrize("value", [-128, 127])
def test_the_rails_on_the_card(card, value):
    x = torch.full((4, 56, 56, 64), value, dtype=torch.int8, device=card)
    got = _check(x, 3, 2, (1, 1, 1, 1), 16)
    assert bool((got == value).all())


@pytest.mark.cuda
def test_the_nchw_wrapper_on_the_card(card):
    x = _rand(card, (2, 64, 28, 28), 5)
    before = ops.launch_counts()["maxpool2d"]
    got = ops.maxpool2d_nchw(x, 3, 2, (1, 1, 1, 1))
    torch.cuda.synchronize()
    assert ops.launch_counts()["maxpool2d"] == before + 1
    want = ref.maxpool2d_ref(x.permute(0, 2, 3, 1), 3, 2, (1, 1, 1, 1))
    assert torch.equal(got, want.permute(0, 3, 1, 2))


def _resnet18(dev):
    graph = cnn.resnet18(batch=1, seed=0)
    gate = CNN2Gate.from_graph(graph, device=dev)
    rng = np.random.default_rng(0)
    gate.calibrate_quantization(
        rng.standard_normal((1, 3, 224, 224)).astype(np.float32))
    return gate, rng.standard_normal((1, 3, 224, 224)).astype(np.float32)


@pytest.mark.cuda
def test_an_eager_resnet18_forward_launches_the_pool_once(card,
                                                         monkeypatch):
    """One launch, on 16-byte chunks."""
    chunks = []
    launch = pool.maxpool2d

    def kept(x, *a, **kw):
        y = launch(x, *a, **kw)
        chunks.append(pool.chunk_width(x.shape[-1], x.data_ptr(),
                                       y.data_ptr()))
        return y
    monkeypatch.setattr(pool, "maxpool2d", kept)
    gate, x = _resnet18(card)
    run = gate.build("emulation")
    ops.reset_launch_counts()
    run(torch.as_tensor(x, device=card))
    torch.cuda.synchronize()
    assert ops.launch_counts()["maxpool2d"] == 1 and chunks == [16]


@pytest.mark.cuda
def test_the_captured_maxpool_stage_is_one_device_operation(card,
                                                           monkeypatch):
    """In the captured graph the max-pool stage is the kernel alone, and
    the output a replay leaves in it equals the eager forward's."""
    seen = []
    launch = pool.maxpool2d

    def kept(*a, **kw):
        seen.append(launch(*a, **kw))
        return seen[-1]
    monkeypatch.setattr(pool, "maxpool2d", kept)
    gate, x = _resnet18(card)
    eager = gate.build("emulation")
    want = eager(x)
    want_pool = seen[-1].clone()
    full = gate.build("fullflow")
    captured = seen[-1]
    rows = full.stage_map[tuple(x.shape)]
    pools = [(stage, n) for stage, kind, n in rows
             if stage.startswith("maxpool")]
    assert [n for _stage, n in pools] == [1]
    assert torch.equal(full(x), want)
    torch.cuda.synchronize()
    assert torch.equal(captured, want_pool)

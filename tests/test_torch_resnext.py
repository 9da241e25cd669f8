"""ResNeXt-50 (32x4d) on the port's fullflow path: 16 grouped 3x3 convs of
32 groups at 4, 8, 16 and 32 channels a group on the grouped route
(``qconv.qgconv2d``), bottleneck blocks whose adds the dense 1x1 convs
take in their epilogues.

On the CPU: the zoo builder at its published widths; the program built
as the benchmark builds it (``bench/reference/resnext.py``'s model dict
and specs, fullflow) at full width on a 32x32 input, equal to that plain
reference's integer logits, with its routes (16 grouped stages, 16 fused
skips, 2 standalone pools) and the build's counters; the grouped plain
version at ResNeXt's per-group widths against a float64 grouped conv.
On the card (``cuda`` marker): the grouped kernel against its plain
version at ResNeXt-50's batch-512 shapes, and an eager and a captured
forward's launches.  This file imports no JAX.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import model  # noqa: E402
from bench.reference import resnext as reference  # noqa: E402
from repro_torch.core import onnx_lite  # noqa: E402
from repro_torch.core import parser as P  # noqa: E402
from repro_torch.core import telemetry as tele  # noqa: E402
from repro_torch.core.quantize import QuantSpec  # noqa: E402
from repro_torch.core.synthesis import CNN2Gate  # noqa: E402
from repro_torch.kernels import ops, qconv  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

SEEDS = (0, 2**31 + 7, 2**33 + 12345)
COUNTERS = ("build.grouped_stages", "build.fused_skips",
            "build.standalone_pools")


def small_input(hw: int = 32) -> dict:
    """ResNeXt-50 at its published widths on a ``hw`` x ``hw`` input: the
    same kernels, groups, strides, pads and adds (the GAP over 1 x 1)."""
    c = model.load_config("resnext50_32x4d")
    return dict(c, input=[3, hw, hw])


@pytest.fixture(scope="module")
def built():
    """One seed's layers, weights, specs and built program, by seed."""
    out = {}

    def get(seed):
        if seed not in out:
            config = small_input()
            layers = reference.layers_of(config)
            weights = reference.make_weights(layers, seed, "cpu")
            x_cal = model.make_images(1, config["input"], seed, 1, "cpu")
            m_in, specs = reference.calibrate(layers, weights, x_cal)
            inits = {}
            for n, (w, b) in weights.items():
                inits[f"{n}_w"], inits[f"{n}_b"] = w.numpy(), b.numpy()
            graph = onnx_lite.from_model_dict(
                reference.model_dict(config, layers), inits)
            gate = CNN2Gate.from_graph(graph, device="cpu")
            gate.apply_quantization(
                {n: QuantSpec(*s) for n, s in specs.items()})
            reg = tele.get_registry()
            before = [reg.counter(n).value for n in COUNTERS]
            ex = gate.build("fullflow")
            counted = tuple(reg.counter(n).value - v
                            for n, v in zip(COUNTERS, before))
            out[seed] = (config, layers, weights, m_in, specs, gate, ex,
                         counted)
        return out[seed]
    return get


def test_the_zoo_builder_at_its_published_widths():
    parsed = P.parse(cnn.resnext50_32x4d(batch=1))
    convs = [li for li in parsed.layers if li.kind == P.CONV]
    grouped = [li for li in convs if li.group > 1]
    assert len(convs) == 53 and len(grouped) == 16
    assert all(li.group == 32 and not li.is_dw_kernel for li in grouped)
    assert sorted({li.c_in // li.group for li in grouped}) == [4, 8, 16, 32]
    assert sum(li.strides[0] == 2 for li in grouped) == 3
    assert sum(li.merge is not None for li in convs) == 16
    assert all(li.merge.relu for li in convs if li.merge is not None)
    assert sum(li.kind == P.POOL for li in parsed.layers) == 2
    weighted = [li for li in parsed.layers if li.kind in (P.CONV, P.FC)]
    assert round(sum(li.macs for li in weighted) / 1e9, 3) == 4.230
    assert round(parsed.total_weights / 1e6, 2) == 24.96


@pytest.mark.parametrize("seed", SEEDS)
def test_the_program_equals_the_reference(built, seed, monkeypatch):
    """Bit-exact logits at full width, batch 2, every grouped stage on
    the grouped route."""
    config, layers, weights, m_in, specs, gate, ex, _n = built(seed)
    x = model.make_images(2, config["input"], seed, 2, "cpu")
    plain = qconv.qgconv2d
    groups = []

    def counted(*a, **kw):
        groups.append(kw["groups"])
        return plain(*a, **kw)
    monkeypatch.setattr(qconv, "qgconv2d", counted)
    got = ex(x)
    want = reference.int_forward(layers, weights, m_in, specs, x)
    assert torch.equal(got, want)
    assert torch.unique(want).numel() > 50
    assert groups == [32] * 16


def test_the_routes_and_the_build_counters(built):
    """16 stages on the grouped route, 16 adds in conv epilogues, the
    padded max-pool and the GAP standalone; the counters read so, and 0
    grouped stages in a net without one."""
    _c, _l, _w, _m, _s, gate, _ex, counted = built(SEEDS[1])
    assert counted == (16, 16, 2)
    routes = [ops.conv_route(ql.info.group, ql.info.c_in, ql.w_q.shape)
              for ql in gate.quantized.layers if ql.info.kind == P.CONV]
    assert routes.count("grouped") == 16 and routes.count("dense") == 37
    reg = tele.get_registry()
    for graph in (cnn.resnet_tiny(), cnn.mobilenet_tiny()):
        g = CNN2Gate.from_graph(graph, device="cpu")
        g.calibrate_quantization(np.zeros(graph.inputs[0].shape,
                                          np.float32))
        before = reg.counter("build.grouped_stages").value
        g.build("emulation")
        assert reg.counter("build.grouped_stages").value == before


def float64_grouped(x, w, b, groups, stride, shift):
    """An independent yardstick: the grouped conv in float64 (NCHW, OIHW),
    pad 1, then bias, the round-half-up shift and the ReLU's clamp."""
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   w.permute(3, 2, 0, 1).double(), stride=stride, padding=1,
                   groups=groups) + b.double()[:, None, None]
    y = torch.floor((acc + 2.0 ** (shift - 1)) / 2.0 ** shift)
    return y.clamp(0, 127).to(torch.int8).permute(0, 2, 3, 1)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cg", [4, 8, 16, 32])
def test_the_grouped_plain_version_at_resnexts_widths(cg, stride):
    rng = np.random.default_rng(cg * 10 + stride)
    c = 32 * cg
    x = torch.from_numpy(rng.integers(-128, 128, (2, 9, 9, c), np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (3, 3, cg, c), np.int8))
    b = torch.from_numpy(rng.integers(-4000, 4000, c, np.int32))
    shift = int(np.log2(9 * cg)) + 6
    got = qconv.qgconv2d(x, w, b, groups=32, strides=(stride, stride),
                         pads=(1, 1, 1, 1), shift=shift)
    want = float64_grouped(x, w, b, 32, stride, shift)
    assert got.shape == want.shape == (2, 5 if stride == 2 else 9,
                                       5 if stride == 2 else 9, c)
    assert torch.equal(got, want)
    assert 0 < int((want > 0).sum()) < want.numel()


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the grouped route runs a CUDA "
                    "kernel (the plain version's tests above run here)")
    return torch.device("cuda", 0)


#: (name, H = W of the input, C, stride): each grouped conv shape of
#: ResNeXt-50, 32 groups of C / 32 channels, pad 1
CARD_CONVS = [
    ("conv2_56x128_g4", 56, 128, 1),
    ("conv3_first_56x256_g8_s2", 56, 256, 2),
    ("conv3_28x256_g8", 28, 256, 1),
    ("conv4_first_28x512_g16_s2", 28, 512, 2),
    ("conv4_14x512_g16", 14, 512, 1),
    ("conv5_first_14x1024_g32_s2", 14, 1024, 2),
    ("conv5_7x1024_g32", 7, 1024, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CONVS, ids=lambda c: c[0])
def test_the_grouped_kernel_at_batch_512(card, case):
    """The kernel against its plain version (run on the card, exact in
    float64) at ResNeXt-50's own grouped shapes and batch 512, with a
    staged K-major weight as the built program passes it."""
    _name, h, c, s = case
    gen = torch.Generator(device=card).manual_seed(h * c + s)
    x = torch.randint(-128, 128, (512, h, h, c), generator=gen,
                      device=card, dtype=torch.int8)
    w = torch.randint(-128, 128, (3, 3, c // 32, c), generator=gen,
                      device=card, dtype=torch.int8)
    b = torch.randint(-4000, 4000, (c,), generator=gen, device=card,
                      dtype=torch.int32)
    kw = dict(groups=32, strides=(s, s), pads=(1, 1, 1, 1),
              shift=int(np.log2(9 * c // 32)) + 6)
    ops.reset_launch_counts()
    got = qconv.qgconv2d(x, w, b, w_k=qconv.stage_kmajor(w, 32), **kw)
    assert qconv.launches["qgconv2d"] == 1
    want = qconv.qconv2d_plain(x, w, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert 0 < int((want > 0).sum()) < want.numel()


def _resnext_gate(dev):
    graph = cnn.resnext50_32x4d(batch=1, seed=0)
    # without the zoo's softmax: the logits are exact integers on any
    # device, float32 softmax is not
    d = onnx_lite.to_model_dict(graph)
    softmax = d["nodes"].pop()
    d["outputs"] = softmax["inputs"]
    gate = CNN2Gate.from_graph(
        onnx_lite.from_model_dict(d, graph.initializers), device=dev)
    rng = np.random.default_rng(0)
    gate.calibrate_quantization(
        rng.standard_normal((1, 3, 224, 224)).astype(np.float32))
    return gate, rng.standard_normal((1, 3, 224, 224)).astype(np.float32)


@pytest.mark.cuda
def test_an_eager_forward_counts_16_16_16(card):
    gate, x = _resnext_gate(card)
    reg = tele.get_registry()
    before = reg.counter("build.grouped_stages").value
    run = gate.build("emulation")
    assert reg.counter("build.grouped_stages").value - before == 16
    ops.reset_launch_counts()
    y = run(torch.as_tensor(x, device=card))
    torch.cuda.synchronize()
    assert qconv.launches["qgconv2d"] == 16
    assert qconv.skip_launches["qconv"] == 16
    # 4, 8, 16 and 32 channels a group: 16, 8, 4 and 2 groups a tile
    assert qconv.group_pack == {"16": 3, "8": 4, "4": 6, "2": 3}
    cpu = CNN2Gate.from_graph(gate.parsed.graph, device="cpu")
    cpu.apply_quantization(gate.specs)
    assert torch.equal(y.cpu(), cpu.build("emulation")(x))


@pytest.mark.cuda
def test_the_captured_forward_names_its_grouped_launches(card):
    gate, x = _resnext_gate(card)
    full = gate.build("fullflow")
    xt = torch.as_tensor(x, device=card)
    rows = full.stage_map[tuple(xt.shape)]
    convs = {name: n for name, kind, n in rows if kind == "conv"}
    grouped = [li.name for li in gate.parsed.layers
               if li.kind == P.CONV and li.group > 1]
    assert len(grouped) == 16 and len(convs) == 53
    assert all(v == 1 for v in convs.values())
    full(xt)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = full(xt)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA"]
    assert sum("qconv_grouped_wgmma_kernel" in n for n in names) == 16
    assert sum("qconv_wgmma_kernel" in n for n in names) == 37
    assert torch.equal(y, gate.build("emulation")(xt))

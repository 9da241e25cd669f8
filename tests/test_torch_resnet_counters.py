"""The build's stage counters (``build.fused_skips``,
``build.standalone_merges``, ``build.standalone_pools`` in the process
registry of ``core.telemetry``) and ``qconv.skip_launches``, on ResNet-18
and the small graphs of ``models.cnn``.  This file imports no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.core import telemetry as tele
from repro_torch.core.synthesis import CNN2Gate
from repro_torch.kernels import ops, qconv
from repro_torch.models import cnn

COUNTERS = ("build.fused_skips", "build.standalone_merges",
            "build.standalone_pools")


def _counts():
    reg = tele.get_registry()
    return np.array([reg.counter(n).value for n in COUNTERS])


def _gate(net, device, **kw):
    graph = getattr(cnn, net)(batch=1, seed=0)
    gate = CNN2Gate.from_graph(graph, device=device, **kw)
    x = np.random.default_rng(1).standard_normal(
        graph.inputs[0].shape).astype(np.float32)
    gate.calibrate_quantization(x)
    return gate, x


@pytest.mark.parametrize("net,kw,want", [
    ("resnet18", {}, (8, 0, 2)),
    ("resnet18", {"fuse_skip": False}, (0, 8, 2)),
    ("resnet_tiny", {}, (2, 0, 1)),
    ("tiny_cnn_gap", {}, (0, 0, 2)),
    ("googlenet_tiny", {}, (0, 0, 3)),
    ("googlenet_tiny", {"fuse_concat": False}, (0, 2, 4)),
])
def test_a_build_counts_its_merges_and_pools(net, kw, want):
    gate, _x = _gate(net, "cpu", **kw)
    before = _counts()
    gate.build("emulation")
    assert tuple(_counts() - before) == want
    before = _counts()
    gate.build("fullflow")              # each build adds its counts
    assert tuple(_counts() - before) == want


def test_plain_calls_count_no_skip_launch():
    """On the CPU the fused add runs the plain version: no launch."""
    ops.reset_launch_counts()
    gate, x = _gate("resnet_tiny", "cpu")
    gate.build("emulation")(x)
    assert qconv.skip_launches == {"qconv": 0, "qdwconv": 0,
                                   "qconv.clip": 0, "qdwconv.clip": 0}
    qconv.skip_launches["qconv"] += 2
    ops.reset_launch_counts()
    assert qconv.skip_launches == {"qconv": 0, "qdwconv": 0,
                                   "qconv.clip": 0, "qdwconv.clip": 0}


@pytest.mark.cuda
def test_an_eager_resnet18_forward_launches_eight_skips():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the skip epilogue is CUDA code")
    gate, x = _gate("resnet18", torch.device("cuda", 0))
    run = gate.build("emulation")
    before = dict(qconv.skip_launches)
    run(x)
    torch.cuda.synchronize()
    assert qconv.skip_launches["qconv"] == before["qconv"] + 8
    assert qconv.skip_launches["qdwconv"] == before["qdwconv"]

"""The paper's whole flow on the port: parse -> quantize -> verify ->
explore -> build("fullflow") -> run -> latency report, against the JAX
package's.

The DSE is host arithmetic, so the port's best design point must equal
the JAX package's.  The reference executor runs through the shim of
``tests/torch_reference_shim.py`` (its int8 Pallas conv kernels do not build
under this jax): the unfused reference program with the conv oracle.
Its output and the port's fullflow output agree within ``atol=1e-6,
rtol=0``, the tolerance of ``tests/test_torch_e2e.py``: the int8 egress
is exact and the only float step after it is the softmax (JAX's and
PyTorch's float32 softmax differ by up to 7.5e-9 here), which one int8
step would move by far more than 1e-6.  On the CPU, ``fullflow`` is the eager
executor; the CUDA-graph executor it becomes on the card is checked by
the tests marked ``cuda`` (skipped without a card) and by
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import onnx_lite as r_onnx
from repro.core.synthesis import CNN2Gate as RGate
from repro.models import cnn as r_cnn
from repro_torch import convert
from repro_torch.core.synthesis import CapturedExecutor
from repro_torch.core.synthesis import CNN2Gate as TGate
from repro_torch.kernels import ops as t_ops
from repro_torch.models import cnn as t_cnn
from torch_reference_shim import shimmed_reference  # noqa: F401


def _spec_tuples(specs):
    return {k: (s.m_w, s.m_x, s.m_y) for k, s in specs.items()}


@pytest.mark.parametrize("name,board", [("tiny_cnn", "5CSEMA5"),
                                        ("tiny_cnn", "ARRIA10"),
                                        ("resnet_tiny", "ARRIA10")])
def test_explore_then_fullflow_matches_the_reference(shimmed_reference,
                                                     name, board):
    rg = getattr(r_cnn, name)(batch=2)
    x = np.random.default_rng(11).standard_normal(
        rg.inputs[0].shape).astype(np.float32)
    # the reference flow: calibrate, explore, run the unfused program
    r_gate = RGate.from_graph(rg, fuse_skip=False, fuse_concat=False)
    specs = _spec_tuples(r_gate.calibrate_quantization(x))
    r_fit = r_gate.explore(board, algo="rl", seed=0)
    r_bf = r_gate.explore(board, algo="bf")
    want = np.asarray(r_gate.build("emulation", *r_bf.best)(x))
    # the port's flow on its own builder's graph
    gate = TGate.from_graph(getattr(t_cnn, name)(batch=2), device="cpu")
    assert _spec_tuples(gate.calibrate_quantization(x)) == specs
    assert gate.verify().ok
    fit = gate.explore(board, algo="rl", seed=0)
    bf = gate.explore(board, algo="bf")
    assert (fit.best, fit.f_max, fit.evaluations, fit.steps, fit.history) \
        == (r_fit.best, r_fit.f_max, r_fit.evaluations, r_fit.steps,
            r_fit.history)
    assert (bf.best, bf.f_max, bf.history) == (r_bf.best, r_bf.f_max,
                                               r_bf.history)
    assert fit.found and bf.found
    run = gate.build("fullflow", *bf.best)
    assert gate.synthesis_time_s > 0 and gate.compiled is None
    assert run.design_point == tuple(bf.best) + (None,)
    got = run(x)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(got, gate.build("emulation")(x))
    # the FPGA latency model of the fused program the port built
    rep = gate.latency_report(board, *bf.best)
    r_rep = RGate.from_graph(rg).latency_report(board, *bf.best)
    assert (rep.total_s, rep.gops) == (r_rep.total_s, r_rep.gops)


def test_explore_with_the_block_h_axis_matches_the_reference():
    rg = r_cnn.tiny_cnn(batch=1)
    r_gate = RGate.from_graph(rg)
    tg = convert.graph_from_model_dict(r_onnx.to_model_dict(rg),
                                       rg.initializers)
    gate = TGate.from_graph(tg, device="cpu")
    for algo in ("bf", "rl"):
        want = r_gate.explore("5CSEMA5", algo=algo,
                              block_h_options=[1, 4, 16])
        got = gate.explore("5CSEMA5", algo=algo, block_h_options=[1, 4, 16])
        assert (got.best, got.f_max, got.history) == \
            (want.best, want.f_max, want.history)
        assert len(got.best) == 3


def test_fullflow_on_the_cpu_is_the_eager_executor():
    g = t_cnn.tiny_cnn_gap(batch=1)
    gate = TGate.from_graph(g, device="cpu")
    rng = np.random.default_rng(3)
    gate.calibrate_quantization(
        rng.standard_normal(g.inputs[0].shape).astype(np.float32))
    full = gate.build("fullflow", 4, 8)
    assert not isinstance(full, CapturedExecutor)
    assert gate.compiled is None and gate.synthesis_time_s > 0
    eager = gate.build("emulation", 4, 8)
    t_ops.reset_launch_counts()
    for batch in (1, 3):
        x = rng.standard_normal((batch, 3, 32, 32)).astype(np.float32)
        assert torch.equal(full(x), eager(x))
    # on the CPU every op is its plain version: no kernel launched
    assert not any(t_ops.launch_counts().values())


def test_captured_executor_is_for_the_card_only():
    """A CapturedExecutor lives on the card; asked for the CPU it fails
    loudly instead of running eagerly."""
    gate = TGate.from_graph(t_cnn.tiny_cnn(batch=1), device="cpu")
    gate.calibrate_quantization(np.zeros((1, 3, 32, 32), np.float32))
    with pytest.raises(ValueError, match="runs on CUDA"):
        CapturedExecutor(gate.build("emulation"), torch.device("cpu"))


# -------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA-graph executor only "
                    "exists on the card (chip_smoke.py runs it there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnet_tiny", "googlenet_tiny",
                                  "mobilenet_tiny"])
def test_fullflow_replays_the_eager_executor_on_the_card(card, name):
    g = getattr(t_cnn, name)(batch=1)
    gate = TGate.from_graph(g, device=card)
    rng = np.random.default_rng(5)
    gate.calibrate_quantization(
        rng.standard_normal(g.inputs[0].shape).astype(np.float32))
    eager = gate.build("emulation")
    t_ops.reset_launch_counts()
    full = gate.build("fullflow")
    assert isinstance(full, CapturedExecutor)
    assert gate.compiled is full.graphs[tuple(g.inputs[0].shape)][0]
    built = t_ops.launch_counts()
    xs = [torch.as_tensor(rng.standard_normal(g.inputs[0].shape)
                          .astype(np.float32), device=card) for _ in range(3)]
    ys = [full(x) for x in xs]
    # replays call no wrapper; every result kept stays its own
    assert t_ops.launch_counts() == built
    for x, y in zip(xs, ys):
        assert torch.equal(y, eager(x))
    # a new shape is captured at its first call
    xb = torch.cat(xs)
    assert torch.equal(full(xb), eager(xb)) and len(full.graphs) == 2

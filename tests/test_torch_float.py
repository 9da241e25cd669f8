"""The port's float32 oracle and calibration against the JAX package's.

Tolerance: ``rtol=1e-5, atol=1e-5`` — both packages compute in float32,
but their convolutions and products take their sums in other orders.
Calibration turns those activations into power-of-two exponents, which
must come out identical.
"""
import numpy as np
import pytest

from repro.core.synthesis import CNN2Gate as RGate
from repro.models import cnn as r_cnn
from repro_torch.core.synthesis import CNN2Gate as TGate
from repro_torch.models import cnn as t_cnn

NETS = ["tiny_cnn", "tiny_cnn_gap", "resnet_tiny", "mobilenet_tiny",
        "googlenet_tiny", "squeezenet_tiny"]


def _input(g, seed=0):
    return np.random.default_rng(seed).standard_normal(
        g.inputs[0].shape).astype(np.float32)


@pytest.mark.parametrize("name", NETS)
def test_run_float_and_activations_match(name):
    rg, tg = getattr(r_cnn, name)(batch=2), getattr(t_cnn, name)(batch=2)
    x = _input(rg)
    want = r_cnn.collect_activations(rg, x)
    got = t_cnn.collect_activations(tg, x, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(
        t_cnn.run_float(tg, x, device="cpu").numpy(),
        np.asarray(r_cnn.run_float(rg, x)), rtol=1e-5, atol=1e-5)


def test_run_float_padded_pools_and_reshape():
    """Padded max/avg pools (count_include_pad=0) and an explicit
    Reshape node through both oracles."""
    def build(mod):
        b = mod.GraphBuilder("pools", (2, 3, 9, 9), seed=5)
        b.conv(6, 3, pad=1).maxpool(3, 2, pad=1).conv(8, 3, pad=1)
        b.avgpool(3, 2, pad=1).flatten()
        b.fc(10, relu=False, softmax=True)
        return b.build()
    rg, tg = build(r_cnn), build(t_cnn)
    x = _input(rg, 3)
    np.testing.assert_allclose(
        t_cnn.run_float(tg, x, device="cpu").numpy(),
        np.asarray(r_cnn.run_float(rg, x)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("name", NETS)
def test_calibrated_specs_equal(name, per_channel):
    rg, tg = getattr(r_cnn, name)(), getattr(t_cnn, name)()
    x = _input(rg, 1)
    want = RGate.from_graph(rg).calibrate_quantization(
        x, per_channel=per_channel)
    gate = TGate.from_graph(tg, device="cpu")
    got = gate.calibrate_quantization(x, per_channel=per_channel)
    assert {k: (s.m_w, s.m_x, s.m_y) for k, s in got.items()} == \
        {k: (s.m_w, s.m_x, s.m_y) for k, s in want.items()}
    assert gate.per_channel == per_channel

"""The plain reference against the program on the CPU, at the
configurations' layer tables cut to a small size, and its control."""
import numpy as np
import pytest
import torch

from bench import model
from bench.reference import cnn as reference
from smallcells import small_config

SEEDS = (0, 2**31 + 7, 123456789012)


def program(config, layers, weights, specs, device="cpu"):
    """The program's ``fullflow`` executor, built as the harness does."""
    from repro_torch.core import onnx_lite
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.core.synthesis import CNN2Gate

    inits = {}
    for n, (w, b) in weights.items():
        inits[f"{n}_w"], inits[f"{n}_b"] = w.numpy(), b.numpy()
    gate = CNN2Gate.from_graph(onnx_lite.from_model_dict(
        model.model_dict(config, layers), inits), device=device)
    gate.apply_quantization({n: QuantSpec(*s) for n, s in specs.items()})
    return gate, gate.build("fullflow")


def inputs(name, seed, n):
    config = small_config(name)
    layers = model.layers_of(config)
    weights = model.make_weights(layers, seed, "cpu")
    x_cal = model.make_images(1, config["input"], seed, 1, "cpu")
    x = model.make_images(n, config["input"], seed, 2, "cpu")
    return config, layers, weights, x_cal, x


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["vgg16", "alexnet"])
def test_reference_equals_the_program(name, seed):
    config, layers, weights, x_cal, x = inputs(name, seed, 6)
    m_in, specs = reference.calibrate(layers, weights, x_cal)
    _gate, ex = program(config, layers, weights, specs)
    ref = reference.int_forward(layers, weights, m_in, specs, x, block=4)
    got = torch.cat([ex(x[:1]), ex(x[1:])])
    assert torch.equal(got, ref)
    # the logits are no degenerate case: many distinct int8 values
    assert torch.unique(ref).numel() > 50


@pytest.mark.parametrize("name", ["vgg16", "alexnet"])
def test_specs_are_the_programs_own_rule(name):
    """The benchmark's copy of the power-of-two rule gives the specs the
    program's calibration gives on the same image."""
    config, layers, weights, x_cal, _x = inputs(name, 5, 1)
    m_in, specs = reference.calibrate(layers, weights, x_cal)
    gate, _ex = program(config, layers, weights, specs)
    theirs = gate.calibrate_quantization(x_cal.numpy())
    assert {n: (s.m_w, s.m_x, s.m_y) for n, s in theirs.items()} == specs
    assert gate.quantized.input_m == m_in


def test_pow2_exponent():
    assert reference.pow2_exponent(1.0) == 6          # 127 / 1 -> 2**6
    assert reference.pow2_exponent(0.49) == 8
    assert reference.pow2_exponent(0.0) == 7
    assert reference.pow2_exponent(1e9) == -7
    assert reference.pow2_exponent(1e-12) == 24
    assert reference.pow2_exponent(1.0, bits=4) == 2   # 7 / 1 -> 2**2


def test_requant_rounds_half_up_and_saturates():
    acc = torch.tensor([-6.0, -5.0, -3.0, 3.0, 5.0, 6.0, 1e6, -1e6],
                       dtype=torch.float64)
    got = reference._requant(acc, 1, False, -128, 127)
    assert got.tolist() == [-3, -2, -1, 2, 3, 3, 127, -128]
    assert reference._requant(acc, 1, True, -128, 127).tolist() == \
        [0, 0, 0, 2, 3, 3, 127, 0]
    # a float round of the input rounds half to even
    q = reference._quantize(torch.tensor([0.25, 0.75, -0.25]), 1, -8, 7)
    assert q.tolist() == [0.0, 2.0, -0.0]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["vgg16", "alexnet"])
def test_control_in_int4_fails_the_comparison(name, seed):
    """The control: the reference in the precision below int8, in the
    program's place, differs from the int8 reference in most logits."""
    _config, layers, weights, x_cal, x = inputs(name, seed, 4)
    m_in, specs = reference.calibrate(layers, weights, x_cal)
    want = reference.int_forward(layers, weights, m_in, specs, x)
    m4, specs4 = reference.calibrate(layers, weights, x_cal, bits=4)
    control = reference.int_forward(layers, weights, m4, specs4, x, bits=4)
    differing = int((control != want).sum())
    assert differing > want.numel() // 2


def test_int_forward_is_exact_integer_arithmetic():
    """One conv and one FC by hand in int64 give the reference's logits."""
    config = {"name": "t", "input": [2, 5, 5], "layers": [
        {"op": "conv", "out": 3, "kernel": 3, "stride": 2, "pad": 1,
         "relu": True, "pool": [2, 1]},
        {"op": "fc", "out": 4, "relu": False}]}
    layers = model.layers_of(config)
    weights = model.make_weights(layers, 3, "cpu")
    x = model.make_images(2, config["input"], 3, 2, "cpu")
    m_in, specs = reference.calibrate(layers, weights, x[:1])
    got = reference.int_forward(layers, weights, m_in, specs, x)

    def q(a, m, lo=-128, hi=127):
        return np.clip(np.rint(a.double().numpy() * 2.0 ** m), lo, hi
                       ).astype(np.int64)

    def requant(acc, s, relu):
        if s > 0:
            acc = (acc + (1 << (s - 1))) >> s
        if relu:
            acc = np.maximum(acc, 0)
        return np.clip(acc, -128, 127)

    (w1, b1), (w2, b2) = weights["conv1"], weights["fc2"]
    (mw1, mx1, my1), (mw2, mx2, my2) = specs["conv1"], specs["fc2"]
    h = np.pad(q(x, m_in), ((0, 0), (0, 0), (1, 1), (1, 1)))
    wq, bq = q(w1, mw1), q(b1, mw1 + mx1, -2**31, 2**31 - 1)
    acc = np.zeros((2, 3, 3, 3), np.int64)
    for i in range(3):
        for j in range(3):
            patch = h[:, :, 2 * i:2 * i + 3, 2 * j:2 * j + 3]
            acc[:, :, i, j] = np.einsum("nchw,ochw->no", patch, wq) + bq
    a = requant(acc, mw1 + mx1 - my1, True)
    a = np.maximum.reduce([a[:, :, di:di + 2, dj:dj + 2]
                           for di in (0, 1) for dj in (0, 1)])
    acc2 = a.reshape(2, -1) @ q(w2, mw2) + q(b2, mw2 + mx2, -2**31, 2**31 - 1)
    want = requant(acc2, mw2 + mx2 - my2, False) * 2.0 ** -my2
    assert np.array_equal(got.numpy(), want.astype(np.float32))

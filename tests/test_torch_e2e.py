"""The port's int8 executor end to end against the JAX package's.

The JAX package's int8 executor runs through the shim of
``tests/torch_reference_shim.py`` (scoped to each test with
``monkeypatch``), on the **unfused** program (``fuse_skip=False,
fuse_concat=False``), since the shim's conv oracle has no fused
epilogues; the reference's own contract is fused == unfused bit for bit.

Tolerance ``atol=1e-6, rtol=0``: the int8 egress is exact and the only
float step after it is the softmax, which one int8 step would move by
far more than 1e-6.
"""
import numpy as np
import pytest
import torch

from repro.core import onnx_lite as r_onnx
from repro.core.synthesis import CNN2Gate as RGate
from repro.models import cnn as r_cnn
from repro_torch import convert
from repro_torch.core import pipeline as t_pipe
from repro_torch.core.quantize import QuantSpec
from repro_torch.core.synthesis import CNN2Gate as TGate
from repro_torch.models import cnn as t_cnn
from torch_reference_shim import shimmed_reference  # noqa: F401

NETS = ["tiny_cnn", "tiny_cnn_gap", "resnet_tiny", "googlenet_tiny",
        "squeezenet_tiny", "mobilenet_tiny"]


def _spec_tuples(specs):
    return {k: (s.m_w, s.m_x, s.m_y) for k, s in specs.items()}


def _reference_run(graph, x, per_channel):
    gate = RGate.from_graph(graph, fuse_skip=False, fuse_concat=False)
    specs = gate.calibrate_quantization(x, per_channel=per_channel)
    return np.asarray(gate.build("emulation")(x)), _spec_tuples(specs)


def _port_gate(graph, specs, **parse_kw):
    tg = convert.graph_from_model_dict(r_onnx.to_model_dict(graph),
                                       graph.initializers)
    gate = TGate.from_graph(tg, device="cpu", **parse_kw)
    gate.apply_quantization(convert.specs_from_tuples(specs))
    return gate


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("name", NETS)
def test_fused_port_matches_unfused_reference(shimmed_reference, name,
                                              per_channel):
    graph = getattr(r_cnn, name)(batch=2)
    x = np.random.default_rng(7).standard_normal(
        graph.inputs[0].shape).astype(np.float32)
    want, specs = _reference_run(graph, x, per_channel)
    fused = _port_gate(graph, specs)
    got = fused.build("emulation")(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    unfused = _port_gate(graph, specs, fuse_skip=False, fuse_concat=False)
    assert torch.equal(unfused.build()(x), got)
    assert torch.equal(t_pipe.run_int8(fused.quantized, x), got)
    assert fused.per_channel == per_channel


def _dw_skip(mod):
    """``tests/test_skip_fusion.py``'s ``dwadd`` graph: the Add folds
    onto a depthwise producer."""
    b = mod.GraphBuilder("dwadd", (2, 3, 12, 12), 4)
    b.conv(16, 3, pad=1)
    split = b.tap()
    b.dwconv(3, pad=1, relu=False)
    left = b.tap()
    b.from_tap(split).dwconv(3, pad=1, relu=False)
    b.add_from(left, relu=True)
    b.global_avgpool()
    b.fc(3, relu=False, softmax=True)
    return b.build()


def _dw_concat(mod):
    """A depthwise branch (multiplier 2) and a dense branch into one
    Concat, its max-pool absorbed by the merge."""
    b = mod.GraphBuilder("dwcat", (2, 3, 12, 12), 6)
    b.conv(8, 3, pad=1)
    split = b.tap()
    b.conv(16, 3, pad=1, group=8, relu=False)
    dw = b.tap()
    b.from_tap(split).conv(6, 3, pad=1)
    b.concat_from(dw).maxpool(2, 2)
    b.fc(5, relu=False, softmax=True)
    return b.build()


def _grouped(mod):
    """``tests/test_dag_executor.py``'s group=2 graph."""
    b = mod.GraphBuilder("grouped", (2, 3, 10, 10), 5)
    b.conv(8, 3, pad=1)
    b.conv(8, 3, pad=1, group=2)
    b.global_avgpool()
    b.fc(4, relu=False, softmax=True)
    return b.build()


GRAPHS = {"dw_skip": (_dw_skip, lambda l: l.is_dw_kernel
                      and l.merge is not None),
          "dw_concat": (_dw_concat, lambda l: l.is_dw_kernel
                        and l.concat is not None),
          "grouped": (_grouped, lambda l: l.kind == "conv" and l.group > 1
                      and not l.is_dw_kernel)}


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("name", GRAPHS)
def test_depthwise_and_grouped_graphs_match_unfused_reference(
        shimmed_reference, name, per_channel):
    """The fused skip and concat on depthwise producers, and a ragged
    grouped conv, end to end against the shimmed unfused reference."""
    build, stage = GRAPHS[name]
    graph = build(r_cnn)
    x = np.random.default_rng(5).standard_normal(
        graph.inputs[0].shape).astype(np.float32)
    want, specs = _reference_run(graph, x, per_channel)
    fused = _port_gate(graph, specs)
    assert any(stage(l) for l in fused.parsed.layers)
    got = fused.build("emulation")(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    unfused = _port_gate(graph, specs, fuse_skip=False, fuse_concat=False)
    assert torch.equal(unfused.build()(x), got)
    own = TGate.from_graph(build(t_cnn), device="cpu")
    assert _spec_tuples(own.calibrate_quantization(
        x, per_channel=per_channel)) == specs


def test_logits_without_softmax_are_bit_exact(shimmed_reference):
    """A head without softmax: the dequantized int8 logits themselves
    must be equal, through a residual block, a concat and a padded
    standalone max-pool."""
    def build(mod):
        b = mod.GraphBuilder("custom", (2, 3, 16, 16), seed=9)
        b.conv(8, 3, pad=1).maxpool(3, 2, pad=1)
        skip = b.tap()
        b.conv(8, 3, pad=1).conv(8, 3, pad=1, relu=False).add_from(skip)
        left = b.tap()
        b.conv(6, 1)
        right = b.tap()
        b.from_tap(left).conv(4, 3, pad=1).concat_from(right)
        b.maxpool(2, 2).fc(12).fc(5, relu=False, softmax=False)
        return b.build()
    graph = build(r_cnn)
    x = np.random.default_rng(2).standard_normal(
        graph.inputs[0].shape).astype(np.float32)
    for per_channel in (False, True):
        want, specs = _reference_run(graph, x, per_channel)
        gate = _port_gate(graph, specs)
        assert any(l.merge is not None for l in gate.parsed.layers)
        assert any(l.concat_fused for l in gate.parsed.layers)
        np.testing.assert_array_equal(gate.build()(x).numpy(), want)
        own = TGate.from_graph(build(t_cnn), device="cpu")
        assert _spec_tuples(own.calibrate_quantization(
            x, per_channel=per_channel)) == specs


def test_fullflow_runs_once_and_matches_emulation():
    g = t_cnn.resnet_tiny()
    x = np.random.default_rng(0).standard_normal(
        g.inputs[0].shape).astype(np.float32)
    gate = TGate.from_graph(g, device="cpu")
    gate.calibrate_quantization(x)
    full = gate.build("fullflow", n_i=8, n_l=16, block_h=4)
    assert gate.synthesis_time_s > 0
    assert full.design_point == (8, 16, 4)
    assert torch.equal(full(x), gate.build("emulation")(x))
    with pytest.raises(ValueError, match="unknown mode"):
        gate.build("bitstream")
    assert "resnet_tiny" in gate.summary()


@pytest.mark.parametrize("kw", [dict(n_i=4), dict(block_h=4),
                                dict(n_i=8, n_l=8, block_h=2)],
                         ids=["n_i4", "block_h4", "n_i8_n_l8_block_h2"])
def test_run_int8_takes_the_reference_design_point(shimmed_reference, kw):
    """``run_int8(qm, x, n_i=, n_l=, block_h=)`` as the reference's callers
    write it: the same logits as the reference's ``run_int8``, and one
    executor cached per (n_i, n_l, block_h), beside the default's."""
    import jax.numpy as jnp
    from repro.core import pipeline as r_pipe
    graph = r_cnn.tiny_cnn(batch=2)
    x = np.random.default_rng(3).standard_normal(
        graph.inputs[0].shape).astype(np.float32)
    rgate = RGate.from_graph(graph, fuse_skip=False, fuse_concat=False)
    specs = _spec_tuples(rgate.calibrate_quantization(x))
    want = np.asarray(r_pipe.run_int8(rgate.quantized, jnp.asarray(x), **kw))
    qm = _port_gate(graph, specs).quantized
    got = t_pipe.run_int8(qm, x, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(t_pipe.run_int8(qm, x), got)
    key = (kw.get("n_i", 16), kw.get("n_l", 32), kw.get("block_h"))
    assert sorted(qm._executors, key=str) == sorted({key, (16, 32, None)},
                                                    key=str)
    ex = qm._executors[key]
    t_pipe.run_int8(qm, x, **kw)
    assert qm._executors[key] is ex
    assert ex.design_point == key


def test_hardware_options_is_the_parsed_models_method():
    """``qm.hardware_options()`` as in the reference: a property that
    returns the parsed model's method."""
    graph = r_cnn.resnet_tiny(batch=1)
    x = np.random.default_rng(0).standard_normal(
        graph.inputs[0].shape).astype(np.float32)
    rgate = RGate.from_graph(graph)
    specs = _spec_tuples(rgate.calibrate_quantization(x))
    qm = _port_gate(graph, specs).quantized
    assert qm.hardware_options()[:4] == [(1, 1), (1, 2), (1, 4), (1, 8)]
    assert qm.hardware_options() == rgate.quantized.hardware_options()
    assert qm.hardware_options(8) == rgate.quantized.hardware_options(8)


def test_build_quantized_rejects_what_the_reference_rejects():
    g = t_cnn.resnet_tiny()
    gate = TGate.from_graph(g, device="cpu")
    x = np.random.default_rng(0).standard_normal(
        g.inputs[0].shape).astype(np.float32)
    specs = gate.calibrate_quantization(x, per_channel=True)
    with pytest.raises(ValueError, match="QV206"):
        t_pipe.build_quantized(gate.parsed, specs, per_channel=False,
                               device="cpu")
    # a merge spec whose common position lies above an operand's
    add = next(l.merge for l in gate.parsed.layers if l.merge is not None)
    bad = dict(specs)
    bad[add.name] = QuantSpec(0, specs[add.name].m_x + 3,
                              specs[add.name].m_y)
    with pytest.raises(ValueError, match="QV202"):
        t_pipe.build_quantized(gate.parsed, bad, device="cpu")
    unfused = TGate.from_graph(g, fuse_skip=False, device="cpu")
    add = next(l for l in unfused.parsed.layers if l.kind == "add")
    bad = dict(specs)
    bad[add.name] = QuantSpec(0, specs[add.name].m_x + 3,
                              specs[add.name].m_y)
    with pytest.raises(ValueError, match="QV202"):
        t_pipe.build_quantized(unfused.parsed, bad, device="cpu")
    with pytest.raises(RuntimeError, match="first"):
        TGate.from_graph(g, device="cpu").build()


def test_layer_bytes_match_reference():
    from repro.core import pipeline as r_pipe
    from repro.core.parser import parse as r_parse
    from repro_torch.core.parser import parse as t_parse
    for name in ("googlenet_tiny", "resnet_tiny", "squeezenet_tiny"):
        rp = r_parse(getattr(r_cnn, name)())
        tp = t_parse(getattr(t_cnn, name)())
        assert [r_pipe.layer_bytes(l) for l in rp.layers] == \
            [t_pipe.layer_bytes(l) for l in tp.layers]


# ------------------------------------------ facts of the reference, pinned

def _run_both(build, x):
    """(int8 output, float output, calibrated specs) of one graph in each
    package: the port on the CPU, the reference through the shim."""
    out = {}
    for name, mod, gate_cls, kw in (("port", t_cnn, TGate, {"device": "cpu"}),
                                    ("reference", r_cnn, RGate, {})):
        graph = build(mod)
        gate = gate_cls.from_graph(graph, **kw)
        specs = _spec_tuples(gate.calibrate_quantization(x))
        out[name] = (np.asarray(gate.build("emulation")(x)),
                     np.asarray(mod.run_float(graph, x, **kw)), specs)
    return out


def test_final_fc_output_scale_is_calibrated_on_the_softmax(
        shimmed_reference):
    """The parser fuses a Softmax into its FC, so calibration takes the
    probabilities' exponent (m_y 7) for the FC's int8 output, which holds
    the pre-softmax logits: they clip at 127 / 128 and three classes tie
    at the top, where the float model's top-1 is 3.  Both packages give
    the same numbers."""
    x = (4 * np.random.default_rng(1).standard_normal((1, 12))).astype(
        np.float32)
    runs = _run_both(lambda mod: mod.GraphBuilder("fc1", (1, 12), 0).fc(
        4, relu=False, softmax=True).build(), x)
    for int8, flt, specs in runs.values():
        assert specs == {"gemm_1": (7, 4, 7)}
        np.testing.assert_allclose(int8[0], [0.2553, 0.2342, 0.2553, 0.2553],
                                   atol=1e-4)
        np.testing.assert_allclose(flt[0], [0.0014, 0.0007, 0.1292, 0.8687],
                                   atol=1e-4)
        assert int(int8.argmax()) == 0 and int((int8 == int8.max()).sum()) == 3
        assert int(flt.argmax()) == 3
    np.testing.assert_allclose(runs["port"][0], runs["reference"][0], rtol=0,
                               atol=1e-6)


def test_fc_on_a_4d_graph_input_reads_its_weight_rows_out_of_order(
        shimmed_reference):
    """The executor transposes a 4-D graph input to NHWC, but the FC's
    rows are reordered to the NHWC flatten only when a stage produces its
    input: an FC fed straight from the graph input reads them in NCHW
    order.  The same weights on the flattened (1, 12) input agree with the
    float model to int8 precision.  Both packages give the same numbers."""
    x = (4 * np.random.default_rng(0).standard_normal((1, 3, 2, 2))).astype(
        np.float32)
    runs = _run_both(lambda mod: mod.GraphBuilder("fc1", (1, 3, 2, 2), 0).fc(
        2, relu=False).build(), x)
    flat = _run_both(lambda mod: mod.GraphBuilder("fc1", (1, 12), 0).fc(
        2, relu=False).build(), x.reshape(1, 12))
    for name in ("port", "reference"):
        int8, flt, _ = runs[name]
        np.testing.assert_array_equal(int8[0], [-3.9375, -0.625])
        np.testing.assert_allclose(flt[0], [-7.2097, -3.1334], atol=1e-4)
        np.testing.assert_array_equal(flat[name][0][0], [-7.1875, -3.0625])
        np.testing.assert_allclose(flat[name][1], flt, atol=1e-5)

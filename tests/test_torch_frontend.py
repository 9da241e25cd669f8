"""The port's front end against the JAX package's: graphs, initializers,
the stage program and the quantization helpers must agree exactly."""
import dataclasses

import numpy as np
import pytest

from repro.core import onnx_lite as r_onnx
from repro.core import parser as r_parser
from repro.core import quantize as r_quant
from repro.models import cnn as r_cnn
from repro_torch import convert
from repro_torch.core import onnx_lite as t_onnx
from repro_torch.core import parser as t_parser
from repro_torch.core import quantize as t_quant
from repro_torch.models import cnn as t_cnn

ZOO = [("tiny_cnn", {}), ("tiny_cnn_gap", {}), ("resnet_tiny", {}),
       ("mobilenet_tiny", {}), ("googlenet_tiny", {}),
       ("squeezenet_tiny", {}), ("resnet18", {}),
       ("alexnet", {"channels_base": 8}), ("vgg16", {})]


@pytest.fixture(scope="module")
def graphs():
    cache = {}

    def get(name, kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = (getattr(r_cnn, name)(**kw),
                          getattr(t_cnn, name)(**kw))
        return cache[key]
    return get


@pytest.mark.parametrize("name,kw", ZOO, ids=[z[0] for z in ZOO])
def test_initializers_byte_identical(graphs, name, kw):
    rg, tg = graphs(name, kw)
    assert list(rg.initializers) == list(tg.initializers)
    for k, v in rg.initializers.items():
        assert v.dtype == tg.initializers[k].dtype
        assert v.tobytes() == tg.initializers[k].tobytes(), k
    assert r_onnx.to_model_dict(rg) == t_onnx.to_model_dict(tg)
    assert rg.tensor_shapes == tg.tensor_shapes


def _pool_fields(p):
    if p is None:
        return None
    return (p.kind, p.name, tuple(p.inputs), p.output, tuple(p.in_shape),
            tuple(p.out_shape), p.kernel_shape, p.strides, p.pads,
            p.pool_type, p.relu, p.softmax)


def _layer_fields(li):
    return dict(
        kind=li.kind, name=li.name, inputs=tuple(li.inputs),
        output=li.output, weight=li.weight, bias=li.bias,
        in_shape=tuple(li.in_shape), out_shape=tuple(li.out_shape),
        kernel_shape=li.kernel_shape, strides=li.strides, pads=li.pads,
        dilations=li.dilations, group=li.group, axis=li.axis,
        relu=li.relu, softmax=li.softmax, pool=_pool_fields(li.pool),
        pool_type=li.pool_type,
        merge=None if li.merge is None else (
            li.merge.name, tuple(li.merge.inputs), li.merge.output,
            li.merge.relu),
        skip_input=li.skip_input,
        concat=None if li.concat is None else li.concat.name,
        concat_offset=li.concat_offset, concat_fused=li.concat_fused,
        macs=li.macs, weight_count=li.weight_count(),
        prev=None if li.prev is None else li.prev.name,
        next=None if li.next is None else li.next.name)


@pytest.mark.parametrize("fuse", [(True, True), (False, False)],
                         ids=["fused", "unfused"])
@pytest.mark.parametrize("name,kw", ZOO, ids=[z[0] for z in ZOO])
def test_stage_program_field_equal(graphs, name, kw, fuse):
    rg, tg = graphs(name, kw)
    rp = r_parser.parse(rg, fuse_skip=fuse[0], fuse_concat=fuse[1])
    tp = t_parser.parse(tg, fuse_skip=fuse[0], fuse_concat=fuse[1])
    assert [_layer_fields(l) for l in rp.layers] == \
        [_layer_fields(l) for l in tp.layers]
    assert (rp.input_name, rp.input_shape, rp.output_name) == \
        (tp.input_name, tp.input_shape, tp.output_name)
    assert rp.hardware_options() == tp.hardware_options()
    assert r_parser.memory_schedule(rp, 8, 16) == \
        t_parser.memory_schedule(tp, 8, 16)


@pytest.mark.parametrize("name", ["tiny_cnn", "resnet_tiny", "mobilenet_tiny",
                                  "googlenet_tiny", "alexnet"])
def test_quantize_helpers_agree(graphs, name):
    rg, tg = graphs(name, {"channels_base": 8} if name == "alexnet" else {})
    assert t_quant.MAX_SHIFT == r_quant.MAX_SHIFT
    rng = np.random.default_rng(3)
    for k, w in rg.initializers.items():
        tw = tg.initializers[k]
        assert t_quant.best_pow2_exponent(tw) == r_quant.best_pow2_exponent(w)
        if w.ndim < 2:
            continue
        rpc = r_quant.best_pow2_exponents_per_channel(w)
        assert t_quant.best_pow2_exponents_per_channel(tw) == rpc
        m_x, m_y = int(rng.integers(0, 8)), int(rng.integers(-2, 6))
        bias = rg.initializers.get(k[:-2] + "_b")
        for m_w in (int(rng.integers(4, 10)), rpc):
            rs = r_quant.QuantSpec(m_w, m_x, m_y)
            ts = convert.spec(m_w, m_x, m_y)
            assert r_quant.shift_lanes(rs) == t_quant.shift_lanes(ts)
            rw, rb = r_quant.quantize_weights(w, bias, rs)
            tw_q, tb_q = t_quant.quantize_weights(tw, bias, ts)
            np.testing.assert_array_equal(rw, tw_q)
            np.testing.assert_array_equal(rb, tb_q)
            try:
                want = rs.requant_shift
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)[:20]):
                    ts.requant_shift
            else:
                assert ts.requant_shift == want
                acc = rng.integers(-2 ** 20, 2 ** 20,
                                   (5, w.shape[0] if w.ndim == 4
                                    else w.shape[-1]))
                np.testing.assert_array_equal(
                    r_quant.requantize(acc, rs, relu=True),
                    t_quant.requantize(acc, ts, relu=True))


def test_onnx_lite_round_trip(graphs, tmp_path):
    rg, tg = graphs("googlenet_tiny", {})
    path = str(tmp_path / "m")
    t_onnx.save(tg, path)
    back = t_onnx.load(path)
    assert t_onnx.to_model_dict(back) == t_onnx.to_model_dict(tg)
    for k, v in tg.initializers.items():
        np.testing.assert_array_equal(back.initializers[k], v)
    # the JAX package's file loads in the port and vice versa
    r_onnx.save(rg, str(tmp_path / "r"))
    assert t_onnx.to_model_dict(t_onnx.load(str(tmp_path / "r"))) == \
        r_onnx.to_model_dict(rg)
    assert r_onnx.to_model_dict(r_onnx.load(path)) == \
        t_onnx.to_model_dict(tg)


def test_convert_carries_graph_and_specs(graphs):
    rg, _ = graphs("resnet_tiny", {})
    tg = convert.graph_from_model_dict(r_onnx.to_model_dict(rg),
                                       rg.initializers)
    assert t_onnx.to_model_dict(tg) == r_onnx.to_model_dict(rg)
    specs = convert.specs_from_tuples({"a": (5, 4, 3), "b": ((5, 6), 1, 0),
                                       "c": (np.array([2, 3]), 1, 1)})
    assert specs == {"a": t_quant.QuantSpec(5, 4, 3),
                     "b": t_quant.QuantSpec((5, 6), 1, 0),
                     "c": t_quant.QuantSpec((2, 3), 1, 1)}
    assert all(type(v) is int for s in specs.values()
               for v in (s.m_x, s.m_y) + (s.m_w if s.per_channel
                                          else (s.m_w,)))
    assert dataclasses.is_dataclass(specs["a"])


def test_ingress_rejects_like_the_reference():
    g = t_cnn.tiny_cnn()
    d = t_onnx.to_model_dict(g)
    bad = dict(g.initializers)
    bad["conv_1_w"] = bad["conv_1_w"].copy()
    bad["conv_1_w"][0, 0, 0, 0] = np.nan
    with pytest.raises(t_onnx.GraphValidationError, match="non-finite"):
        t_onnx.from_model_dict(d, bad)
    with pytest.raises(t_onnx.GraphValidationError, match="malformed"):
        t_onnx.from_model_dict({"nodes": {}}, {})

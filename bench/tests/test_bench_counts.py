"""The benchmark's op and byte counts at the configurations' full
shapes, pinned to the published totals."""
import pytest

from bench import counts, model


def totals(name):
    layers = model.layers_of(model.load_config(name))
    macs = sum(l.macs for l in layers)
    params = sum(counts.weight_bytes(l) + l.out for l in layers)
    fc_bytes = sum(counts.weight_bytes(l) for l in layers if l.op == "fc")
    return layers, macs, params, fc_bytes


@pytest.mark.parametrize("name,gmac,mparams,fc_mb,n_conv,n_fc", [
    ("vgg16", 15.47, 138.4, 123.6, 13, 3),
    ("alexnet", 0.714, 61.1, 58.6, 5, 3),
])
def test_totals_match_the_published_models(name, gmac, mparams, fc_mb,
                                           n_conv, n_fc):
    layers, macs, params, fc_bytes = totals(name)
    assert round(macs / 1e9, 3 if gmac < 1 else 2) == gmac
    assert round(params / 1e6, 1) == mparams
    assert round(fc_bytes / 1e6, 1) == fc_mb
    assert [l.op for l in layers].count("conv") == n_conv
    assert [l.op for l in layers].count("fc") == n_fc


def test_shapes_follow_the_papers():
    vgg = model.layers_of(model.load_config("vgg16"))
    assert vgg[-3].in_shape == (512 * 7 * 7,)
    assert vgg[0].conv_hw == (224, 224) and vgg[1].out_shape == (64, 112, 112)
    alex = model.layers_of(model.load_config("alexnet"))
    assert alex[0].conv_hw == (55, 55) and alex[0].fan_in == 363
    assert alex[0].out_shape == (64, 27, 27)
    assert alex[1].out_shape == (192, 13, 13)
    assert alex[-3].in_shape == (9216,)


def test_bounds_take_the_longer_of_ops_and_bytes():
    vgg = model.layers_of(model.load_config("vgg16"))
    fc6, conv1 = vgg[-3], vgg[0]
    # fc6 at batch 1 moves 102.8 MB of weight: bytes bound it
    assert counts.bound_s(fc6) == pytest.approx(
        counts.call_bytes(fc6) / counts.HBM_BYTES_PER_S)
    assert counts.call_bytes(fc6) == 25088 + 25088 * 4096 + 4 * 4096 + 4096
    # conv1_2 at batch 64: operations bound it
    c = vgg[1]
    assert counts.bound_s(c, 64) == pytest.approx(
        counts.ops(c, 64) / counts.INT8_OPS_PER_S)
    assert counts.ops(conv1, 2) == 2 * 2 * 224 * 224 * 64 * 27
    f = counts.forward_counts(vgg, 64)
    assert f["ops"] == 2 * 64 * sum(l.macs for l in vgg)
    # VGG-16's convs at batch 64: 0.99 ms of operations, and conv1_1's
    # 205 MB output is bound by bytes (61 us against 5.6 us of ops)
    assert 1.04e-3 < f["conv_bound_s"] < 1.06e-3
    assert counts.bound_s(conv1, 64) == pytest.approx(
        counts.call_bytes(conv1, 64) / counts.HBM_BYTES_PER_S)

"""``tools/host_walls.py``, the paired host-time comparison of two
checkouts, run on the CPU at a small size so that it cannot rot between
the runs on the card."""
import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "host_walls", ROOT / "tools" / "host_walls.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_host_walls_measures_every_model_and_conv_on_the_cpu():
    tool = _tool()
    # the card's model list and conv shapes, at small sizes
    assert [m[0] for m in tool.MODELS] == ["vgg16", "mobilenet_tiny",
                                           "resnet18", "resnet18_per_channel"]
    out = tool.measure(str(ROOT), device="cpu",
                       models=(("tiny", "tiny_cnn", {}, 32, False),
                               ("tiny_per_channel", "tiny_cnn", {}, 32,
                                True)),
                       convs=(("conv_small", (1, 6, 6, 16), (3, 3, 16, 8),
                               (2, 2)),),
                       runs=2, calls=2)
    assert out["tree"] == str(ROOT)
    for name in ("tiny", "tiny_per_channel"):
        r = out[name]
        assert set(r) == {"wall_ms_median", "wall_ms_min", "enqueue_ms"}
        assert 0 < r["wall_ms_min"] <= r["wall_ms_median"]
        assert r["enqueue_ms"] > 0
    assert out["conv_small_enqueue_us"] > 0

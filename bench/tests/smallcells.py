"""The benchmark's configurations cut to a CPU's size, for its tests."""
import copy
import json

from conftest import ROOT

#: input sizes at which every pool of a configuration still has a window
SMALL_INPUT = {"vgg16": 32, "alexnet": 67}


def small_config(name: str, div: int = 16) -> dict:
    """The configuration with every width but the classes divided by
    ``div`` and a small input: the same kernels, strides, pads and pools
    at a size the CPU runs in a moment."""
    from bench import model
    c = copy.deepcopy(model.load_config(name))
    c["input"] = [3, SMALL_INPUT[name], SMALL_INPUT[name]]
    for layer in c["layers"][:-1]:
        layer["out"] = max(4, layer["out"] // div)
    return c


def bench_with(tmp_path, name: str) -> dict:
    """BENCHMARK.json with configuration ``name`` pointed at its small
    form, written under ``tmp_path``."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(small_config(name)))
    for conf in bench["configs"]:
        if conf["name"] == name:
            conf["file"] = str(path)
    return bench

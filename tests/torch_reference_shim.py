"""The shim that runs the JAX package's int8 executor on the CPU, for
the port's parity tests.

The JAX package's int8 executor does not run under jax >= 0.9 (its
Pallas conv kernels use APIs that release removed), so the reference is
run through a shim scoped to each test with ``monkeypatch``: the renamed
``pltpu.TPUCompilerParams`` is restored, which brings the reference
``qgemm`` kernel back, and ``ops.qconv2d_nhwc`` becomes "pad, then the
``ref.qconv2d_ref`` oracle".  The oracle has no fused epilogues, so the
reference program must be the **unfused** one (``fuse_skip=False,
fuse_concat=False``); its own contract is fused == unfused bit for bit.

Never applied at import: with ``-n 6 --dist loadfile`` a worker also
runs the JAX package's own test files.  Test modules take the fixture
with ``from torch_reference_shim import shimmed_reference``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref


def oracle_conv(x, w, b, *, strides=(1, 1), pads=(0, 0, 0, 0), shift=0,
                relu=True, pool=None, groups=1, **merge):
    assert merge.get("skip") is None and merge.get("out_buf") is None
    if any(pads):
        x = jnp.pad(x, ((0, 0), (pads[0], pads[2]), (pads[1], pads[3]),
                        (0, 0)))
    s = jnp.asarray(shift, jnp.int32) if isinstance(shift, tuple) else shift
    return r_ref.qconv2d_ref(x, w, b, strides, s, relu, pool, groups)


@pytest.fixture
def shimmed_reference(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    monkeypatch.setattr(r_ops, "qconv2d_nhwc", oracle_conv)


def calibrated_pair(name, per_channel=False, fused=False, seed=0,
                    scale=0.5):
    """(JAX package gate, port gate on the CPU, input) of zoo model
    ``name`` at batch 1, each from its own package's builder, both
    calibrated on the same seeded input (the packages calibrate the same
    specs, checked here).  Building and calibrating runs no int8 kernel,
    so this needs no shim; running the reference executor does."""
    from repro.core.synthesis import CNN2Gate as RGate
    from repro.models import cnn as r_cnn
    from repro_torch.core.synthesis import CNN2Gate as TGate
    from repro_torch.models import cnn as t_cnn

    kw = dict(fuse_skip=fused, fuse_concat=fused)
    rg = RGate.from_graph(getattr(r_cnn, name)(batch=1), **kw)
    tg = TGate.from_graph(getattr(t_cnn, name)(batch=1), device="cpu", **kw)
    x = (np.random.default_rng(seed).standard_normal(rg.parsed.input_shape)
         * scale).astype(np.float32)
    rs = rg.calibrate_quantization(x, per_channel=per_channel)
    ts = tg.calibrate_quantization(x, per_channel=per_channel)
    assert {k: (s.m_w, s.m_x, s.m_y) for k, s in rs.items()} == \
        {k: (s.m_w, s.m_x, s.m_y) for k, s in ts.items()}
    return rg, tg, x

"""Checks that need an NVIDIA GPU.  chip_smoke.py runs them on the
card (``pytest -m gpu --noconftest``); elsewhere the ``gpu`` fixture
skips them.  The suite's conftest pins the CPU, so these skip in a
normal ``pytest`` run."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

import bench
from ltjax.step import make_external_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no NVIDIA GPU visible to JAX")
    return devs[0]


@pytest.mark.parametrize("variant", ["advect", "turb", "curv"])
def test_gpu_step_matches_cpu_step(gpu, variant):
    """The step XLA compiles for the card agrees with the CPU's compile
    of the same float32 program to a few float32 ulps of the domain."""
    cfg, ctx, fs, p = bench.build(numpar=4096, nx=48, ny=48, us=10,
                                  variant=variant)
    step = make_external_step(ctx, cfg, jr.key(0))
    cpu = jax.devices("cpu")[0]
    outs = []
    for dev in (gpu, cpu):
        args = jax.device_put((p, fs), dev)
        outs.append(jax.block_until_ready(step(*args, 0.0, 0)))
    g, c = outs
    np.testing.assert_array_equal(np.asarray(g.status), np.asarray(c.status))
    ulp = float(np.spacing(np.float32(48e3)))
    for f in ("x", "y"):
        np.testing.assert_allclose(np.asarray(getattr(g, f)),
                                   np.asarray(getattr(c, f)), rtol=0,
                                   atol=cfg.internal_steps * ulp)
    assert jnp.isfinite(g.z).all()

"""bench.py off the card: every variant's case builds and steps on the
fast path with no ERROR (chip_smoke.py phase 4 runs the same variants
on the GPU at 100k particles), the byte model counts what the fast
path moves, and the bandwidth table refuses an unknown card."""

import jax
import jax.random as jr
import numpy as np
import pytest

import bench
from ltjax import state as st
from ltjax.step import make_external_step, mode_flags


@pytest.mark.parametrize("variant", bench.VARIANTS)
def test_variant_steps_clean(variant):
    cfg, ctx, fs, p = bench.build(numpar=512, nx=24, ny=24, us=6,
                                  variant=variant)
    assert mode_flags(cfg) == "fast"
    out = jax.block_until_ready(
        make_external_step(ctx, cfg, jr.key(0))(p, fs, 0.0, 0))
    status = np.asarray(out.status)
    assert (status == st.ERROR).sum() == 0
    assert np.isfinite(np.asarray(out.x)).all()
    assert np.isfinite(np.asarray(out.z)).all()
    assert np.abs(np.asarray(out.x) - np.asarray(p.x)).max() > 1.0


def test_interp_bytes_model():
    cfg, ctx, fs, p = bench.build(numpar=1000, nx=24, ny=24, us=6)
    one = bench.interp_bytes(1000, ctx.grid, 1)
    two = bench.interp_bytes(2000, ctx.grid, 1)
    # each extra particle gathers 8 pair rows of 4*HL float32 lanes
    # per internal step (HL = 64 lanes for us <= 20) plus its x, y, z
    # in and out
    assert two - one == 1000 * (8 * 4 * 64 + 6) * 4
    assert bench.interp_bytes(1000, ctx.grid, 30) == 30 * one


def test_peak_table_refuses_unknown_cards():
    assert bench.peak_hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError):
        bench.peak_hbm_bytes_per_s("cpu")


def test_bench_main_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr("sys.argv", ["bench.py"])
    with pytest.raises(SystemExit, match="measures the GPU"):
        bench.main()

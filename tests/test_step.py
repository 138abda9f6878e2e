"""End-to-end internal/external step tests on the analytic case."""

import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
import pytest

from ltjax import state as st
from ltjax import synth
from ltjax.config import Config
from ltjax.physics import boundary as bd
from ltjax.step import StepContext, make_external_step, summary_counts


def _setup(cfg, omega=1e-4, shear_a=0.0):
    case = synth.make_solid_body_case(nx=41, ny=41, us=10, lx=100e3,
                                      ly=100e3, h0=50.0, omega=omega,
                                      shear_a=shear_a)
    bounds = bd.build_boundaries(np.asarray(case.grid.mask_rho),
                                 np.asarray(case.grid.x_rho),
                                 np.asarray(case.grid.y_rho),
                                 closed_edges=False)
    ctx = StepContext(grid=case.grid, bounds=bounds, polys=None, holes=None)
    return case, ctx


def test_external_step_advection_only_matches_analytic():
    cfg = Config(numpar=32, dt=3600, idt=120, days=1.0, us=10, ws=11,
                 HTurbOn=False, VTurbOn=False, Behavior=0,
                 settlementon=False, OpenOceanBoundary=True)
    case, ctx = _setup(cfg, shear_a=0.002)
    fs = synth.fieldset_for(case, t_center=0.0, dt=3600.0)

    rng = np.random.default_rng(0)
    n = cfg.numpar
    x0 = rng.uniform(40e3, 60e3, n)
    y0 = rng.uniform(40e3, 60e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    p = st.init_particles(x0, y0, z0)

    ext = make_external_step(ctx, cfg, jr.key(cfg.seed))
    p1 = ext(p, fs, 0.0, 0)
    p1 = jax.block_until_ready(p1)

    xa, ya, za = case.analytic(x0, y0, z0, 3600.0)
    np.testing.assert_allclose(np.asarray(p1.x), xa, atol=1e-6)
    np.testing.assert_allclose(np.asarray(p1.y), ya, atol=1e-6)
    np.testing.assert_allclose(np.asarray(p1.z), za, atol=1e-9)
    counts = summary_counts(p1)
    assert counts["active"] == n
    np.testing.assert_allclose(np.asarray(p1.age), 3600.0)


def test_release_by_dob():
    cfg = Config(numpar=3, dt=3600, idt=600, Behavior=0)
    case, ctx = _setup(cfg)
    fs = synth.fieldset_for(case, t_center=0.0, dt=3600.0)
    p = st.init_particles([50e3] * 3, [50e3] * 3, [-10.0] * 3,
                          dob=[0.0, 1800.0, 7200.0])
    ext = make_external_step(ctx, cfg, jr.key(0))
    p1 = ext(p, fs, 0.0, 0)
    s = np.asarray(p1.status)
    assert s[0] == st.ACTIVE and s[1] == st.ACTIVE
    assert s[2] == st.NOT_RELEASED
    # particle 2 has not moved nor aged
    assert float(p1.x[2]) == 50e3
    assert float(p1.age[2]) == 0.0
    # particle 1 released mid-step: age counts from dob
    np.testing.assert_allclose(float(p1.age[1]), 3600.0 - 1800.0)


def test_determinism_same_seed():
    cfg = Config(numpar=16, dt=3600, idt=600, HTurbOn=True,
                 ConstantHTurb=5.0, Behavior=0)
    case, ctx = _setup(cfg)
    fs = synth.fieldset_for(case, t_center=0.0, dt=3600.0)
    rng = np.random.default_rng(3)
    p = st.init_particles(rng.uniform(40e3, 60e3, 16),
                          rng.uniform(40e3, 60e3, 16),
                          rng.uniform(-40, -5, 16))
    ext = make_external_step(ctx, cfg, jr.key(cfg.seed))
    a = jax.block_until_ready(ext(p, fs, 0.0, 0))
    b = jax.block_until_ready(ext(p, fs, 0.0, 0))
    np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
    np.testing.assert_array_equal(np.asarray(a.z), np.asarray(b.z))


def test_open_boundary_removal_in_step():
    cfg = Config(numpar=2, dt=3600, idt=120, Behavior=0,
                 OpenOceanBoundary=True)
    # r ~ 69 km from the center: the circular trajectory exits the
    # 100 km domain through the north rim within a few internal steps
    # (idt kept small so each substep spans < 1 grid cell)
    case, ctx = _setup(cfg, omega=1e-4)
    fs = synth.fieldset_for(case, t_center=0.0, dt=3600.0)
    # one particle near the rim (will be swept out), one in the middle
    p = st.init_particles([99e3, 52e3], [99e3, 50e3], [-10.0, -10.0])
    ext = make_external_step(ctx, cfg, jr.key(0))
    p1 = ext(p, fs, 0.0, 0)
    s = np.asarray(p1.status)
    assert s[0] == st.OUT_OF_DOMAIN
    assert s[1] == st.ACTIVE
    # the exited particle froze at the boundary crossing
    assert float(p1.x[0]) <= float(ctx.bounds.x_edges[-1]) + 1e-6


def test_step_clean_under_debug_nans():
    """SURVEY.md SS5.2 race/sanitizer analog: the full physics step
    (advection + both turbulences + behavior + reflection) must produce
    no NaNs anywhere under jax_debug_nans — the same check the driver
    enables via LTJAX_DEBUG_NANS=1 (ltjax.run._apply_debug_flags)."""
    cfg = Config(numpar=64, dt=3600, idt=600, us=10, ws=11,
                 HTurbOn=True, ConstantHTurb=1.0,
                 VTurbOn=True, ConstantVTurb=1e-4,
                 Behavior=6, sink=5e-4, mortality=True, deadage=1e9,
                 OpenOceanBoundary=True)
    case, ctx = _setup(cfg, shear_a=0.002)
    fs = synth.fieldset_for(case, t_center=0.0, dt=3600.0)
    rng = np.random.default_rng(7)
    p = st.init_particles(rng.uniform(30e3, 70e3, 64),
                          rng.uniform(30e3, 70e3, 64),
                          rng.uniform(-45.0, -2.0, 64))
    jax.config.update("jax_debug_nans", True)
    try:
        ext = make_external_step(ctx, cfg, jr.key(1))
        p1 = jax.block_until_ready(ext(p, fs, 0.0, 0))
    finally:
        jax.config.update("jax_debug_nans", False)
    assert np.isfinite(np.asarray(p1.x)).all()
    assert np.isfinite(np.asarray(p1.z)).all()


@pytest.mark.parametrize("kw,path", [
    (dict(), "fast"),
    (dict(fast_interp=False), "native"),
    (dict(tension_sigma=-1.0), "native"),
    (dict(tension_sigma=4.0, dtype_pos="float32"), "fast"),
])
def test_mode_flags_decides_from_the_config_alone(monkeypatch, kw, path):
    """The compute path never depends on the backend JAX runs on."""
    def no_backend(*a, **k):
        raise AssertionError("mode_flags consulted the backend")

    monkeypatch.setattr(jax, "default_backend", no_backend)
    monkeypatch.setattr(jax, "devices", no_backend)
    from ltjax.step import mode_flags
    assert mode_flags(Config(**kw)) == path


def test_package_imports_no_pallas():
    """Nothing in the package imports a Pallas kernel module."""
    import ast
    import pathlib

    import ltjax

    bad = []
    for f in pathlib.Path(ltjax.__file__).parent.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [f"{node.module}.{a.name}"
                                         for a in node.names]
            bad += [f"{f.name}: {n}" for n in names
                    if "pallas" in n]
    assert not bad, bad


def test_run_logs_path_and_device_first(tmp_path, capsys):
    """The CLI's first JSON line names the compute path and the device."""
    import json

    import chip_smoke
    from ltjax import run as ltrun

    _, nml, _, _, _ = chip_smoke.write_case(str(tmp_path), 16, 16, 4, 64, 1)
    assert ltrun.main([nml]) == 0
    first = json.loads(capsys.readouterr().out.splitlines()[0])
    assert first["event"] == "start" and first["path"] == "fast"
    assert first["device"] == {"platform": "cpu", "kind": "cpu",
                               "count": len(jax.devices())}

"""The fast XLA path against the native reference, configuration by
configuration.

``make_external_step`` with ``fast_interp=True`` (packed-table
interpolation, ltjax.packed) must reproduce the reference-ordered
native path (``fast_interp=False``, ltjax.physics.advect) for every
operator the step runs: on the solid-body case the two schemes agree to
float64 round-off (tests/test_packed.py), so statuses must match
exactly and positions to the same tolerance, whatever rides on top of
advection — behaviors 1-7, salinity sampling, settlement, turbulence,
mortality, frozen particles.  On a curvilinear mesh the fast path's
rho-collocated u/v sample a few metres from the native staggered
points, so positions there agree to that discretization budget.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import jax.random as jr
import pytest

from ltjax import state as st
from ltjax import synth
from ltjax.config import Config
from ltjax.physics import boundary as bd
from ltjax.physics import settlement as stl
from ltjax.step import StepContext, make_external_step

US = 8
T_DVM = 9.0 * 3600.0          # mid-morning: the DVM light branch engages

CASES = {
    "behavior1": dict(Behavior=1, swimslow=1e-3, swimfast=3e-3,
                      pediage=5e6),
    "behavior2": dict(Behavior=2, swimslow=1e-3, swimfast=3e-3,
                      pediage=5e6),
    "behavior3_dvm": dict(Behavior=3, swimslow=1e-3, swimfast=3e-3,
                          pediage=5e6),
    "behavior4_salt": dict(Behavior=4, readSalt=True, SaltTempOn=True,
                           swimslow=1e-3, swimfast=4e-3, pediage=900.0,
                           Sgradient=0.03),
    "behavior5_salt": dict(Behavior=5, readSalt=True, SaltTempOn=True,
                           swimslow=1e-3, swimfast=4e-3, pediage=900.0,
                           Sgradient=0.03),
    "tst": dict(Behavior=7, swimslow=1e-3, swimfast=4e-3, pediage=5e6,
                Hswimspeed=0.05, Swimdepth=3.0),
    "settlement": dict(settlementon=True, pediage=0.0),
    "turbulence": dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True,
                       readAks=True),
    "sink_mortality": dict(Behavior=6, sink=1e-3, mortality=True,
                           deadage=900.0),
    "stochastic_mortality": dict(mortality=True, stochastic_mortality=True,
                                 deadage=3600.0),
}


def _rect(kw, t0=0.0, n=256):
    c = synth.make_solid_body_case(nx=41, ny=41, us=US, lx=100e3,
                                   ly=100e3, h0=50.0, omega=1e-4)
    grid = c.grid
    bounds = bd.build_boundaries(np.asarray(grid.mask_rho),
                                 np.asarray(grid.x_rho),
                                 np.asarray(grid.y_rho))
    polys = holes = None
    if kw.get("settlementon"):
        # a 10x10 km habitat with a hole, in the particles' path
        sq = lambda a, b: np.asarray([[a, a], [b, a], [b, b], [a, b]])
        polys = stl.build_polygons([(101, sq(45e3, 55e3))],
                                   np.asarray(bounds.x_edges),
                                   np.asarray(bounds.y_edges))
        holes = stl.build_polygons([(1, sq(49e3, 51e3))],
                                   np.asarray(bounds.x_edges),
                                   np.asarray(bounds.y_edges))
    ctx = StepContext(grid=grid, bounds=bounds, polys=polys, holes=holes)
    fs = synth.fieldset_for(c, t_center=t0 + 900.0, dt=1800.0)
    if kw.get("readAks"):
        z_w = 50.0 * np.asarray(grid.s_w)
        K = 1e-4 + 4e-3 * (1.0 - (2.0 * z_w / 50.0 + 1.0) ** 2)
        fs = fs._replace(aks=jnp.broadcast_to(
            jnp.asarray(K)[None, None, None, :], fs.aks.shape))
    if kw.get("readSalt"):
        # linear in z: every vertical scheme reproduces it exactly
        z_r = 50.0 * np.asarray(grid.s_rho)
        fs = fs._replace(
            salt=jnp.broadcast_to(jnp.asarray(30.0 + 0.05 * z_r)
                                  [None, None, None, :], fs.salt.shape),
            temp=jnp.broadcast_to(jnp.asarray(12.0 + 0.1 * z_r)
                                  [None, None, None, :], fs.temp.shape))
    rng = np.random.default_rng(11)
    p = st.init_particles(rng.uniform(36e3, 62e3, n),
                          rng.uniform(36e3, 62e3, n),
                          rng.uniform(-45.0, -2.0, n), dob=np.full(n, t0))
    cfg = Config(numpar=n, dt=1800, idt=450, us=US, ws=US + 1,
                 OpenOceanBoundary=True, reflect_iters=2,
                 TrackCollisions=True, **kw)
    return ctx, cfg, fs, p


def _both(ctx, cfg, fs, p, t0=0.0):
    def run(fast):
        c = dataclasses.replace(cfg, fast_interp=fast)
        return make_external_step(ctx, c, jr.key(3))(p, fs, t0, 0)
    return run(True), run(False)


def _assert_same(fast, nat, atol_xy=1e-6, atol_z=1e-9):
    np.testing.assert_array_equal(np.asarray(fast.status),
                                  np.asarray(nat.status))
    np.testing.assert_array_equal(np.asarray(fast.settle_poly),
                                  np.asarray(nat.settle_poly))
    np.testing.assert_allclose(np.asarray(fast.x), np.asarray(nat.x),
                               rtol=0, atol=atol_xy)
    np.testing.assert_allclose(np.asarray(fast.y), np.asarray(nat.y),
                               rtol=0, atol=atol_xy)
    np.testing.assert_allclose(np.asarray(fast.z), np.asarray(nat.z),
                               rtol=0, atol=atol_z)


@pytest.mark.parametrize("name", list(CASES))
def test_fast_path_matches_native(name):
    kw = CASES[name]
    t0 = T_DVM if kw.get("Behavior") == 3 else 0.0
    ctx, cfg, fs, p = _rect(kw, t0=t0)
    fast, nat = _both(ctx, cfg, fs, p, t0=t0)
    _assert_same(fast, nat)
    status = np.asarray(fast.status)
    moved_z = np.abs(np.asarray(fast.z) - np.asarray(p.z)).max()
    # each configuration's own operator must actually act
    if kw.get("Behavior", 0) in (1, 2, 3, 4, 5, 6, 7):
        assert moved_z > 0.01, moved_z
    if kw.get("settlementon"):
        assert (status == st.SETTLED).sum() > 5
        assert set(np.asarray(fast.settle_poly)[status == st.SETTLED]) == {
            101}
    if kw.get("mortality") and not kw.get("stochastic_mortality"):
        assert (status == st.DEAD).all()
    if kw.get("stochastic_mortality"):
        assert 0 < (status == st.DEAD).sum() < p.n
    if kw.get("SaltTempOn"):
        np.testing.assert_allclose(np.asarray(fast.salt),
                                   np.asarray(nat.salt), rtol=0, atol=1e-9)
        assert np.ptp(np.asarray(fast.salt)) > 1.0      # really sampled
    if kw.get("VTurbOn"):
        assert moved_z > 1e-3, moved_z


def test_frozen_particles_stay_put():
    """Settled, dead, exited and not-yet-released particles do not move
    on either path."""
    ctx, cfg, fs, p = _rect(dict(HTurbOn=True, ConstantHTurb=1.0,
                                 Behavior=1, swimslow=1e-3, swimfast=3e-3,
                                 pediage=5e6))
    codes = np.array([st.SETTLED, st.DEAD, st.OUT_OF_DOMAIN, st.ACTIVE])
    status = codes[np.arange(p.n) % 4]
    dob = np.where(np.arange(p.n) % 8 == 3, 1e9, 0.0)     # never released
    status = np.where(dob > 0, st.NOT_RELEASED, status)
    p = p._replace(status=jnp.asarray(status, jnp.int32),
                   dob=jnp.asarray(dob))
    fast, nat = _both(ctx, cfg, fs, p)
    _assert_same(fast, nat)
    frozen = status != st.ACTIVE
    for f in ("x", "y", "z"):
        np.testing.assert_array_equal(np.asarray(getattr(fast, f))[frozen],
                                      np.asarray(getattr(p, f))[frozen])
    np.testing.assert_array_equal(np.asarray(fast.status)[frozen],
                                  status[frozen])
    assert np.abs(np.asarray(fast.x) - np.asarray(p.x))[~frozen].min() > 1.0


@pytest.mark.parametrize("behavior", [1, 3])
def test_fast_path_matches_native_curvilinear(behavior):
    """Swimming behaviors on a curvilinear mesh: statuses exact; the
    horizontal difference is the collocation budget of
    tests/test_curv.py::test_packed_matches_native_curvilinear (1 m per
    internal step), vertical swims are identical draws."""
    case = synth.make_curv_case(nx=41, ny=41, us=US, lx=100e3, ly=100e3,
                                h0=50.0, omega=1e-4, amp=0.02)
    g = case.grid
    bounds = bd.build_boundaries_curv(np.asarray(g.mask_rho), case.x2d,
                                      case.y2d, g.curv)
    ctx = StepContext(grid=g, bounds=bounds, polys=None, holes=None)
    t0 = T_DVM if behavior == 3 else 0.0
    fs = synth.fieldset_for(case, t_center=t0 + 900.0, dt=1800.0)
    cfg = Config(numpar=256, dt=1800, idt=450, us=US, ws=US + 1,
                 OpenOceanBoundary=True, reflect_iters=2,
                 Behavior=behavior, swimslow=1e-3, swimfast=3e-3,
                 pediage=5e6, mortality=True, deadage=5e6)
    rng = np.random.default_rng(7)
    n = cfg.numpar
    p = st.init_particles(rng.uniform(30e3, 70e3, n),
                          rng.uniform(30e3, 70e3, n),
                          rng.uniform(-40.0, -5.0, n), dob=np.full(n, t0))
    fast, nat = _both(ctx, cfg, fs, p, t0=t0)
    np.testing.assert_array_equal(np.asarray(fast.status),
                                  np.asarray(nat.status))
    assert (np.asarray(fast.status) == st.ACTIVE).all()
    budget = 1.0 * cfg.internal_steps
    np.testing.assert_allclose(np.asarray(fast.x), np.asarray(nat.x),
                               rtol=0, atol=budget)
    np.testing.assert_allclose(np.asarray(fast.y), np.asarray(nat.y),
                               rtol=0, atol=budget)
    np.testing.assert_allclose(np.asarray(fast.z), np.asarray(nat.z),
                               rtol=0, atol=1e-6)
    assert np.abs(np.asarray(fast.z) - np.asarray(p.z)).max() > 0.01

"""Multi-chip sharding tests on the 8-virtual-CPU-device mesh
(SURVEY.md SS4: 1-device == N-device is the strongest cluster-free
distributed test).
"""

import numpy as np
import jax.numpy as jnp
import jax.random as jr
import pytest

from ltjax import shard, synth
from ltjax import state as st
from ltjax.config import Config
from ltjax.step import StepContext, make_external_step
from ltjax.physics import boundary as bd


def _setup(hturb=False):
    cfg = Config(numpar=96, dt=3600, idt=300, us=10, ws=11,
                 HTurbOn=hturb, ConstantHTurb=5.0,
                 OpenOceanBoundary=True, TrackCollisions=True,
                 dtype_pos="float64")
    case = synth.make_solid_body_case(nx=33, ny=41, us=10, lx=80e3,
                                      ly=100e3, h0=50.0, omega=1.2e-4)
    grid = case.grid
    bounds = bd.build_boundaries(np.asarray(grid.mask_rho),
                                 np.asarray(grid.x_rho),
                                 np.asarray(grid.y_rho))
    ctx = StepContext(grid=grid, bounds=bounds, polys=None, holes=None)
    fs = synth.fieldset_for(case, t_center=1800.0, dt=3600.0,
                            dtype=jnp.float64)

    rng = np.random.default_rng(3)
    n = cfg.numpar
    x = rng.uniform(15e3, 65e3, n)
    y = rng.uniform(15e3, 85e3, n)
    z = rng.uniform(-40.0, -5.0, n)
    p0 = st.init_particles(x, y, z)
    return cfg, case, ctx, fs, p0


def _sorted_by_pid(p: st.Particles):
    order = np.argsort(np.asarray(p.pid))
    return {f: np.asarray(getattr(p, f))[order] for f in p._fields}


@pytest.mark.parametrize("ndp,ntiles", [(1, 4), (2, 4), (8, 1)])
def test_tiled_matches_unsharded(ndp, ntiles):
    cfg, case, ctx, fs, p0 = _setup(hturb=True)
    key = jr.key(7)

    # --- unsharded reference ------------------------------------------
    ref_step = make_external_step(ctx, cfg, key)
    p_ref = p0
    for ext in range(3):
        p_ref = ref_step(p_ref, fs, float(ext * cfg.dt), ext)
    ref = _sorted_by_pid(p_ref)

    # --- tiled --------------------------------------------------------
    # halo must cover max displacement per external step: v_max*dt/dy
    # = 1.2e-4*50e3*3600/2500 ~ 9 rows, +1 stencil
    spec = shard.make_spec(cfg, ctx.grid.ny, cfg.numpar, ndp, ntiles,
                           halo=10, slack=3.0)
    mesh = shard.make_mesh(spec)
    tiled = shard.build_tiled_static(ctx.grid, spec)
    fs_pad = shard.pad_fieldset_eta(fs, spec.ny_pad)
    step = shard.make_tiled_step(ctx, cfg, spec, tiled, mesh, key)
    pbuf = shard.scatter_particles(p0, spec, tiled.tile_edges)
    total_drop = 0
    for ext in range(3):
        pbuf, drop = step(pbuf, fs_pad, float(ext * cfg.dt), ext)
        total_drop += int(jnp.sum(drop))
    assert total_drop == 0
    got = _sorted_by_pid(shard.gather_particles(pbuf))

    assert got["pid"].shape == ref["pid"].shape
    np.testing.assert_array_equal(got["pid"], ref["pid"])
    np.testing.assert_array_equal(got["status"], ref["status"])
    np.testing.assert_array_equal(got["hit_land"], ref["hit_land"])
    # positions: identical operations on identical inputs => tight
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["y"], ref["y"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["z"], ref["z"], rtol=0, atol=1e-9)


def test_migration_moves_particles_between_tiles():
    cfg, case, ctx, fs, p0 = _setup()
    spec = shard.make_spec(cfg, ctx.grid.ny, cfg.numpar, 1, 4,
                           halo=6, slack=3.0)
    mesh = shard.make_mesh(spec)
    tiled = shard.build_tiled_static(ctx.grid, spec)
    fs_pad = shard.pad_fieldset_eta(fs, spec.ny_pad)
    step = shard.make_tiled_step(ctx, cfg, spec, tiled, mesh, key := jr.key(0))
    pbuf = shard.scatter_particles(p0, spec, tiled.tile_edges)

    def occupancy(pb):
        s = np.asarray(pb.status)
        return (s != shard.EMPTY).sum(axis=(0, 2))

    occ0 = occupancy(pbuf)
    for ext in range(6):
        pbuf, drop = step(pbuf, fs_pad, float(ext * cfg.dt), ext)
        assert int(jnp.sum(drop)) == 0
        # invariant: every resident particle lies in its owning strip
        edges = np.asarray(tiled.tile_edges)
        y = np.asarray(pbuf.y)
        s = np.asarray(pbuf.status)
        for t in range(spec.ntiles):
            resident = s[:, t, :] != shard.EMPTY
            yt = y[:, t, :][resident]
            assert np.all((yt >= edges[t]) & (yt < edges[t + 1]))
    occ5 = occupancy(pbuf)
    # solid-body rotation over 6 h moves particles across strips
    assert np.any(occ0 != occ5)
    assert occ5.sum() == cfg.numpar


def test_scatter_gather_roundtrip():
    cfg, case, ctx, fs, p0 = _setup()
    spec = shard.make_spec(cfg, ctx.grid.ny, cfg.numpar, 2, 4, slack=2.0)
    tiled = shard.build_tiled_static(ctx.grid, spec)
    pbuf = shard.scatter_particles(p0, spec, tiled.tile_edges)
    back = shard.gather_particles(pbuf)
    ref = _sorted_by_pid(p0)
    got = _sorted_by_pid(back)
    for f in ("x", "y", "z", "pid", "status"):
        np.testing.assert_array_equal(got[f], ref[f])


def test_sharded_driver_matches_single_device(tmp_path):
    """The PRODUCTION driver (run.run) with mesh_tiles=4 x
    mesh_particles=2 must reproduce the single-device driver run on the
    same namelist-equivalent config (VERDICT r2 missing #2: the CLI
    must be multi-chip, and sharding must not change trajectories)."""
    from ltjax import convert
    from ltjax.run import run as run_driver

    case = synth.make_solid_body_case(nx=17, ny=32, us=6, lx=100e3,
                                      ly=100e3, h0=50.0, omega=1e-4,
                                      dtype=jnp.float64)
    synth.write_roms_files(case, f"{tmp_path}/roms", n_records=5,
                           dt=1800.0, records_per_file=5,
                           geographic=True, lonmin=-76.0, latmin=37.0)
    rng = np.random.default_rng(0)
    numpar = 64
    x0 = rng.uniform(20e3, 80e3, numpar)
    y0 = rng.uniform(20e3, 80e3, numpar)
    z0 = rng.uniform(-40.0, -5.0, numpar)
    lat = np.asarray(convert.y2lat(y0, 37.0, 6378e3, True))
    lon = np.asarray(convert.x2lon(x0, y0, -76.0, 37.0, 6378e3, True))
    with open(f"{tmp_path}/parfile.csv", "w") as f:
        for k in range(numpar):
            f.write(f"{lon[k]},{lat[k]},{z0[k]},0.0\n")

    def make_cfg(ndp, ntiles, out):
        return Config(
            numpar=numpar, days=3 * 1800.0 / 86400.0, dt=1800, idt=450,
            us=6, ws=7, iprint=1800, hc=50.0, Vtransform=1,
            HTurbOn=True, ConstantHTurb=1.0, OpenOceanBoundary=True,
            SphericalProjection=True, latmin=37.0, lonmin=-76.0,
            NCgridfile=f"{tmp_path}/roms/grid.nc",
            dirin=f"{tmp_path}/roms/", prefix="ocean_his_", suffix=".nc",
            numdigits=4, parfile=f"{tmp_path}/parfile.csv",
            outpath=f"{tmp_path}/{out}", writeNC=False, writeCSV=False,
            dtype_pos="float64", dtype_field="float64",
            mesh_particles=ndp, mesh_tiles=ntiles,
            migrate_capacity=3.0, halo_rows=3, ErrorFlag=1,
            prefetch=False)

    p1 = run_driver(make_cfg(1, 1, "out1"))
    p8 = run_driver(make_cfg(2, 4, "out8"))

    # gather_particles returns pid order; single-device returns storage
    # order == pid order
    np.testing.assert_array_equal(np.asarray(p8.pid), np.asarray(p1.pid))
    np.testing.assert_allclose(np.asarray(p8.x), np.asarray(p1.x),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(p8.y), np.asarray(p1.y),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(p8.z), np.asarray(p1.z),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(np.asarray(p8.status),
                                  np.asarray(p1.status))


TILED_CASES = {
    "behavior1": dict(Behavior=1, swimslow=1e-3, swimfast=3e-3,
                      pediage=5e6),
    "behavior2": dict(Behavior=2, swimslow=1e-3, swimfast=3e-3,
                      pediage=5e6),
    "behavior3_dvm": dict(Behavior=3, swimslow=1e-3, swimfast=3e-3,
                          pediage=5e6),
    "behavior4_salt": dict(Behavior=4, readSalt=True, SaltTempOn=True,
                           swimslow=1e-3, swimfast=4e-3, pediage=900.0,
                           Sgradient=0.03),
    "tst": dict(Behavior=7, swimslow=1e-3, swimfast=4e-3, pediage=5e6,
                Hswimspeed=0.05, Swimdepth=3.0),
    "settlement": dict(settlementon=True, pediage=0.0),
    "turbulence": dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True,
                       readAks=True),
    "sink_mortality": dict(Behavior=6, sink=1e-3, mortality=True,
                           deadage=2700.0),
}


@pytest.mark.parametrize("name", list(TILED_CASES))
def test_tiled_matches_unsharded_configs(name):
    """Every operator that rides on advection runs inside the tiled
    shard_map (halo-extended fields, tile-local grids, migration) on a
    2x4 mesh of the 8 virtual devices and reproduces the unsharded
    step: statuses and polygon ids exactly, positions to f64 rounding."""
    from ltjax.physics import settlement as stl

    kw = TILED_CASES[name]
    t0 = 9.0 * 3600.0 if kw.get("Behavior") == 3 else 0.0
    cfg = Config(numpar=96, dt=1800, idt=450, us=10, ws=11,
                 OpenOceanBoundary=True, TrackCollisions=True,
                 reflect_iters=2, dtype_pos="float64", **kw)
    case = synth.make_solid_body_case(nx=33, ny=41, us=10, lx=80e3,
                                      ly=100e3, h0=50.0, omega=1.2e-4)
    grid = case.grid
    bounds = bd.build_boundaries(np.asarray(grid.mask_rho),
                                 np.asarray(grid.x_rho),
                                 np.asarray(grid.y_rho))
    polys = holes = None
    if cfg.settlementon:
        sq = lambda a, b, c, d: np.asarray([[a, c], [b, c], [b, d],
                                            [a, d]])
        polys = stl.build_polygons([(101, sq(30e3, 50e3, 40e3, 60e3))],
                                   np.asarray(bounds.x_edges),
                                   np.asarray(bounds.y_edges))
        holes = stl.build_polygons([(1, sq(38e3, 42e3, 48e3, 52e3))],
                                   np.asarray(bounds.x_edges),
                                   np.asarray(bounds.y_edges))
    ctx = StepContext(grid=grid, bounds=bounds, polys=polys, holes=holes)
    fs = synth.fieldset_for(case, t_center=t0 + 900.0, dt=1800.0,
                            dtype=jnp.float64)
    if cfg.readAks:
        z_w = 50.0 * np.asarray(grid.s_w)
        K = 1e-4 + 4e-3 * (1.0 - (2.0 * z_w / 50.0 + 1.0) ** 2)
        fs = fs._replace(aks=jnp.broadcast_to(
            jnp.asarray(K)[None, None, None, :], fs.aks.shape))
    if cfg.readSalt:
        z_r = 50.0 * np.asarray(grid.s_rho)
        fs = fs._replace(salt=jnp.broadcast_to(
            jnp.asarray(30.0 + 0.05 * z_r)[None, None, None, :],
            fs.salt.shape))
    rng = np.random.default_rng(5)
    n = cfg.numpar
    p0 = st.init_particles(rng.uniform(15e3, 65e3, n),
                           rng.uniform(15e3, 85e3, n),
                           rng.uniform(-45.0, -2.0, n), dob=np.full(n, t0))
    key = jr.key(7)
    ref = _sorted_by_pid(make_external_step(ctx, cfg, key)(p0, fs, t0, 0))

    # one external step moves a particle <= omega*r*dt ~ 7 rows here
    spec = shard.make_spec(cfg, grid.ny, n, 2, 4, halo=8, slack=3.0)
    mesh = shard.make_mesh(spec)
    tiled = shard.build_tiled_static(grid, spec)
    step = shard.make_tiled_step(ctx, cfg, spec, tiled, mesh, key)
    pbuf = shard.scatter_particles(p0, spec, tiled.tile_edges)
    pbuf, drop = step(pbuf, shard.pad_fieldset_eta(fs, spec.ny_pad), t0, 0)
    assert int(jnp.sum(drop)) == 0
    got = _sorted_by_pid(shard.gather_particles(pbuf))

    for f in ("pid", "status", "settle_poly", "hit_land", "hit_bottom"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    for f in ("x", "y", "z", "salt"):
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=1e-8,
                                   err_msg=f)
    # the configuration's own operator acted
    if cfg.settlementon:
        assert (got["status"] == st.SETTLED).sum() > 3
    else:
        assert np.abs(got["z"] - np.asarray(p0.z)).max() > 1e-3

"""Curvilinear-grid support: inverse-map locate, native/packed parity,
trajectories vs analytic truth, boundaries, and IO round-trip.

Reference analog: general curvilinear Arakawa-C grids handled by
``initGrid``/``setEle``/``gridcell()`` (hydrodynamic_module.f90 /
gridcell_module.f90, SURVEY.md SS2.1 #3/#4 [conf: H]) — the bundled
estuary case runs on one.  The replacement here is a precomputed
seed raster + Newton inverse of the per-cell bilinear map
(ltjax.grid.logical_coords, SURVEY.md SS7.1).
"""

import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
import pytest

from ltjax import state as st
from ltjax import synth
from ltjax.config import Config
from ltjax.grid import locate_rho_ij, logical_coords
from ltjax.physics import boundary as bd
from ltjax.step import StepContext, make_external_step, mode_flags


@pytest.fixture(scope="module")
def curv_case():
    return synth.make_curv_case(nx=41, ny=41, us=8, lx=100e3, ly=100e3,
                                h0=50.0, omega=1e-4, amp=0.02)


def test_logical_coords_inverts_forward_map(curv_case):
    """logical_coords must invert the per-cell bilinear map: pick random
    logical coords, push them through the forward map, recover them."""
    g = curv_case.grid
    rng = np.random.default_rng(0)
    n = 500
    ti0 = rng.uniform(0.2, g.nx - 1.2, n)
    tj0 = rng.uniform(0.2, g.ny - 1.2, n)
    x2, y2 = curv_case.x2d, curv_case.y2d
    i = np.floor(ti0).astype(int)
    j = np.floor(tj0).astype(int)
    fx = ti0 - i
    fy = tj0 - j

    def bil(a):
        return (a[j, i] * (1 - fx) * (1 - fy) + a[j, i + 1] * fx * (1 - fy)
                + a[j + 1, i] * (1 - fx) * fy + a[j + 1, i + 1] * fx * fy)
    x = bil(x2)
    y = bil(y2)
    ti, tj = logical_coords(g, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(np.asarray(ti), ti0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(tj), tj0, atol=1e-6)


def test_packed_matches_native_curvilinear(curv_case):
    """One internal step: the packed gather path must agree with the
    native path on a curvilinear grid (same inverse locate feeding both
    interpolation schemes; advection-only so schemes coincide on
    linear-in-z data)."""
    from ltjax.step import internal_step
    from ltjax import packed as pk

    g = curv_case.grid
    bounds = bd.build_boundaries_curv(np.asarray(g.mask_rho),
                                      curv_case.x2d, curv_case.y2d,
                                      g.curv)
    ctx = StepContext(grid=g, bounds=bounds, polys=None, holes=None)
    cfg = Config(numpar=200, dt=3600, idt=450, us=8, ws=9,
                 OpenOceanBoundary=True)
    fs = synth.fieldset_for(curv_case, t_center=1800.0, dt=3600.0)
    rng = np.random.default_rng(1)
    n = 200
    p = st.init_particles(rng.uniform(30e3, 70e3, n),
                          rng.uniform(30e3, 70e3, n),
                          rng.uniform(-40.0, -5.0, n))
    p = p._replace(status=jnp.full(n, st.ACTIVE, jnp.int32))
    key = jr.key(0)

    p_nat = internal_step(ctx, cfg, key, p, fs, 100.0, 0, None)
    prec = pk.build_packed_records(g, fs)
    p_fast = internal_step(ctx, cfg, key, p, fs, 100.0, 0, prec)
    # On a curved mesh the packed path's u/v collocation to rho points
    # (documented scheme choice, ltjax.packed item 3) and the native
    # staggered-mesh bilinear sample effective positions O(h^2 *
    # curvature) apart (~2 m here) -> ~0.5 m/step divergence budget;
    # on rectilinear grids the same comparison is exact to f64 eps
    # (tests/test_packed.py).
    np.testing.assert_allclose(np.asarray(p_fast.x), np.asarray(p_nat.x),
                               rtol=0, atol=1.0)
    np.testing.assert_allclose(np.asarray(p_fast.y), np.asarray(p_nat.y),
                               rtol=0, atol=1.0)
    np.testing.assert_allclose(np.asarray(p_fast.z), np.asarray(p_nat.z),
                               rtol=0, atol=1e-6)


def test_trajectories_match_analytic_curvilinear(curv_case):
    """Full external steps on the curvilinear mesh vs analytic circles.

    Tolerance budget: the staggered u/v meshes differ from the rho mesh
    by O(curvature * h^2), displacing the effective sampling point a few
    metres — NOT an engine error (the rho-mesh interpolation is exact
    for this linear field; see CurvSolidBodyCase docstring)."""
    g = curv_case.grid
    bounds = bd.build_boundaries_curv(np.asarray(g.mask_rho),
                                      curv_case.x2d, curv_case.y2d,
                                      g.curv)
    ctx = StepContext(grid=g, bounds=bounds, polys=None, holes=None)
    cfg = Config(numpar=100, dt=3600, idt=300, us=8, ws=9,
                 OpenOceanBoundary=True)
    assert mode_flags(cfg) == "fast"       # packed path engages
    rng = np.random.default_rng(2)
    n = 100
    x0 = rng.uniform(35e3, 65e3, n)
    y0 = rng.uniform(35e3, 65e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    p = st.init_particles(x0, y0, z0)
    p = p._replace(status=jnp.full(n, st.ACTIVE, jnp.int32))
    step = make_external_step(ctx, cfg, jr.key(0))
    n_ext = 4
    for e in range(n_ext):
        fs = synth.fieldset_for(curv_case, t_center=(e + 0.5) * 3600.0,
                                dt=3600.0)
        p = step(p, fs, float(e * 3600.0), e)
    xt, yt, zt = curv_case.analytic(x0, y0, z0, n_ext * 3600.0)
    err = np.hypot(np.asarray(p.x) - xt, np.asarray(p.y) - yt)
    assert (np.asarray(p.status) == st.ACTIVE).all()
    # budget: u/v sampled through staggered meshes offset O(h^2 *
    # curvature) (~2.3 m) from the rho-mesh inverse -> velocity error
    # ~omega * offset ~ 2.3e-4 m/s -> O(10 m) over 4 h of rotation
    assert err.max() < 20.0, err.max()      # metres after 4 h
    np.testing.assert_allclose(np.asarray(p.z), zt, atol=1e-3)


def test_boundary_reflect_curvilinear():
    """Island reflection on a curvilinear mesh: particles pushed through
    a masked island's quad edges reflect and end in water."""
    ny = nx = 31
    mask = np.ones((ny, nx), np.int32)
    mask[14:17, 14:17] = 0                 # 3x3 island
    case = synth.make_curv_case(nx=nx, ny=ny, us=4, lx=60e3, ly=60e3,
                                h0=30.0, omega=1e-4, amp=0.03, mask=mask)
    g = case.grid
    bounds = bd.build_boundaries_curv(np.asarray(g.mask_rho),
                                      case.x2d, case.y2d, g.curv)
    # aim straight at the island from just west of it
    n = 32
    # physical position of logical (12.5, 15.0): west of the island
    ti = np.full(n, 12.6)
    tj = np.linspace(14.6, 16.4, n)
    i = np.floor(ti).astype(int)
    j = np.floor(tj).astype(int)
    fx = ti - i
    fy = tj - j

    def bil(a):
        return (a[j, i] * (1 - fx) * (1 - fy) + a[j, i + 1] * fx * (1 - fy)
                + a[j + 1, i] * (1 - fx) * fy + a[j + 1, i + 1] * fx * fy)
    x0 = jnp.asarray(bil(case.x2d))
    y0 = jnp.asarray(bil(case.y2d))
    assert bool(bd.in_water(bounds, x0, y0).all())
    # displacement of ~2.3 logical cells east: into the island
    ti1 = ti + 2.3
    i1 = np.floor(ti1).astype(int)
    fx1 = ti1 - i1
    x1 = jnp.asarray((case.x2d[j, i1] * (1 - fx1) * (1 - fy)
                      + case.x2d[j, i1 + 1] * fx1 * (1 - fy)
                      + case.x2d[j + 1, i1] * (1 - fx1) * fy
                      + case.x2d[j + 1, i1 + 1] * fx1 * fy))
    y1 = y0
    xr, yr, hits, exited, stuck = bd.reflect(bounds, x0, y0, x1, y1,
                                             open_exits=True, n_iter=4)
    # max-displacement guard: 2.3 cells exceeds the 1.5-cell bucket
    # radius -> every particle is flagged (loud, never silent)
    assert bool(stuck.all())
    # a sub-radius push into the island must reflect back into water
    ti1b = ti + 1.2
    i1b = np.floor(ti1b).astype(int)
    fx1b = ti1b - i1b
    x1b = jnp.asarray((case.x2d[j, i1b] * (1 - fx1b) * (1 - fy)
                       + case.x2d[j, i1b + 1] * fx1b * (1 - fy)
                       + case.x2d[j + 1, i1b] * (1 - fx1b) * fy
                       + case.x2d[j + 1, i1b + 1] * fx1b * fy))
    xr, yr, hits, exited, stuck = bd.reflect(bounds, x0, y0, x1b, y1,
                                             open_exits=True, n_iter=4)
    assert not bool(stuck.any())
    assert not bool(exited.any())
    assert int(hits.sum()) > 0
    assert bool(bd.in_water(bounds, xr, yr).all())


def test_curvilinear_io_roundtrip(tmp_path):
    """write_roms_files(geographic curvilinear) -> read_grid ->
    grid_from_roms must rebuild a curvilinear Grid whose inverse map
    recovers the node positions."""
    from ltjax.io.roms import grid_from_roms, is_rectilinear, read_grid

    case = synth.make_curv_case(nx=21, ny=17, us=4, lx=40e3, ly=30e3,
                                h0=20.0, omega=1e-4, amp=0.03)
    cfg = Config(us=4, ws=5, lonmin=-76.0, latmin=37.0)
    gp, hp = synth.write_roms_files(case, str(tmp_path), n_records=3,
                                    dt=3600.0, geographic=True,
                                    lonmin=-76.0, latmin=37.0)
    gd = read_grid(gp, cfg, hist_path=hp[0])
    assert not is_rectilinear(gd)
    g = grid_from_roms(gd, cfg, jnp.float64)
    assert g.curv is not None
    # node positions must invert to integer logical coords
    xy = np.asarray(g.curv.xy_flat).reshape(g.ny, g.nx, 2)
    jj, ii = 9, 13
    ti, tj = logical_coords(g, jnp.asarray([xy[jj, ii, 0]]),
                            jnp.asarray([xy[jj, ii, 1]]))
    assert abs(float(ti[0]) - ii) < 1e-4
    assert abs(float(tj[0]) - jj) < 1e-4
    # the projected mesh must be close to the original meters mesh
    # (lon/lat round-trip through the per-point projection)
    np.testing.assert_allclose(xy[..., 0], case.x2d, atol=2.0)
    np.testing.assert_allclose(xy[..., 1], case.y2d, atol=2.0)


def test_max_displacement_guard_rectilinear():
    """A >1.5-cell single-step displacement flags stuck (ERROR) even
    with midpoint and endpoint in water (VERDICT r3 weak #2)."""
    ny = nx = 21
    mask = np.ones((ny, nx), np.int32)
    x = np.linspace(0.0, 20e3, nx)
    y = np.linspace(0.0, 20e3, ny)
    bounds = bd.build_boundaries(mask, x, y)
    x0 = jnp.asarray([5e3])
    y0 = jnp.asarray([5e3])
    x1 = jnp.asarray([5e3 + 2.2 * 1e3])    # 2.2 cells
    y1 = jnp.asarray([5e3])
    _, _, _, _, stuck = bd.reflect(bounds, x0, y0, x1, y1,
                                   open_exits=True)
    assert bool(stuck[0])
    x1 = jnp.asarray([5e3 + 1.2 * 1e3])    # 1.2 cells: fine
    _, _, _, _, stuck = bd.reflect(bounds, x0, y0, x1, y1,
                                   open_exits=True)
    assert not bool(stuck[0])


def test_curvilinear_cli_driver_end_to_end(tmp_path):
    """The production driver (run.run) on a curvilinear geographic ROMS
    series: grid_from_roms -> curvilinear boundaries -> packed-path
    stepping -> NetCDF output, trajectories vs analytic truth."""
    from ltjax import convert
    from ltjax.io.nc import NCFile
    from ltjax.run import run

    case = synth.make_curv_case(nx=33, ny=29, us=5, lx=64e3, ly=56e3,
                                h0=40.0, omega=1e-4, amp=0.02)
    synth.write_roms_files(case, str(tmp_path / "roms"), n_records=5,
                           dt=1800.0, geographic=True, lonmin=-76.0,
                           latmin=37.0)
    rng = np.random.default_rng(4)
    n = 64
    x0 = rng.uniform(20e3, 44e3, n)
    y0 = rng.uniform(16e3, 40e3, n)
    z0 = rng.uniform(-30.0, -5.0, n)
    lat = np.asarray(convert.y2lat(y0, 37.0))
    lon = np.asarray(convert.x2lon(x0, y0, -76.0, 37.0))
    with open(tmp_path / "parfile.csv", "w") as f:
        for k in range(n):
            f.write(f"{lon[k]},{lat[k]},{-z0[k]},0.0\n")

    cfg = Config(
        numpar=n, days=2 * 1800.0 / 86400.0, dt=1800, idt=450, us=5,
        ws=6, iprint=1800, hc=40.0, Vtransform=1,
        OpenOceanBoundary=True, SphericalProjection=True,
        latmin=37.0, lonmin=-76.0,
        NCgridfile=str(tmp_path / "roms" / "grid.nc"),
        dirin=str(tmp_path / "roms") + "/", prefix="ocean_his_",
        suffix=".nc", numdigits=4,
        parfile=str(tmp_path / "parfile.csv"),
        outpath=str(tmp_path / "out"), NCOutFile="curv", writeNC=True,
        ErrorFlag=0)
    out = run(cfg)
    assert (np.asarray(out.status) == st.ACTIVE).all()

    nc = NCFile(str(tmp_path / "out" / "curv.nc"))
    lon_t = nc.read("lon")
    lat_t = nc.read("lat")
    mt = nc.read("model_time")
    y = np.asarray(convert.lat2y(lat_t[-1], 37.0))
    x = np.asarray(convert.lon2x(lon_t[-1], lat_t[-1], -76.0, 37.0))
    xt, yt, zt = case.analytic(x0, y0, z0, float(mt[-1]))
    err = np.hypot(x - xt, y - yt)
    # curvilinear staggered-mesh discretization budget (see
    # test_trajectories_match_analytic_curvilinear) + lon/lat IO
    # round-trip at f64
    assert err.max() < 20.0, err.max()


def test_curv_dp_sharded_matches_unsharded(curv_case):
    """VERDICT r4 missing #2: curvilinear runs are no longer excluded
    from the sharded driver — particle-DP sharding (mesh_particles = N,
    mesh_tiles = 1) must reproduce the unsharded step exactly (the
    fields are replicated; particles are independent)."""
    import jax
    import jax.random as jr
    from ltjax import shard
    from ltjax import state as st
    from ltjax.config import Config
    from ltjax.step import StepContext, make_external_step

    g = curv_case.grid
    bounds = bd.build_boundaries_curv(np.asarray(g.mask_rho),
                                      curv_case.x2d, curv_case.y2d,
                                      g.curv)
    ctx = StepContext(grid=g, bounds=bounds, polys=None, holes=None)
    cfg = Config(numpar=96, dt=1800, idt=450, us=8, ws=9,
                 HTurbOn=True, ConstantHTurb=2.0,
                 OpenOceanBoundary=True, dtype_pos="float64")
    fs = synth.fieldset_for(curv_case, t_center=900.0, dt=1800.0)
    rng = np.random.default_rng(3)
    n = cfg.numpar
    p0 = st.init_particles(rng.uniform(30e3, 70e3, n),
                           rng.uniform(30e3, 70e3, n),
                           rng.uniform(-40.0, -5.0, n))

    ref = make_external_step(ctx, cfg, jr.key(0))(p0, fs, 0.0, 0)

    spec = shard.make_spec(cfg, g.ny, n, 2, 1, halo=0, slack=3.0)
    mesh = shard.make_mesh(spec, jax.devices()[:2])
    tiled = shard.build_tiled_static(g, spec)
    step = shard.make_tiled_step(ctx, cfg, spec, tiled, mesh, jr.key(0))
    pbuf = shard.scatter_particles(p0, spec, tiled.tile_edges)
    pbuf, drops = step(pbuf, shard.pad_fieldset_eta(fs, spec.ny_pad),
                       0.0, 0)
    assert int(jnp.sum(drops)) == 0
    out = shard.gather_particles(pbuf)

    o = np.argsort(np.asarray(out.pid))
    r = np.argsort(np.asarray(ref.pid))
    np.testing.assert_array_equal(np.asarray(out.status)[o],
                                  np.asarray(ref.status)[r])
    np.testing.assert_allclose(np.asarray(out.x)[o], np.asarray(ref.x)[r],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(out.y)[o], np.asarray(ref.y)[r],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(out.z)[o], np.asarray(ref.z)[r],
                               rtol=0, atol=1e-10)

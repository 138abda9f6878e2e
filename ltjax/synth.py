"""Synthetic analytic ROMS-like test cases.

The reference validates against a bundled ROMS sample run (SURVEY.md
SS4); with the reference mount empty, we *create* the oracle: velocity
fields with closed-form trajectories, written in ROMS variable layout.

Solid-body rotation with linear vertical shear and linear time ramp:

    u(x, y, z, t) = -Omega (y - yc) (1 + a z) (1 + b t)
    v(x, y, z, t) =  Omega (x - xc) (1 + a z) (1 + b t)
    w = 0,   zeta = 0,   flat or sloped bathymetry

is *exactly* representable by the engine's interpolation stack
(bilinear in the horizontal: u linear in y; natural/tension spline in
the vertical: linear data is reproduced exactly; quadratic time
interpolation: linear in t), so the only discrepancy vs. the analytic
trajectory is RK4 truncation.  A particle starting at radius r, angle
theta0, depth zp follows

    theta(t) = theta0 + Omega (1 + a zp) (t + b t^2 / 2)

because w = 0 keeps zp constant.  This pins the entire advection path
(locate -> bilinear -> spline -> polintd -> RK4) to machine-level
accuracy in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .grid import Grid, make_grid, uniform_sigma_levels


class SolidBodyCase(NamedTuple):
    grid: Grid
    omega: float
    xc: float
    yc: float
    shear_a: float
    ramp_b: float
    h0: float

    def velocity(self, x, y, z, t):
        f = (1.0 + self.shear_a * z) * (1.0 + self.ramp_b * t)
        u = -self.omega * (y - self.yc) * f
        v = self.omega * (x - self.xc) * f
        return u, v, np.zeros_like(u)

    def analytic(self, x0, y0, z0, t):
        """Exact particle position at time t (started at t=0)."""
        r = np.hypot(x0 - self.xc, y0 - self.yc)
        th0 = np.arctan2(y0 - self.yc, x0 - self.xc)
        th = th0 + self.omega * (1.0 + self.shear_a * z0) * (
            t + self.ramp_b * t * t / 2.0)
        return (self.xc + r * np.cos(th), self.yc + r * np.sin(th),
                np.full_like(np.asarray(th, np.float64), z0, dtype=np.float64))

    def slabs(self, t):
        """Field arrays at record time t, in (level, eta, xi) layout."""
        g = self.grid
        nx, ny, us, ws = g.nx, g.ny, g.us, g.ws
        x_rho = np.asarray(g.x_rho)
        y_rho = np.asarray(g.y_rho)
        x_u = np.asarray(g.x_u)
        y_v = np.asarray(g.y_v)
        h = np.asarray(g.h)
        # z of levels with zeta=0
        from .scoord import s_depths
        import jax.numpy as jnp
        z_r = np.asarray(s_depths(jnp.zeros(()), g.hc * 0 + jnp.asarray(h),
                                  g.s_rho, g.Cs_r, g.hc, g.vtransform))
        # shapes: h (ny,nx) -> z_r (ny,nx,us); want (us,ny,nx)
        z_r = np.moveaxis(z_r, -1, 0)
        zeta = np.zeros((ny, nx))
        ramp = 1.0 + self.ramp_b * t
        # u on u-grid: (us, ny, nx-1)
        yy = y_rho[:, None]
        u = (-self.omega * (yy - self.yc) * ramp)[None, :, :]  # (1, ny, 1)?
        u = np.broadcast_to(u, (us, ny, 1))
        zshear_u = 1.0 + self.shear_a * 0.5 * (z_r[:, :, 1:] + z_r[:, :, :-1])
        u = u * zshear_u
        # v on v-grid: (us, ny-1, nx)
        xx = x_rho[None, :]
        v = (self.omega * (xx - self.xc) * ramp)[None, :, :]
        v = np.broadcast_to(v, (us, 1, nx))
        zshear_v = 1.0 + self.shear_a * 0.5 * (z_r[:, 1:, :] + z_r[:, :-1, :])
        v = v * zshear_v
        w = np.zeros((ws, ny, nx))
        aks = np.zeros((ws, ny, nx))
        return dict(zeta=zeta, u=np.ascontiguousarray(u),
                    v=np.ascontiguousarray(v), w=w, aks=aks)


def make_solid_body_case(nx=41, ny=41, us=10, lx=100e3, ly=100e3,
                         h0=50.0, omega=1e-4, shear_a=0.0, ramp_b=0.0,
                         vtransform=1, theta_s=0.0,
                         dtype=None) -> SolidBodyCase:
    import jax.numpy as jnp
    from .grid import song_haidvogel_cs
    if dtype is None:
        dtype = jnp.float64 if jnp.zeros(()).dtype == jnp.float64 else jnp.float32
        # default to the enabled precision
        dtype = jnp.float64 if jnp.array(1.0).dtype == jnp.float64 else jnp.float32
    x_rho = np.linspace(0.0, lx, nx)
    y_rho = np.linspace(0.0, ly, ny)
    h = np.full((ny, nx), h0)
    mask = np.ones((ny, nx), np.int32)
    s_rho, s_w = uniform_sigma_levels(us)
    cs_r = song_haidvogel_cs(s_rho, theta_s)
    cs_w = song_haidvogel_cs(s_w, theta_s)
    grid = make_grid(x_rho, y_rho, h, mask, s_rho, cs_r, s_w, cs_w,
                     hc=h0, vtransform=vtransform, dtype=dtype)
    # Cs = s for uniform levels (theta_s = 0); hc=h0 makes Vtransform-1
    # z = h*s exactly (z0 = hc*s + (h-hc)*Cs = h*s when hc=h0, Cs=s).
    # theta_s > 0 gives a genuinely stretched ladder (Cs != s, hc != 0)
    # (coverage for the general z-space vertical knots).
    return SolidBodyCase(grid=grid, omega=omega, xc=lx / 2, yc=ly / 2,
                         shear_a=shear_a, ramp_b=ramp_b, h0=h0)


class CurvSolidBodyCase(NamedTuple):
    """Solid-body rotation on a gently CURVILINEAR Arakawa-C mesh.

    The mesh is a smooth sinusoidal distortion of a rectangle; the
    velocity field is the same physical solid-body rotation sampled at
    the curvilinear node positions (components stored as east/north —
    see the angle note in io.roms).  Because the engine's inverse
    locate and its value interpolation use the SAME per-cell bilinear
    map, a linear-in-physical-space velocity interpolates exactly on
    the rho mesh; the staggered u/v meshes differ from the rho mesh by
    O(h^2 * curvature), so trajectories match the analytic circles to
    a few metres over hours (vs ~mm on rectilinear) — the curvilinear
    acceptance tests budget that.  Reference analog: the bundled
    estuary test case runs on a curvilinear grid (SURVEY.md SS2.1 #17
    [conf: M]).
    """
    grid: Grid
    x2d: np.ndarray
    y2d: np.ndarray
    omega: float
    xc: float
    yc: float
    h0: float

    def velocity(self, x, y, z, t):
        u = -self.omega * (y - self.yc)
        v = self.omega * (x - self.xc)
        return u, v, np.zeros_like(u)

    def analytic(self, x0, y0, z0, t):
        r = np.hypot(x0 - self.xc, y0 - self.yc)
        th0 = np.arctan2(y0 - self.yc, x0 - self.xc)
        th = th0 + self.omega * t
        return (self.xc + r * np.cos(th), self.yc + r * np.sin(th),
                np.full_like(np.asarray(th, np.float64), z0,
                             dtype=np.float64))

    def slabs(self, t):
        g = self.grid
        nx, ny, us, ws = g.nx, g.ny, g.us, g.ws
        x2, y2 = self.x2d, self.y2d
        zeta = np.zeros((ny, nx))
        # u nodes: midpoints of x-adjacent rho nodes (logical stagger)
        xu = 0.5 * (x2[:, 1:] + x2[:, :-1])
        yu = 0.5 * (y2[:, 1:] + y2[:, :-1])
        xv = 0.5 * (x2[1:, :] + x2[:-1, :])
        yv = 0.5 * (y2[1:, :] + y2[:-1, :])
        u = np.broadcast_to((-self.omega * (yu - self.yc))[None],
                            (us, ny, nx - 1))
        v = np.broadcast_to((self.omega * (xv - self.xc))[None],
                            (us, ny - 1, nx))
        w = np.zeros((ws, ny, nx))
        aks = np.zeros((ws, ny, nx))
        return dict(zeta=zeta, u=np.ascontiguousarray(u),
                    v=np.ascontiguousarray(v), w=w, aks=aks)


def make_curv_case(nx=41, ny=41, us=10, lx=100e3, ly=100e3, h0=50.0,
                   omega=1e-4, amp=0.02, mask=None,
                   dtype=None) -> CurvSolidBodyCase:
    """Gently-curvilinear analytic case: sinusoidal mesh distortion of
    relative amplitude ``amp`` (fraction of the domain size)."""
    import jax.numpy as jnp
    from .grid import make_curv_grid
    if dtype is None:
        dtype = jnp.float64 if jnp.array(1.0).dtype == jnp.float64 \
            else jnp.float32
    xi = np.linspace(0.0, lx, nx)
    eta = np.linspace(0.0, ly, ny)
    X, Y = np.meshgrid(xi, eta)
    x2 = X + amp * lx * np.sin(np.pi * X / lx) * np.sin(2 * np.pi * Y / ly)
    y2 = Y + amp * ly * np.sin(2 * np.pi * X / lx) * np.sin(np.pi * Y / ly)
    h = np.full((ny, nx), h0)
    if mask is None:
        mask = np.ones((ny, nx), np.int32)
    s_rho, s_w = uniform_sigma_levels(us)
    grid = make_curv_grid(x2, y2, h, mask, s_rho, s_rho, s_w, s_w,
                          hc=h0, vtransform=1, dtype=dtype)
    return CurvSolidBodyCase(grid=grid, x2d=x2, y2d=y2, omega=omega,
                             xc=lx / 2, yc=ly / 2, h0=h0)


def write_roms_files(case: SolidBodyCase, out_dir: str, n_records: int,
                     dt: float, records_per_file: int = 4,
                     prefix: str = "ocean_his_", numdigits: int = 4,
                     t0: float = 0.0, geographic: bool = False,
                     lonmin: float = 0.0, latmin: float = 0.0):
    """Write the case as a numbered multi-file ROMS history series +
    grid file (NetCDF3), for exercising the real input pipeline.

    Returns (grid_path, [history_paths]).  With geographic=True the
    coordinate variables are written as lon/lat about (lonmin, latmin)
    using the engine's own projection inverse, so a full
    namelist-driven run round-trips exactly.
    """
    import os
    from .io.nc import write_netcdf
    from . import convert

    os.makedirs(out_dir, exist_ok=True)
    g = case.grid
    nx, ny, us, ws = g.nx, g.ny, g.us, g.ws
    if g.curv is not None:
        x2d = np.asarray(case.x2d, np.float64)
        y2d = np.asarray(case.y2d, np.float64)
    else:
        x = np.asarray(g.x_rho)
        y = np.asarray(g.y_rho)
        x2d = np.broadcast_to(x, (ny, nx))
        y2d = np.broadcast_to(y[:, None], (ny, nx))
    if geographic:
        lat2d = np.asarray(convert.y2lat(y2d, latmin))
        if g.curv is not None:
            # pointwise inverse projection (x2lon takes y in meters)
            lon2d = np.asarray(convert.x2lon(x2d, y2d, lonmin, latmin))
        else:
            # rectilinear-in-meters stays rectilinear-in-degrees: project
            # the x axis at the mid latitude (matches rho_axes_from_grid)
            y_mid = np.full_like(x2d, float(y2d.mean()))
            lon2d = np.asarray(convert.x2lon(x2d, y_mid, lonmin, latmin))
        coord_vars = {
            "lon_rho": (("eta_rho", "xi_rho"), lon2d),
            "lat_rho": (("eta_rho", "xi_rho"), lat2d),
        }
    else:
        coord_vars = {
            "x_rho": (("eta_rho", "xi_rho"), x2d),
            "y_rho": (("eta_rho", "xi_rho"), y2d),
        }

    grid_path = os.path.join(out_dir, "grid.nc")
    write_netcdf(
        grid_path,
        dims={"eta_rho": ny, "xi_rho": nx, "s_rho": us, "s_w": ws},
        variables={
            **coord_vars,
            "mask_rho": (("eta_rho", "xi_rho"),
                         np.asarray(g.mask_rho, np.int32)),
            "h": (("eta_rho", "xi_rho"), np.asarray(g.h)),
            "s_rho": (("s_rho",), np.asarray(g.s_rho)),
            "s_w": (("s_w",), np.asarray(g.s_w)),
            "Cs_r": (("s_rho",), np.asarray(g.Cs_r)),
            "Cs_w": (("s_w",), np.asarray(g.Cs_w)),
            "hc": ((), np.asarray(float(g.hc))),
            "Vtransform": ((), np.asarray(g.vtransform, np.int32)),
        })

    hist_paths = []
    rec = 0
    fileno = 1
    while rec < n_records:
        n_this = min(records_per_file, n_records - rec)
        times = t0 + dt * np.arange(rec, rec + n_this)
        slabs = [case.slabs(t) for t in times]
        stack = lambda k: np.stack([s[k] for s in slabs]).astype(np.float32)
        path = os.path.join(out_dir, f"{prefix}{fileno:0{numdigits}d}.nc")
        write_netcdf(
            path,
            dims={"ocean_time": n_this, "eta_rho": ny, "xi_rho": nx,
                  "eta_u": ny, "xi_u": nx - 1, "eta_v": ny - 1,
                  "xi_v": nx, "s_rho": us, "s_w": ws},
            variables={
                "ocean_time": (("ocean_time",), np.asarray(times)),
                "zeta": (("ocean_time", "eta_rho", "xi_rho"),
                         stack("zeta")),
                "u": (("ocean_time", "s_rho", "eta_u", "xi_u"),
                      stack("u")),
                "v": (("ocean_time", "s_rho", "eta_v", "xi_v"),
                      stack("v")),
                "w": (("ocean_time", "s_w", "eta_rho", "xi_rho"),
                      stack("w")),
                "AKs": (("ocean_time", "s_w", "eta_rho", "xi_rho"),
                        stack("aks")),
            })
        hist_paths.append(path)
        rec += n_this
        fileno += 1
    return grid_path, hist_paths


def fieldset_for(case: SolidBodyCase, t_center: float, dt: float,
                 dtype=None):
    """Triple-buffered FieldSet with records at t_center-dt, t_center,
    t_center+dt."""
    return fieldset_window(case, t_center - dt, dt, 3, dtype=dtype)


def fieldset_window(case: SolidBodyCase, t_first: float, dt: float,
                    n_records: int, dtype=None):
    """FieldSet with ``n_records`` records at t_first + k*dt (external
    step e of a run reads records [e, e+1, e+2])."""
    import jax.numpy as jnp
    from .fields import make_fieldset
    if dtype is None:
        dtype = jnp.asarray(case.grid.x_rho).dtype
    times = [t_first + k * dt for k in range(n_records)]
    slabs = [case.slabs(t) for t in times]
    stack = lambda k: np.stack([s[k] for s in slabs])
    return make_fieldset(stack("zeta"), stack("u"), stack("v"), stack("w"),
                         stack("aks"), np.asarray(times), dtype=dtype)

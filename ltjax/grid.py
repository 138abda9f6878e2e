"""Arakawa-C grid container and structured cell location.

Reference: ``initGrid`` in hydrodynamic_module.f90 builds node arrays
for the rho/u/v grids, forms quad elements, and searches for the
element containing each particle (``setEle``/``gridcell()``,
SURVEY.md SS2.1 #3/#4).  ROMS grids are *structured*, so this
design replaces element search entirely with index arithmetic
(SURVEY.md SS7.1): cell location is a searchsorted (or a multiply for
uniform grids) on the 1D coordinate axes — O(log n) with zero
divergence, vmap-free and fully batched.

v1 supports rectilinear grids (1D x/y coordinate axes, the common ROMS
idealized/estuary configuration and all bundled test cases); the grid
stores projected meter coordinates.  Curvilinear support would add a
Newton inverse-bilinear refinement on top of the same API.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class CurvMap(NamedTuple):
    """Inverse curvilinear map data (SURVEY.md SS7.1: replace the
    reference's element search with a precomputed seed + local Newton).

    ``xy_flat`` holds the projected rho-point coordinates as
    (Ny*Nx, 2) rows (one row gather returns both coords of a corner);
    the seed raster is a uniform lattice over the domain bounding box
    whose nodes store the nearest rho-CELL index — the Newton start.
    """
    xy_flat: jax.Array     # (Ny*Nx, 2) projected rho coords [m]
    seed_i: jax.Array      # (My, Mx) int32 seed cell i
    seed_j: jax.Array      # (My, Mx) int32 seed cell j
    rx0: jax.Array         # scalar raster origin x
    ry0: jax.Array
    inv_rdx: jax.Array     # scalar 1/raster spacing
    inv_rdy: jax.Array


class Grid(NamedTuple):
    """Static grid data (a pytree of arrays; axes are (eta, xi)=(y, x)).

    ``uniform`` (static bool) marks exactly-uniform coordinate axes; the
    cell locate then becomes index arithmetic (one multiply) instead of
    a searchsorted (a per-query binary search).

    ``curv`` (CurvMap) marks a general curvilinear grid: the 1-D axes
    hold representative coordinates (middle row/column) for diagnostics
    only, and ALL cell location goes through ``logical_coords``
    (seed-raster + Newton inverse of the bilinear quad map) — the
    vectorized replacement of ``setEle``/``gridcell()``
    (hydrodynamic_module.f90 / gridcell_module.f90, SURVEY.md SS2.1
    #3/#4 [conf: H]).
    """

    x_rho: jax.Array       # (Nx,)  xi-axis rho-point coords [m]
    y_rho: jax.Array       # (Ny,)
    x_u: jax.Array         # (Nx-1,) u points: between rho points in x
    y_v: jax.Array         # (Ny-1,) v points: between rho points in y
    h: jax.Array           # (Ny, Nx) bathymetry (positive depth) at rho
    mask_rho: jax.Array    # (Ny, Nx) 1=water 0=land
    mask_u: jax.Array      # (Ny, Nx-1)
    mask_v: jax.Array      # (Ny-1, Nx)
    s_rho: jax.Array       # (us,)
    Cs_r: jax.Array        # (us,)
    s_w: jax.Array         # (ws,)
    Cs_w: jax.Array        # (ws,)
    hc: jax.Array          # scalar
    vtransform: int        # static: 1 or 2
    uniform: bool = False  # static: all four axes exactly uniform
    curv: "CurvMap | None" = None  # curvilinear inverse-map data

    @property
    def nx(self) -> int:
        return self.x_rho.shape[0]

    @property
    def ny(self) -> int:
        return self.y_rho.shape[0]

    @property
    def us(self) -> int:
        return self.s_rho.shape[0]

    @property
    def ws(self) -> int:
        return self.s_w.shape[0]


# Register vtransform as static-friendly: it is a plain int in a NamedTuple,
# which JAX treats as a leaf; keep it an int (weak-typed scalar) — jit will
# retrace if it changes, which is correct behavior.


def _is_uniform(ax: np.ndarray, rtol: float = 1e-9) -> bool:
    d = np.diff(np.asarray(ax, np.float64))
    if d.size == 0:
        return True
    d0 = float(np.mean(d))
    return bool(np.all(np.abs(d - d0) <= rtol * max(abs(d0), 1.0)))


def make_grid(x_rho, y_rho, h, mask_rho, s_rho, Cs_r, s_w, Cs_w, hc,
              vtransform=1, dtype=jnp.float64, uniform=None) -> Grid:
    """Build a Grid from rho-point axes + bathymetry (+s-coord data).

    uniform=None auto-detects exactly-uniform coordinate axes (host
    side, once) to enable the arithmetic locate fast path.
    """
    if uniform is None:
        uniform = _is_uniform(np.asarray(x_rho)) and _is_uniform(
            np.asarray(y_rho))
    x_rho = jnp.asarray(x_rho, dtype)
    y_rho = jnp.asarray(y_rho, dtype)
    h = jnp.asarray(h, dtype)
    mask_rho = jnp.asarray(mask_rho, jnp.int32)
    x_u = 0.5 * (x_rho[1:] + x_rho[:-1])
    y_v = 0.5 * (y_rho[1:] + y_rho[:-1])
    mask_u = mask_rho[:, 1:] * mask_rho[:, :-1]
    mask_v = mask_rho[1:, :] * mask_rho[:-1, :]
    return Grid(
        x_rho=x_rho, y_rho=y_rho, x_u=x_u, y_v=y_v, h=h,
        mask_rho=mask_rho, mask_u=mask_u, mask_v=mask_v,
        s_rho=jnp.asarray(s_rho, dtype), Cs_r=jnp.asarray(Cs_r, dtype),
        s_w=jnp.asarray(s_w, dtype), Cs_w=jnp.asarray(Cs_w, dtype),
        hc=jnp.asarray(hc, dtype), vtransform=int(vtransform),
        uniform=bool(uniform),
    )


def make_curv_grid(x2d, y2d, h, mask_rho, s_rho, Cs_r, s_w, Cs_w, hc,
                   vtransform=1, dtype=jnp.float64,
                   raster_factor: float = 2.0) -> Grid:
    """Build a curvilinear Grid from 2-D projected rho coordinates.

    Host-side (once at init): builds the seed raster of the inverse map
    — a uniform lattice over the bounding box whose nodes hold the rho
    CELL whose center is nearest (scatter rho cells into the raster,
    then dilate to fill holes).  Newton refinement (logical_coords)
    does the rest at run time.  Reference analog: ``initGrid``'s
    element formation + adjacency lists feeding ``setEle`` element
    search (hydrodynamic_module.f90, SURVEY.md SS2.1 #3 [conf: H]).
    """
    x2 = np.asarray(x2d, np.float64)
    y2 = np.asarray(y2d, np.float64)
    ny, nx = x2.shape
    # cell centers of the (ny-1) x (nx-1) rho-cell lattice
    cx = 0.25 * (x2[:-1, :-1] + x2[:-1, 1:] + x2[1:, :-1] + x2[1:, 1:])
    cy = 0.25 * (y2[:-1, :-1] + y2[:-1, 1:] + y2[1:, :-1] + y2[1:, 1:])
    # raster sized to ~raster_factor nodes per grid cell
    My = max(4, int(raster_factor * (ny - 1)))
    Mx = max(4, int(raster_factor * (nx - 1)))
    pad_x = (x2.max() - x2.min()) * 0.01 + 1e-9
    pad_y = (y2.max() - y2.min()) * 0.01 + 1e-9
    rx0 = x2.min() - pad_x
    ry0 = y2.min() - pad_y
    rdx = (x2.max() + pad_x - rx0) / Mx
    rdy = (y2.max() + pad_y - ry0) / My
    seed_i = np.full((My, Mx), -1, np.int32)
    seed_j = np.full((My, Mx), -1, np.int32)
    ri = np.clip(((cx - rx0) / rdx).astype(np.int64), 0, Mx - 1)
    rj = np.clip(((cy - ry0) / rdy).astype(np.int64), 0, My - 1)
    jj, ii = np.meshgrid(np.arange(ny - 1), np.arange(nx - 1),
                         indexing="ij")
    seed_i[rj, ri] = ii.astype(np.int32)
    seed_j[rj, ri] = jj.astype(np.int32)
    # fill raster holes by nearest-neighbor dilation (bounded sweeps)
    for _ in range(My + Mx):
        holes = seed_i < 0
        if not holes.any():
            break
        for dj, di in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            src_i = np.roll(seed_i, (dj, di), axis=(0, 1))
            src_j = np.roll(seed_j, (dj, di), axis=(0, 1))
            # roll wraps; mask out the wrapped border
            valid = np.ones((My, Mx), bool)
            if dj == 1:
                valid[0, :] = False
            elif dj == -1:
                valid[-1, :] = False
            if di == 1:
                valid[:, 0] = False
            elif di == -1:
                valid[:, -1] = False
            take = holes & valid & (src_i >= 0)
            seed_i[take] = src_i[take]
            seed_j[take] = src_j[take]
            holes = seed_i < 0
    assert (seed_i >= 0).all(), "seed raster fill failed"

    mask_rho = jnp.asarray(mask_rho, jnp.int32)
    mask_u = mask_rho[:, 1:] * mask_rho[:, :-1]
    mask_v = mask_rho[1:, :] * mask_rho[:-1, :]
    xy_flat = np.stack([x2.reshape(-1), y2.reshape(-1)], axis=-1)
    curv = CurvMap(
        xy_flat=jnp.asarray(xy_flat, dtype),
        seed_i=jnp.asarray(seed_i), seed_j=jnp.asarray(seed_j),
        rx0=jnp.asarray(rx0, dtype), ry0=jnp.asarray(ry0, dtype),
        inv_rdx=jnp.asarray(1.0 / rdx, dtype),
        inv_rdy=jnp.asarray(1.0 / rdy, dtype))
    # representative 1-D axes (diagnostics/output only — never locate)
    x_ax = jnp.asarray(x2[ny // 2, :], dtype)
    y_ax = jnp.asarray(y2[:, nx // 2], dtype)
    return Grid(
        x_rho=x_ax, y_rho=y_ax,
        x_u=0.5 * (x_ax[1:] + x_ax[:-1]), y_v=0.5 * (y_ax[1:] + y_ax[:-1]),
        h=jnp.asarray(h, dtype), mask_rho=mask_rho,
        mask_u=mask_u, mask_v=mask_v,
        s_rho=jnp.asarray(s_rho, dtype), Cs_r=jnp.asarray(Cs_r, dtype),
        s_w=jnp.asarray(s_w, dtype), Cs_w=jnp.asarray(Cs_w, dtype),
        hc=jnp.asarray(hc, dtype), vtransform=int(vtransform),
        uniform=False, curv=curv)


def logical_coords(grid: Grid, x, y, iters: int = 3):
    """Continuous logical rho-lattice coordinates (ti, tj) of physical
    points on a curvilinear grid (requires grid.curv).

    ti in [0, nx-1]: floor(ti) is the containing rho cell, frac the
    bilinear fraction.  Seed from the raster, then ``iters`` Newton
    steps on the bilinear quad map; each step is 4 two-lane row
    gathers + a 2x2 solve, fully vectorized (the batched
    replacement of the reference's per-particle element walk,
    SURVEY.md SS7.1).  Out-of-mesh queries clamp to the rim cells
    (same contract as ``locate``).
    """
    return curv_logical(grid.curv, grid.nx, grid.ny, x, y, iters)[:2]


def curv_logical(cm: CurvMap, nx: int, ny: int, x, y, iters: int = 3):
    """Core inverse-map solve on a CurvMap (see logical_coords).

    Returns (ti, tj, resid2) with resid2 the squared physical residual
    of the final Newton iterate — large residual means the query lies
    outside the mesh (it clamped to a rim cell); callers use it as an
    inside-the-mesh test (ltjax.physics.boundary.in_water).
    """
    dtype = x.dtype
    My, Mx = cm.seed_i.shape
    ri = jnp.clip(jnp.floor((x - cm.rx0) * cm.inv_rdx).astype(jnp.int32),
                  0, Mx - 1)
    rj = jnp.clip(jnp.floor((y - cm.ry0) * cm.inv_rdy).astype(jnp.int32),
                  0, My - 1)
    rflat = rj * Mx + ri
    ti = cm.seed_i.reshape(-1)[rflat].astype(dtype) + 0.5
    tj = cm.seed_j.reshape(-1)[rflat].astype(dtype) + 0.5
    xyf = cm.xy_flat.astype(dtype)
    for _ in range(iters):
        i = jnp.clip(jnp.floor(ti), 0.0, nx - 2.0)
        j = jnp.clip(jnp.floor(tj), 0.0, ny - 2.0)
        fx = ti - i
        fy = tj - j
        base = (j * nx + i).astype(jnp.int32)
        c00 = xyf[base]
        c01 = xyf[base + 1]
        c10 = xyf[base + nx]
        c11 = xyf[base + nx + 1]
        ax = c01 - c00
        ay = c10 - c00
        axy = c11 - c01 - c10 + c00
        p = (c00 + fx[:, None] * ax + fy[:, None] * ay
             + (fx * fy)[:, None] * axy)
        jx = ax + fy[:, None] * axy        # dP/dfx (2,)
        jy = ay + fx[:, None] * axy        # dP/dfy
        det = jx[:, 0] * jy[:, 1] - jx[:, 1] * jy[:, 0]
        det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
        rx = x - p[:, 0]
        ry = y - p[:, 1]
        dfx = (jy[:, 1] * rx - jy[:, 0] * ry) / det
        dfy = (-jx[:, 1] * rx + jx[:, 0] * ry) / det
        # bounded update: at most ~1.5 cells per step (robustness on
        # strongly distorted quads; gentle grids converge in 2 steps)
        ti = i + jnp.clip(fx + dfx, -1.5, 2.5)
        tj = j + jnp.clip(fy + dfy, -1.5, 2.5)
    ti = jnp.clip(ti, 0.0, nx - 1.0)
    tj = jnp.clip(tj, 0.0, ny - 1.0)
    # forward-map residual at the clamped solution (inside test)
    i = jnp.clip(jnp.floor(ti), 0.0, nx - 2.0)
    j = jnp.clip(jnp.floor(tj), 0.0, ny - 2.0)
    fx = ti - i
    fy = tj - j
    base = (j * nx + i).astype(jnp.int32)
    c00 = xyf[base]
    c01 = xyf[base + 1]
    c10 = xyf[base + nx]
    c11 = xyf[base + nx + 1]
    p = (c00 + fx[:, None] * (c01 - c00) + fy[:, None] * (c10 - c00)
         + (fx * fy)[:, None] * (c11 - c01 - c10 + c00))
    resid2 = (x - p[:, 0]) ** 2 + (y - p[:, 1]) ** 2
    return ti, tj, resid2


def locate_rho_ij(grid: Grid, x, y):
    """(i, j, fx, fy) on the rho-point lattice — curvilinear-aware.

    Rectilinear grids use the per-axis ``locate``; curvilinear grids go
    through the inverse map (``logical_coords``).  Single entry point
    for every rho-lattice cell location (interp, packed tables).
    """
    if grid.curv is not None:
        ti, tj = logical_coords(grid, x, y)
        i = jnp.clip(jnp.floor(ti), 0.0, grid.nx - 2.0)
        j = jnp.clip(jnp.floor(tj), 0.0, grid.ny - 2.0)
        fx = jnp.clip(ti - i, 0.0, 1.0)
        fy = jnp.clip(tj - j, 0.0, 1.0)
        return i.astype(jnp.int32), j.astype(jnp.int32), fx, fy
    i, fx = locate(grid.x_rho, x, grid.uniform)
    j, fy = locate(grid.y_rho, y, grid.uniform)
    return i, j, fx, fy


def stag_from_logical(t, n: int):
    """Staggered-lattice index + fraction from a continuous rho logical
    coordinate: the u (or v) points sit at rho + 0.5 along their axis,
    so the staggered cell coordinate is t - 0.5 on an (n-1)-point
    lattice."""
    ts = t - 0.5
    i = jnp.clip(jnp.floor(ts), 0.0, n - 3.0)
    f = jnp.clip(ts - i, 0.0, 1.0)
    return i.astype(jnp.int32), f


def locate(coords: jax.Array, x: jax.Array, uniform: bool = False):
    """Cell index + fractional coordinate along one axis.

    coords: (n,) strictly increasing node coordinates.
    x: (...,) query points.  Returns (i, f) with i in [0, n-2] and
    f = (x - coords[i]) / (coords[i+1] - coords[i]) clipped to [0, 1]
    (queries outside the axis clamp to the edge cells, matching the
    reference's treatment of particles at the domain rim [conf: M]).

    uniform=True (static) replaces the searchsorted with index
    arithmetic — this is the hot path's first op.
    """
    n = coords.shape[0]
    if uniform and n >= 2:
        c0 = coords[0]
        dx = coords[1] - coords[0]
        t = (x - c0) / dx
        i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, n - 2)
        f = jnp.clip(t - i.astype(t.dtype), 0.0, 1.0)
        return i, f
    i = jnp.clip(jnp.searchsorted(coords, x, side="right") - 1, 0, n - 2)
    c0 = coords[i]
    c1 = coords[i + 1]
    f = jnp.clip((x - c0) / (c1 - c0), 0.0, 1.0)
    return i.astype(jnp.int32), f


def song_haidvogel_cs(s, theta_s=0.0, theta_b=0.0):
    """Stretching curve C(s) (for building synthetic grids; ROMS files
    normally ship Cs_r/Cs_w directly)."""
    s = np.asarray(s, np.float64)
    if theta_s > 0:
        c = (1 - theta_b) * np.sinh(theta_s * s) / np.sinh(theta_s) + theta_b * (
            np.tanh(theta_s * (s + 0.5)) / (2 * np.tanh(0.5 * theta_s)) - 0.5
        )
    else:
        c = s
    return c


def uniform_sigma_levels(us: int):
    """Uniform s_rho / s_w in [-1, 0] (synthetic-dataset helper)."""
    ws = us + 1
    s_w = np.linspace(-1.0, 0.0, ws)
    s_rho = 0.5 * (s_w[1:] + s_w[:-1])
    return s_rho, s_w

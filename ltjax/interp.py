"""Horizontal bilinear + quadratic-in-time interpolation.

Reference: ``setInterp``/``getInterp`` (bilinear weights within the
containing quad element, per grid and time level) and ``polintd``
(2nd-order Lagrange polynomial through the 3 buffered time records),
hydrodynamic_module.f90 (SURVEY.md SS2.1 #3 [conf: H mechanisms]).

Everything is batched over particles; gathers are plain advanced
indexing that XLA lowers to dynamic-gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .grid import (Grid, locate, locate_rho_ij, logical_coords,
                   stag_from_logical)


def bilinear_weights(fx, fy):
    """4 corner weights, order (j,i),(j,i+1),(j+1,i),(j+1,i+1)."""
    w00 = (1.0 - fx) * (1.0 - fy)
    w01 = fx * (1.0 - fy)
    w10 = (1.0 - fx) * fy
    w11 = fx * fy
    return w00, w01, w10, w11


def _flat_corners(shape, i, j):
    """Flat row indices of the 4 bilinear corners, with all leading
    axes (time) folded into the row index.

    shape: the field's shape up to (..., Ny, Nx[, K]); i/j: (N,).
    Returns four (L, N) int32 index arrays (L = prod of leading axes),
    suitable for a single leading-axis row gather.
    """
    ny, nx = shape[-2], shape[-1]
    lead = 1
    for s in shape[:-2]:
        lead *= s
    base = j.astype(jnp.int32) * nx + i.astype(jnp.int32)       # (N,)
    offs = (jnp.arange(lead, dtype=jnp.int32) * (ny * nx))[:, None]
    i00 = offs + base
    return i00, i00 + 1, i00 + nx, i00 + nx + 1


def interp2d(field, i, j, fx, fy):
    """Bilinear interp of ``field[..., eta, xi]`` at fractional cells.

    field: (..., Ny, Nx); i/j/fx/fy: (N,). Leading field axes broadcast;
    returns (..., N).
    """
    lead_shape = field.shape[:-2]
    flat = field.reshape(-1)
    i00, i01, i10, i11 = _flat_corners(field.shape, i, j)
    w00, w01, w10, w11 = bilinear_weights(fx, fy)
    out = (flat[i00] * w00 + flat[i01] * w01
           + flat[i10] * w10 + flat[i11] * w11)
    return out.reshape(lead_shape + i.shape)


def interp_columns(field, i, j, fx, fy):
    """Bilinear interp of a level-resolved field to particle columns.

    field: (..., Ny, Nx, K) **K-last** (see ltjax.fields);  returns
    (..., N, K) vertical profiles at each particle (the reference's
    per-s-level getInterp loop inside WCTS_ITPI, vectorized).  Each
    corner is one contiguous K-row fetched by a flat leading-axis row
    gather (one contiguous row per corner instead of strided
    multi-axis fancy indexing).
    """
    K = field.shape[-1]
    lead_shape = field.shape[:-3]
    flat = field.reshape(-1, K)
    i00, i01, i10, i11 = _flat_corners(field.shape[:-1], i, j)
    w00, w01, w10, w11 = bilinear_weights(fx, fy)
    prof = (flat[i00] * w00[..., None] + flat[i01] * w01[..., None]
            + flat[i10] * w10[..., None] + flat[i11] * w11[..., None])
    return prof.reshape(lead_shape + i.shape + (K,))


def polintd(f, times, t):
    """Quadratic Lagrange through 3 time records, evaluated at t.

    f: (3, ...) values at the 3 buffered records; times: (3,); t scalar
    or broadcastable to f[0].
    """
    t0, t1, t2 = times[0], times[1], times[2]
    l0 = (t - t1) * (t - t2) / ((t0 - t1) * (t0 - t2))
    l1 = (t - t0) * (t - t2) / ((t1 - t0) * (t1 - t2))
    l2 = (t - t0) * (t - t1) / ((t2 - t0) * (t2 - t1))
    return f[0] * l0 + f[1] * l1 + f[2] * l2


def locate_rho(grid: Grid, x, y):
    return locate_rho_ij(grid, x, y)


def locate_u(grid: Grid, x, y):
    if grid.curv is not None:
        ti, tj = logical_coords(grid, x, y)
        i, fx = stag_from_logical(ti, grid.nx)
        j = jnp.clip(jnp.floor(tj), 0.0, grid.ny - 2.0)
        fy = jnp.clip(tj - j, 0.0, 1.0)
        return i, j.astype(jnp.int32), fx, fy
    i, fx = locate(grid.x_u, x, grid.uniform)
    j, fy = locate(grid.y_rho, y, grid.uniform)
    return i, j, fx, fy


def locate_v(grid: Grid, x, y):
    if grid.curv is not None:
        ti, tj = logical_coords(grid, x, y)
        i = jnp.clip(jnp.floor(ti), 0.0, grid.nx - 2.0)
        fx = jnp.clip(ti - i, 0.0, 1.0)
        j, fy = stag_from_logical(tj, grid.ny)
        return i.astype(jnp.int32), j, fx, fy
    i, fx = locate(grid.x_rho, x, grid.uniform)
    j, fy = locate(grid.y_v, y, grid.uniform)
    return i, j, fx, fy


def locate_uvr(grid: Grid, x, y):
    """All three staggered locations with ONE inverse-map solve on
    curvilinear grids (find_currents calls this per RK4 stage)."""
    if grid.curv is not None:
        ti, tj = logical_coords(grid, x, y)
        ir = jnp.clip(jnp.floor(ti), 0.0, grid.nx - 2.0)
        jr = jnp.clip(jnp.floor(tj), 0.0, grid.ny - 2.0)
        fxr = jnp.clip(ti - ir, 0.0, 1.0)
        fyr = jnp.clip(tj - jr, 0.0, 1.0)
        ir = ir.astype(jnp.int32)
        jr = jr.astype(jnp.int32)
        iu, fxu = stag_from_logical(ti, grid.nx)
        jv, fyv = stag_from_logical(tj, grid.ny)
        return ((iu, jr, fxu, fyr), (ir, jv, fxr, fyv),
                (ir, jr, fxr, fyr))
    return (locate_u(grid, x, y), locate_v(grid, x, y),
            locate_rho(grid, x, y))

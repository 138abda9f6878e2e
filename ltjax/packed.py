"""Packed-table fast interpolation path (gather-optimized).

Reference semantics (SURVEY.md SS3.2, ``find_currents``): per time
record, horizontal bilinear of every s-level; vertical tension spline
of the blended profile; quadratic time interpolation last.

The native path gathers ~12 row sets and fits a spline per particle in
every RK4 stage.  This module reformulates the interpolation to gather
fewer, wider rows per particle-step, using two exact identities and
one standard scheme choice:

1. **Time-collapse first** (exact commute): the quadratic Lagrange
   time interpolation is linear with scalar coefficients shared by all
   particles, so collapsing the 3 time records into per-RK4-stage
   tables *on the grid* (dense, grid-sized work) commutes exactly
   with the bilinear horizontal interpolation.  (It does not commute
   with the level-depth dependence on zeta(t) — the knot positions use
   the stage-time zeta instead of per-record zeta — a standard choice,
   cf. time-first interpolation in other Lagrangian frameworks.)
2. **Column-spline / eval-then-blend** (scheme choice): fit the
   vertical tension spline *densely per grid column* (one tridiagonal
   solve per cell, grid-sized) and horizontally blend the 4 corner
   *evaluations* — instead of blending profiles and fitting per
   particle.  Both are consistent interpolants of the same data; the
   native path (ltjax.physics.advect) remains available as
   ``Config.fast_interp=False`` for reference-ordered semantics.
3. **Collocate u,v to rho points** (scheme choice): one cell-row table
   holds every field, so a particle-stage costs 2 gathered rows (the
   two eta-adjacent cell *pairs*) instead of 12+.

Packed cell-row layout, ``LANES = 128`` f32 lanes per cell:

    0:20    u (rho-collocated, us levels)       [us=20 shown]
    20:40   v
    40:61   w (ws levels)
    61      zeta
    62      h
    63      pad
    64:84   u z2 (spline second derivatives)
    84:104  v z2
    104:125 w z2
    125:128 pad

Pair-packed gather table: row c = [cell c | cell c+1] (2*LANES lanes),
so one row gather returns both x-corners of the bilinear stencil.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import tension
from .fields import FieldSet
from .grid import Grid, locate, locate_rho_ij
from .interp import polintd
from .scoord import s_depths


class PackedRecords(NamedTuple):
    """Per-record packed cell tables (built once per external step)."""
    tab: jax.Array      # (3, C, L) value lanes only (no z2 yet):
                        #   [u us | v us | w ws | zeta | h]
    times: jax.Array    # (3,)


class StageTable(NamedTuple):
    """One time-collapsed, spline-fitted, pair-packed gather table."""
    rows: jax.Array     # (C, 2*LANES) pair-packed cell rows
    zh_rows: jax.Array  # (C, 8) pair-packed [zeta, h, 0, 0] mini rows —
                        #   zeta/h-only lookups gather 8 lanes, not 256
    t: jax.Array        # scalar stage time


def _collocate_u(u):
    """(..., Ny, Nx-1, K) u-grid -> (..., Ny, Nx, K) rho-collocated."""
    mid = 0.5 * (u[..., :, 1:, :] + u[..., :, :-1, :])
    return jnp.concatenate([u[..., :, :1, :], mid, u[..., :, -1:, :]],
                           axis=-2)


def _collocate_v(v, ny: int):
    """v-grid -> rho-collocated along eta.

    Handles both layouts: native (..., Ny-1, Nx, K) and the tiled
    pre-padded one where v already carries Ny(=ny_ext) rows (row j
    between rho rows j and j+1; see ltjax.shard.pad_fieldset_eta).
    Output always has ny rows.
    """
    mid = 0.5 * (v[..., 1:, :, :] + v[..., :-1, :, :])
    if v.shape[-3] == ny - 1:
        return jnp.concatenate([v[..., :1, :, :], mid, v[..., -1:, :, :]],
                               axis=-3)
    assert v.shape[-3] == ny, (v.shape, ny)
    return jnp.concatenate([v[..., :1, :, :], mid], axis=-3)


def n_value_lanes(us: int, ws: int) -> int:
    return us + us + ws + 2


def half_lanes(us: int, ws: int) -> int:
    """Lane count of each cell half-section (values / z2), padded so a
    full cell row is lane-aligned.  For us=20: 64 -> 128-lane cells."""
    need = max(n_value_lanes(us, ws), us + us + ws)  # values ; z2
    return ((need + 63) // 64) * 64


def build_packed_records(grid: Grid, fields: FieldSet) -> PackedRecords:
    """Dense per-record packing (jit; grid-sized work).

    Collocates u, v onto rho points and concatenates value lanes.
    """
    u = _collocate_u(fields.u)                     # (3, Ny, Nx, us)
    v = _collocate_v(fields.v, grid.ny)            # (3, Ny, Nx, us)
    w = fields.w                                   # (3, Ny, Nx, ws)
    z = fields.zeta[..., None]                     # (3, Ny, Nx, 1)
    h = jnp.broadcast_to(grid.h.astype(u.dtype)[None, ..., None],
                         z.shape)
    tab = jnp.concatenate([u, v, w, z, h], axis=-1)
    three, ny, nx, L = tab.shape
    tab = tab.reshape(three, ny * nx, L)
    return PackedRecords(tab=tab, times=fields.times)


def _knots(zeta, h, s, cs, hc, vtransform):
    """s-level depths, broadcast over trailing knot axis.

    zeta/h: (...,); s/cs: (K,) -> (..., K).  Mirrors scoord.s_depths.
    """
    zeta = zeta[..., None]
    h = h[..., None]
    if vtransform == 1:
        z0 = hc * s + (h - hc) * cs
        return z0 + zeta * (1.0 + z0 / h)
    s_ = (hc * s + h * cs) / (hc + h)
    return zeta + (zeta + h) * s_


def collapse_stage(grid: Grid, rec: PackedRecords, t, sigma: float
                   ) -> StageTable:
    """Time-collapse records to stage time t, dense-fit the vertical
    splines per grid column, and pair-pack the gather rows."""
    us, ws = grid.us, grid.ws
    dtype = rec.tab.dtype
    tt = jnp.asarray(t, rec.times.dtype)
    nv = n_value_lanes(us, ws)
    vals = polintd(rec.tab[..., :nv], rec.times, tt)   # (C, nv)
    zeta = vals[:, nv - 2]
    h = vals[:, nv - 1]

    sdt = grid.s_rho.dtype
    z_r = _knots(zeta.astype(sdt), h.astype(sdt), grid.s_rho, grid.Cs_r,
                 grid.hc, grid.vtransform).astype(dtype)   # (C, us)
    z_w = _knots(zeta.astype(sdt), h.astype(sdt), grid.s_w, grid.Cs_w,
                 grid.hc, grid.vtransform).astype(dtype)   # (C, ws)

    sig = jnp.asarray(sigma, dtype)
    z2_u = tension.fit(z_r, vals[:, 0:us], sig)
    z2_v = tension.fit(z_r, vals[:, us:2 * us], sig)
    z2_w = tension.fit(z_w, vals[:, 2 * us:2 * us + ws], sig)

    HL = half_lanes(us, ws)
    C = vals.shape[0]
    pad1 = jnp.zeros((C, HL - nv), dtype)
    pad2 = jnp.zeros((C, HL - (2 * us + ws)), dtype)
    cell = jnp.concatenate([vals, pad1, z2_u, z2_v, z2_w, pad2], axis=-1)
    # pair rows: row c = [cell c | cell c+1]
    rows = jnp.concatenate([cell, jnp.roll(cell, -1, axis=0)], axis=-1)
    zh = jnp.stack([zeta, h, jnp.zeros_like(zeta), jnp.zeros_like(zeta)],
                   axis=-1)
    zh_rows = jnp.concatenate([zh, jnp.roll(zh, -1, axis=0)], axis=-1)
    return StageTable(rows=rows, zh_rows=zh_rows, t=tt)


def _eval_cubic_like(zq, zk, yk, z2, sigma: float):
    """Evaluate the tension spline at zq given per-corner knots.

    zq: (...,); zk: (..., K); yk/z2: (..., K).  sigma is the static
    uniform tension (0 => natural cubic fast path).  zq is clamped to
    the knot range (reference clamps to the water column).
    """
    K = zk.shape[-1]
    zq = jnp.clip(zq, zk[..., 0], zk[..., -1])
    # containing-interval one-hot over the K-1 intervals
    j = jnp.sum((zq[..., None] >= zk[..., 1:]).astype(jnp.int32), axis=-1)
    j = jnp.clip(j, 0, K - 2)
    oh = (j[..., None] == jnp.arange(K - 1, dtype=j.dtype)).astype(zk.dtype)

    def sel(a, off):
        return jnp.sum(a[..., off:off + K - 1] * oh, axis=-1)

    z0 = sel(zk, 0)
    z1 = jnp.sum(zk[..., 1:] * oh, axis=-1)
    y0 = sel(yk, 0)
    y1 = jnp.sum(yk[..., 1:] * oh, axis=-1)
    s0 = sel(z2, 0)
    s1 = jnp.sum(z2[..., 1:] * oh, axis=-1)

    hh = z1 - z0
    B2 = (zq - z0) / hh
    B1 = 1.0 - B2
    if sigma == 0.0:
        g1 = (B1 * B1 * B1 - B1) / 6.0
        g2 = (B2 * B2 * B2 - B2) / 6.0
    else:
        u = jnp.asarray(sigma, zk.dtype)
        g1 = tension._gs(u, B1)
        g2 = tension._gs(u, B2)
    return y0 * B1 + y1 * B2 + hh * hh * (s0 * g1 + s1 * g2)


def gather_corners(grid: Grid, table: StageTable, x, y):
    """Pair-row corner gather -> per-corner cell lanes + weights.

    Returns (cells, wx, wy): cells (N, 2, 2, HL) with axes
    (eta-corner, xi-corner); wx/wy (N,) fractional weights.
    """
    cw = table.rows.shape[-1] // 2          # full cell width (2 * HL)
    i, j, fx, fy = locate_rho_ij(grid, x, y)
    nx = grid.nx
    c00 = j.astype(jnp.int32) * nx + i.astype(jnp.int32)
    r0 = table.rows[c00]                    # (N, 2*cw) cells (j,i),(j,i+1)
    r1 = table.rows[c00 + nx]               # cells (j+1,i),(j+1,i+1)
    cells = jnp.stack([r0, r1], axis=1).reshape(x.shape[0], 2, 2, cw)
    return cells, fx, fy


def _blend(vals, wx, wy):
    """Bilinear blend of per-corner scalars vals (N, 2, 2)."""
    wx = wx.astype(vals.dtype)
    wy = wy.astype(vals.dtype)
    top = vals[:, 0, 0] * (1 - wx) + vals[:, 0, 1] * wx
    bot = vals[:, 1, 0] * (1 - wx) + vals[:, 1, 1] * wx
    return top * (1 - wy) + bot * wy


def find_currents_packed(grid: Grid, table: StageTable, x, y, z,
                         sigma: float, z0m: float):
    """(u, v, w) at particle positions from one stage table.

    Per-corner spline evaluation, bilinear blend of the 4 corner
    values, near-bottom log-layer decay (reference find_currents
    semantics, LTRANS.f90 [conf: M]).
    """
    dtype = x.dtype
    us, ws = grid.us, grid.ws
    nv = n_value_lanes(us, ws)
    HL = half_lanes(us, ws)
    cells, wx, wy = gather_corners(grid, table, x, y)
    cd = cells.dtype
    zq = z.astype(cd)[:, None, None]
    zq = jnp.broadcast_to(zq, cells.shape[:3])

    zeta_c = cells[..., nv - 2]
    h_c = cells[..., nv - 1]
    sdt = grid.s_rho.dtype
    z_r = _knots(zeta_c.astype(sdt), h_c.astype(sdt), grid.s_rho,
                 grid.Cs_r, grid.hc, grid.vtransform).astype(cd)
    z_w = _knots(zeta_c.astype(sdt), h_c.astype(sdt), grid.s_w,
                 grid.Cs_w, grid.hc, grid.vtransform).astype(cd)

    u_c = _eval_cubic_like(zq, z_r, cells[..., 0:us],
                           cells[..., HL:HL + us], sigma)
    v_c = _eval_cubic_like(zq, z_r, cells[..., us:2 * us],
                           cells[..., HL + us:HL + 2 * us], sigma)
    w_c = _eval_cubic_like(zq, z_w, cells[..., 2 * us:2 * us + ws],
                           cells[..., HL + 2 * us:HL + 2 * us + ws], sigma)

    u_t = _blend(u_c, wx, wy).astype(dtype)
    v_t = _blend(v_c, wx, wy).astype(dtype)
    w_t = _blend(w_c, wx, wy).astype(dtype)
    zeta_p = _blend(zeta_c, wx, wy).astype(dtype)
    h_p = _blend(h_c, wx, wy).astype(dtype)
    z_r0 = _blend(z_r[..., 0], wx, wy).astype(dtype)

    # near-bottom log layer (cf. physics.advect.find_currents)
    z0m = jnp.asarray(z0m, dtype)
    zab = z + h_p
    ztb = jnp.maximum(z_r0 + h_p, 2.0 * z0m)
    decay = jnp.log(jnp.maximum(zab, z0m) / z0m) / jnp.log(ztb / z0m)
    factor = jnp.where(zab < ztb, jnp.clip(decay, 0.0, 1.0), 1.0)
    return u_t * factor, v_t * factor, w_t, zeta_p, h_p


def zeta_h_packed(grid: Grid, table: StageTable, x, y):
    """Free surface + bathymetry at particles (8-lane mini rows)."""
    dtype = x.dtype
    i, j, fx, fy = locate_rho_ij(grid, x, y)
    nx = grid.nx
    c00 = j.astype(jnp.int32) * nx + i.astype(jnp.int32)
    r0 = table.zh_rows[c00]                  # (N, 8)
    r1 = table.zh_rows[c00 + nx]
    cells = jnp.stack([r0, r1], axis=1).reshape(x.shape[0], 2, 2, 4)
    zeta_p = _blend(cells[..., 0], fx, fy).astype(dtype)
    h_p = _blend(cells[..., 1], fx, fy).astype(dtype)
    return zeta_p, h_p


def rk4_displacement_packed(grid: Grid, tables, x, y, z, sigma: float,
                            z0m: float, idt: float):
    """RK4 advective displacement (dx, dy, dz) from the 3 stage tables
    (t, t+idt/2, t+idt); stages 2 and 3 share the midpoint table."""
    t1, t2, t4 = tables
    dt = jnp.asarray(idt, x.dtype)
    half = 0.5 * dt
    u1, v1, w1, _, _ = find_currents_packed(grid, t1, x, y, z, sigma, z0m)
    u2, v2, w2, _, _ = find_currents_packed(
        grid, t2, x + u1 * half, y + v1 * half, z + w1 * half, sigma, z0m)
    u3, v3, w3, _, _ = find_currents_packed(
        grid, t2, x + u2 * half, y + v2 * half, z + w2 * half, sigma, z0m)
    u4, v4, w4, _, _ = find_currents_packed(
        grid, t4, x + u3 * dt, y + v3 * dt, z + w3 * dt, sigma, z0m)
    sixth = dt / 6.0
    dx = sixth * (u1 + 2.0 * u2 + 2.0 * u3 + u4)
    dy = sixth * (v1 + 2.0 * v2 + 2.0 * v3 + v4)
    dz = sixth * (w1 + 2.0 * w2 + 2.0 * w3 + w4)
    return dx, dy, dz


class ValueTable(NamedTuple):
    """One time-collapsed values-only table (blend-then-fit scheme).

    ``zh_rows`` are the 8-lane pair rows for zeta/h-only lookups.
    """
    full: jax.Array   # (Ny, Nx, nv) value lanes [u|v|w|zeta|h]
    zh_rows: jax.Array  # (Ny*Nx, 8) pair rows [zeta,h,0,0]x2
    t: jax.Array


def collapse_stage_values(grid: Grid, rec: PackedRecords, t) -> ValueTable:
    """Time-collapse to stage time t, values only (no spline fits —
    the consumer fits per particle on the blended profile, the native
    vertical scheme)."""
    us, ws = grid.us, grid.ws
    tt = jnp.asarray(t, rec.times.dtype)
    vals = polintd(rec.tab, rec.times, tt)        # (C, nv)
    nv = n_value_lanes(us, ws)
    zeta = vals[:, nv - 2]
    h = vals[:, nv - 1]
    zh = jnp.stack([zeta, h, jnp.zeros_like(zeta), jnp.zeros_like(zeta)],
                   axis=-1)
    zh_rows = jnp.concatenate([zh, jnp.roll(zh, -1, axis=0)], axis=-1)
    shape = (grid.ny, grid.nx, nv)
    return ValueTable(full=vals.reshape(shape), zh_rows=zh_rows, t=tt)


def _fit_eval_profile(grid: Grid, prof_u, prof_v, prof_w, zeta_p, h_p, z,
                      sigma: float):
    """Blend-then-fit vertical scheme on blended profiles (the native
    reference ordering).

    prof_u/v: (..., us); prof_w: (..., ws); zeta_p/h_p/z: (...,).
    """
    dtype = prof_u.dtype
    sdt = grid.s_rho.dtype
    z_r = _knots(zeta_p.astype(sdt), h_p.astype(sdt), grid.s_rho,
                 grid.Cs_r, grid.hc, grid.vtransform).astype(dtype)
    z_w = _knots(zeta_p.astype(sdt), h_p.astype(sdt), grid.s_w,
                 grid.Cs_w, grid.hc, grid.vtransform).astype(dtype)
    sig = jnp.asarray(sigma, dtype)
    z2u = tension.fit(z_r, prof_u, sig)
    z2v = tension.fit(z_r, prof_v, sig)
    z2w = tension.fit(z_w, prof_w, sig)
    u = _eval_cubic_like(z, z_r, prof_u, z2u, sigma)
    v = _eval_cubic_like(z, z_r, prof_v, z2v, sigma)
    w = _eval_cubic_like(z, z_w, prof_w, z2w, sigma)
    return u, v, w, z_r[..., 0]


def find_currents_collapsed(grid: Grid, vt: ValueTable, x, y, z,
                            sigma: float, z0m: float):
    """Blend-then-fit currents from a values table (XLA path).

    This is the exact reference-ordered vertical scheme on the
    time-collapsed table.
    """
    dtype = x.dtype
    us, ws = grid.us, grid.ws
    nv = n_value_lanes(us, ws)
    i, j, fx, fy = locate_rho_ij(grid, x, y)
    flat = vt.full.reshape(-1, vt.full.shape[-1])
    nx = grid.nx
    c00 = j.astype(jnp.int32) * nx + i.astype(jnp.int32)
    r00 = flat[c00]
    r01 = flat[c00 + 1]
    r10 = flat[c00 + nx]
    r11 = flat[c00 + nx + 1]
    fxd = fx.astype(flat.dtype)[:, None]
    fyd = fy.astype(flat.dtype)[:, None]
    blended = ((r00 * (1 - fxd) + r01 * fxd) * (1 - fyd)
               + (r10 * (1 - fxd) + r11 * fxd) * fyd)      # (N, nv)
    zeta_p = blended[:, nv - 2]
    h_p = blended[:, nv - 1]
    u, v, w, z_r0 = _fit_eval_profile(
        grid, blended[:, 0:us], blended[:, us:2 * us],
        blended[:, 2 * us:2 * us + ws], zeta_p, h_p, z.astype(blended.dtype),
        sigma)
    z0m = jnp.asarray(z0m, dtype)
    u = u.astype(dtype)
    v = v.astype(dtype)
    w = w.astype(dtype)
    zab = z + h_p.astype(dtype)
    ztb = jnp.maximum(z_r0.astype(dtype) + h_p.astype(dtype), 2.0 * z0m)
    decay = jnp.log(jnp.maximum(zab, z0m) / z0m) / jnp.log(ztb / z0m)
    factor = jnp.where(zab < ztb, jnp.clip(decay, 0.0, 1.0), 1.0)
    return u * factor, v * factor, w


def rk4_displacement_collapsed(grid: Grid, vtabs, x, y, z, sigma: float,
                               z0m: float, idt: float):
    """RK4 from 3 values tables, blend-then-fit scheme."""
    t1, t2, t4 = vtabs
    dt = jnp.asarray(idt, x.dtype)
    half = 0.5 * dt
    u1, v1, w1 = find_currents_collapsed(grid, t1, x, y, z, sigma, z0m)
    u2, v2, w2 = find_currents_collapsed(
        grid, t2, x + u1 * half, y + v1 * half, z + w1 * half, sigma, z0m)
    u3, v3, w3 = find_currents_collapsed(
        grid, t2, x + u2 * half, y + v2 * half, z + w2 * half, sigma, z0m)
    u4, v4, w4 = find_currents_collapsed(
        grid, t4, x + u3 * dt, y + v3 * dt, z + w3 * dt, sigma, z0m)
    sixth = dt / 6.0
    return (sixth * (u1 + 2 * u2 + 2 * u3 + u4),
            sixth * (v1 + 2 * v2 + 2 * v3 + v4),
            sixth * (w1 + 2 * w2 + 2 * w3 + w4))


class RecordsFlat(NamedTuple):
    """Record-concatenated flat rows for the table-free collapsed
    scheme: row c = [rec_b lanes | rec_c lanes | rec_f lanes] (3*nv).

    Built ONCE per external step; per internal step the consumer
    gathers 4 corner rows and applies polintd per particle — the exact
    same per-corner arithmetic as collapse_stage_values + gather, with
    no grid-sized work inside the step scan.
    """
    rows: jax.Array    # (C, 3*nv)
    times: jax.Array   # (3,)


def build_records_flat(grid: Grid, rec: PackedRecords) -> RecordsFlat:
    three, C, nv = rec.tab.shape
    rows = jnp.moveaxis(rec.tab, 0, 1).reshape(C, three * nv)
    return RecordsFlat(rows=rows, times=rec.times)


def _polintd_coefs(times, t):
    t0, t1, t2 = times[0], times[1], times[2]
    l0 = (t - t1) * (t - t2) / ((t0 - t1) * (t0 - t2))
    l1 = (t - t0) * (t - t2) / ((t1 - t0) * (t1 - t2))
    l2 = (t - t0) * (t - t1) / ((t2 - t0) * (t2 - t1))
    return l0, l1, l2


def find_currents_records(grid: Grid, rft: RecordsFlat, x, y, z, t,
                          sigma: float, z0m: float):
    """Blend-then-fit currents straight from record rows (gather 4
    corners x 3 records in ONE row gather, polintd per corner, bilinear
    blend, vertical fit) — value-identical to find_currents_collapsed
    on the stage table at time t."""
    dtype = x.dtype
    us, ws = grid.us, grid.ws
    nv = n_value_lanes(us, ws)
    i, j, fx, fy = locate_rho_ij(grid, x, y)
    nx = grid.nx
    c00 = j.astype(jnp.int32) * nx + i.astype(jnp.int32)
    rows = rft.rows
    nt = rows.shape[-1] // 3          # record stride (nv)
    r00 = rows[c00]
    r01 = rows[c00 + 1]
    r10 = rows[c00 + nx]
    r11 = rows[c00 + nx + 1]
    tdt = rft.times.dtype
    l0, l1, l2 = _polintd_coefs(rft.times, jnp.asarray(t, tdt))
    cd = rows.dtype
    l0 = jnp.asarray(l0, cd)
    l1 = jnp.asarray(l1, cd)
    l2 = jnp.asarray(l2, cd)

    def collapse(r):
        return r[:, :nt] * l0 + r[:, nt:2 * nt] * l1 + r[:, 2 * nt:] * l2

    v00 = collapse(r00)
    v01 = collapse(r01)
    v10 = collapse(r10)
    v11 = collapse(r11)
    fxd = fx.astype(cd)[:, None]
    fyd = fy.astype(cd)[:, None]
    blended = ((v00 * (1 - fxd) + v01 * fxd) * (1 - fyd)
               + (v10 * (1 - fxd) + v11 * fxd) * fyd)        # (N, nv)
    zeta_p = blended[:, nv - 2]
    h_p = blended[:, nv - 1]
    u, v, w, z_r0 = _fit_eval_profile(
        grid, blended[:, 0:us], blended[:, us:2 * us],
        blended[:, 2 * us:2 * us + ws], zeta_p, h_p,
        z.astype(blended.dtype), sigma)
    z0m = jnp.asarray(z0m, dtype)
    u = u.astype(dtype)
    v = v.astype(dtype)
    w = w.astype(dtype)
    zab = z + h_p.astype(dtype)
    ztb = jnp.maximum(z_r0.astype(dtype) + h_p.astype(dtype), 2.0 * z0m)
    decay = jnp.log(jnp.maximum(zab, z0m) / z0m) / jnp.log(ztb / z0m)
    factor = jnp.where(zab < ztb, jnp.clip(decay, 0.0, 1.0), 1.0)
    return u * factor, v * factor, w, zeta_p.astype(dtype), h_p.astype(dtype)


def rk4_displacement_records(grid: Grid, rft: RecordsFlat, x, y, z, t,
                             sigma: float, z0m: float, idt: float):
    """RK4 from record rows (table-free collapsed scheme)."""
    dt = jnp.asarray(idt, x.dtype)
    half = 0.5 * dt
    tdt = rft.times.dtype
    tt = jnp.asarray(t, tdt)
    t2 = tt + jnp.asarray(0.5 * idt, tdt)
    t4 = tt + jnp.asarray(idt, tdt)
    u1, v1, w1, _, _ = find_currents_records(grid, rft, x, y, z, tt,
                                             sigma, z0m)
    u2, v2, w2, _, _ = find_currents_records(
        grid, rft, x + u1 * half, y + v1 * half, z + w1 * half, t2,
        sigma, z0m)
    u3, v3, w3, _, _ = find_currents_records(
        grid, rft, x + u2 * half, y + v2 * half, z + w2 * half, t2,
        sigma, z0m)
    u4, v4, w4, _, _ = find_currents_records(
        grid, rft, x + u3 * dt, y + v3 * dt, z + w3 * dt, t4, sigma, z0m)
    sixth = dt / 6.0
    return (sixth * (u1 + 2 * u2 + 2 * u3 + u4),
            sixth * (v1 + 2 * v2 + 2 * v3 + v4),
            sixth * (w1 + 2 * w2 + 2 * w3 + w4))


def zeta_h_records(grid: Grid, rft: RecordsFlat, x, y, t):
    """Free surface + bathymetry at particles from record rows."""
    dtype = x.dtype
    us, ws = grid.us, grid.ws
    nv = n_value_lanes(us, ws)
    i, j, fx, fy = locate_rho_ij(grid, x, y)
    nx = grid.nx
    c00 = j.astype(jnp.int32) * nx + i.astype(jnp.int32)
    rows = rft.rows
    nt = rows.shape[-1] // 3
    tdt = rft.times.dtype
    l0, l1, l2 = _polintd_coefs(rft.times, jnp.asarray(t, tdt))
    cd = rows.dtype
    l0 = jnp.asarray(l0, cd)
    l1 = jnp.asarray(l1, cd)
    l2 = jnp.asarray(l2, cd)

    def zh(r):
        zc = (r[:, nv - 2] * l0 + r[:, nt + nv - 2] * l1
              + r[:, 2 * nt + nv - 2] * l2)
        hc_ = (r[:, nv - 1] * l0 + r[:, nt + nv - 1] * l1
               + r[:, 2 * nt + nv - 1] * l2)
        return zc, hc_

    z00, h00 = zh(rows[c00])
    z01, h01 = zh(rows[c00 + 1])
    z10, h10 = zh(rows[c00 + nx])
    z11, h11 = zh(rows[c00 + nx + 1])
    fxd = fx.astype(cd)
    fyd = fy.astype(cd)
    zeta_p = ((z00 * (1 - fxd) + z01 * fxd) * (1 - fyd)
              + (z10 * (1 - fxd) + z11 * fxd) * fyd)
    h_p = ((h00 * (1 - fxd) + h01 * fxd) * (1 - fyd)
           + (h10 * (1 - fxd) + h11 * fxd) * fyd)
    return zeta_p.astype(dtype), h_p.astype(dtype)


def stage_value_tables(grid: Grid, rec: PackedRecords, t, idt: float):
    """The 3 RK4 stage values tables (blend-then-fit scheme)."""
    tdt = rec.times.dtype
    tt = jnp.asarray(t, tdt)
    return (collapse_stage_values(grid, rec, tt),
            collapse_stage_values(grid, rec,
                                  tt + jnp.asarray(0.5 * idt, tdt)),
            collapse_stage_values(grid, rec, tt + jnp.asarray(idt, tdt)))


def stage_tables(grid: Grid, rec: PackedRecords, t, idt: float,
                 sigma: float):
    """The 3 RK4 stage tables for an internal step starting at t."""
    tdt = rec.times.dtype
    tt = jnp.asarray(t, tdt)
    return (collapse_stage(grid, rec, tt, sigma),
            collapse_stage(grid, rec, tt + jnp.asarray(0.5 * idt, tdt),
                           sigma),
            collapse_stage(grid, rec, tt + jnp.asarray(idt, tdt), sigma))

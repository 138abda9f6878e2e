"""Coastline/land boundary handling: segment extraction + reflection.

Reference: boundary_module.f90 (SURVEY.md SS2.1 #5 [conf: H mechanism]):
``createBounds`` derives the land/sea boundary as chains of line
segments from ``mask_rho`` (tagging open-ocean segments on the grid
edge); ``mbounds``/``ibounds`` test domain membership; and
``intersect_reflect`` finds the first crossing of a particle's
displacement segment and reflects specularly, iterating until no
crossing remains.

Batched redesign (SURVEY.md SS7.3 item 2): the variable-iteration
per-particle walk becomes a fixed-K, fully vectorized pass:

  * host-side precompute (once): boundary segments on the edges of the
    rho-cell lattice + a per-cell bucket of the segment ids within the
    3x3 cell neighborhood (padded to S_max, -1 filled);
  * per internal step: locate each particle's pre-move cell, gather its
    bucket, intersect the displacement segment against all bucket
    segments at once, reflect about the earliest crossing, repeat K
    times (K=4 default) under masks;
  * particles whose endpoint still lies in a land cell after K passes
    get status=ERROR (the reference's ErrorFlag lattice), so no
    particle silently tunnels through a wall;
  * crossing an open-ocean segment exits the particle
    (OUT_OF_DOMAIN) when OpenOceanBoundary is on, else reflects.

Assumes displacement per internal step spans at most ~1 cell (same
regime the reference's adjacent-element search addresses).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import CurvMap, curv_logical, locate

LAND = 0
OPEN = 1


class Boundaries(NamedTuple):
    seg_a: jax.Array        # (S, 2) segment start xy
    seg_b: jax.Array        # (S, 2) segment end xy
    seg_kind: jax.Array     # (S,) LAND or OPEN
    bucket: jax.Array       # (Ny, Nx, S_max) segment ids per rho cell, -1 pad
    x_edges: jax.Array      # (Nx+1,) cell-edge x coordinates (curvilinear:
                            #   uniform bbox raster, settlement pruning only)
    y_edges: jax.Array      # (Ny+1,) cell-edge y coordinates
    water: jax.Array        # (Ny, Nx) mask_rho as int32
    cell_rows: jax.Array    # (Ny*Nx, 8 + 8*S_max) flat per-cell rows:
                            #   lane 0 = water flag; lane 3 = per-cell
                            #   squared displacement-guard radius
                            #   (_cell_max_step2); slot s at 8+8s =
                            #   [ax, ay, bx, by, kind, valid, 0, 0].
                            #   One row gather serves the whole reflect
                            #   pass (instead of 5 element gathers
                            #   through id arrays).
    uniform: bool = False   # static: edge axes exactly uniform (fast locate)
    curv: "CurvMap | None" = None  # curvilinear inverse map (cell_of)
    curv_tol2: "jax.Array | None" = None  # squared inside-mesh residual tol
    max_step2: "jax.Array | None" = None  # GLOBAL (1.5 * min cell
                            #   edge)^2; its presence enables the
                            #   displacement guard, which reflect()
                            #   applies with the per-cell lane-3/4
                            #   radii, see _cell_max_step2

    @property
    def n_segments(self) -> int:
        return self.seg_a.shape[0]


def _cell_edges(axis: np.ndarray) -> np.ndarray:
    mid = 0.5 * (axis[1:] + axis[:-1])
    first = axis[0] - (axis[1] - axis[0]) / 2
    last = axis[-1] + (axis[-1] - axis[-2]) / 2
    return np.concatenate([[first], mid, [last]])


def _psi_mesh(x2: np.ndarray, y2: np.ndarray):
    """Cell-corner (psi) mesh (Ny+1, Nx+1) of a rho-point mesh: interior
    corners average the 4 surrounding rho points; rim corners linearly
    extrapolate (the reference forms the same quad elements from
    adjacent nodes — initGrid, SURVEY.md SS2.1 #3 [conf: H])."""
    def pad(a):
        a = np.pad(a, 1, mode="edge").astype(np.float64)
        a[0, :] = 2 * a[1, :] - a[2, :]
        a[-1, :] = 2 * a[-2, :] - a[-3, :]
        a[:, 0] = 2 * a[:, 1] - a[:, 2]
        a[:, -1] = 2 * a[:, -2] - a[:, -3]
        return a
    xp = pad(x2)
    yp = pad(y2)
    px = 0.25 * (xp[:-1, :-1] + xp[:-1, 1:] + xp[1:, :-1] + xp[1:, 1:])
    py = 0.25 * (yp[:-1, :-1] + yp[:-1, 1:] + yp[1:, :-1] + yp[1:, 1:])
    return px, py


def _assemble(mask: np.ndarray, psi_x: np.ndarray, psi_y: np.ndarray,
              closed_edges: bool, dtype):
    """Segment extraction + 3x3 buckets + packed cell rows from the
    corner mesh (shared by the rectilinear and curvilinear builders)."""
    ny, nx = mask.shape
    seg_a, seg_b, seg_kind = [], [], []
    seg_cells = []  # owning (j, i) of each segment

    edge_kind = LAND if closed_edges else OPEN

    def neighbor_state(j, i):
        if j < 0 or j >= ny or i < 0 or i >= nx:
            return "edge"
        return "water" if mask[j, i] else "land"

    def corner(j, i):
        return (psi_x[j, i], psi_y[j, i])

    for j in range(ny):
        for i in range(nx):
            if not mask[j, i]:
                continue
            # (dj, di, segment endpoints on that side of cell (j,i))
            sides = [
                (0, -1, corner(j, i), corner(j + 1, i)),           # west
                (0, +1, corner(j, i + 1), corner(j + 1, i + 1)),   # east
                (-1, 0, corner(j, i), corner(j, i + 1)),           # south
                (+1, 0, corner(j + 1, i), corner(j + 1, i + 1)),   # north
            ]
            for dj, di, a, b in sides:
                st = neighbor_state(j + dj, i + di)
                if st == "water":
                    continue
                kind = LAND if st == "land" else edge_kind
                seg_a.append(a)
                seg_b.append(b)
                seg_kind.append(kind)
                seg_cells.append((j, i))

    S = len(seg_a)
    if S == 0:
        # no land, fully open rim (can't happen: rim always emits)
        seg_a = [[0.0, 0.0]]
        seg_b = [[0.0, 0.0]]
        seg_kind = [LAND]
        seg_cells = [(0, 0)]
        S = 1

    seg_a = np.asarray(seg_a, dtype)
    seg_b = np.asarray(seg_b, dtype)
    seg_kind = np.asarray(seg_kind, np.int32)

    # per-cell buckets over the 3x3 neighborhood
    cell_lists = [[[] for _ in range(nx)] for _ in range(ny)]
    for sid, (j, i) in enumerate(seg_cells):
        for jj in range(max(0, j - 1), min(ny, j + 2)):
            for ii in range(max(0, i - 1), min(nx, i + 2)):
                cell_lists[jj][ii].append(sid)
    s_max = max(1, max(len(cell_lists[j][i]) for j in range(ny)
                       for i in range(nx)))
    bucket = np.full((ny, nx, s_max), -1, np.int32)
    for j in range(ny):
        for i in range(nx):
            ids = cell_lists[j][i]
            bucket[j, i, :len(ids)] = ids

    # flat per-cell gather rows: [water, 0*7, (ax,ay,bx,by,kind,valid,0,0)*]
    # lanes 3/4 carry the per-cell squared displacement-guard radii
    # (x/y axis; lanes 1/2 are the settlement lanes, written later by
    # ext_step.boundary_rows_table)
    rows = np.zeros((ny * nx, 8 + 8 * s_max), dtype)
    rows[:, 0] = mask.reshape(-1).astype(dtype)
    ms2x, ms2y = _cell_max_step2(psi_x, psi_y)
    rows[:, 3] = ms2x.reshape(-1)
    rows[:, 4] = ms2y.reshape(-1)
    for j in range(ny):
        for i in range(nx):
            for s, sid in enumerate(cell_lists[j][i]):
                o = 8 + 8 * s
                rows[j * nx + i, o:o + 6] = [
                    seg_a[sid, 0], seg_a[sid, 1], seg_b[sid, 0],
                    seg_b[sid, 1], float(seg_kind[sid]), 1.0]
    return seg_a, seg_b, seg_kind, bucket, rows


def _min3x3(a: np.ndarray) -> np.ndarray:
    """3x3-neighborhood minimum (edge-padded)."""
    p = np.pad(a, 1, mode="edge")
    m = a
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            m = np.minimum(m, p[1 + dj:p.shape[0] - 1 + dj,
                               1 + di:p.shape[1] - 1 + di])
    return m


def _cell_max_step2(psi_x: np.ndarray, psi_y: np.ndarray):
    """Per-cell squared displacement-guard radii (ms2x, ms2y), each
    (Ny, Nx).

    The 3x3 segment bucket of a particle's pre-move cell guarantees
    crossing detection only while the path stays within the 3x3 block
    — i.e. PER AXIS, |dx| <= ~1.5 local x-edges AND |dy| <= ~1.5 local
    y-edges — so the guard radii must be LOCAL (3x3-neighborhood min,
    matching the bucket extent).  A global-min isotropic radius (the
    round-4 scheme) falsely froze ordinary displacements in the coarse
    cells of variable-resolution grids, where edge lengths commonly
    vary 10-100x (estuary ROMS grids; advisor finding r4-high), and an
    isotropic local radius would still falsely freeze along the long
    axis of anisotropic cells.

    On non-axis-aligned (curvilinear) meshes the physical displacement
    axes don't align with the logical cell axes, so both lanes fall
    back to the conservative local min edge — still local, just
    isotropic."""
    # edge lengths of the psi (corner) mesh
    hx = np.hypot(np.diff(psi_x, axis=1), np.diff(psi_y, axis=1))  # (ny+1, nx)
    vy = np.hypot(np.diff(psi_x, axis=0), np.diff(psi_y, axis=0))  # (ny, nx+1)
    cell_x = np.minimum(hx[:-1, :], hx[1:, :])                     # (ny, nx)
    cell_y = np.minimum(vy[:, :-1], vy[:, 1:])
    axis_aligned = (np.ptp(psi_x, axis=0).max() < 1e-9 * max(
        1.0, np.abs(psi_x).max())
        and np.ptp(psi_y, axis=1).max() < 1e-9 * max(
            1.0, np.abs(psi_y).max()))
    if axis_aligned:
        rx = 1.5 * _min3x3(cell_x)
        ry = 1.5 * _min3x3(cell_y)
    else:
        r = 1.5 * _min3x3(np.minimum(cell_x, cell_y))
        rx = ry = r
    return (rx * rx).astype(np.float64), (ry * ry).astype(np.float64)


def build_boundaries(mask_rho, x_rho, y_rho, closed_edges=False,
                     dtype=np.float64) -> Boundaries:
    """createBounds analog (host-side numpy, once at init).

    closed_edges: treat the grid rim as land (True) instead of open
    ocean (False).
    """
    mask = np.asarray(mask_rho).astype(np.int32)
    ny, nx = mask.shape
    xe = _cell_edges(np.asarray(x_rho, dtype))
    ye = _cell_edges(np.asarray(y_rho, dtype))
    psi_x = np.broadcast_to(xe[None, :], (ny + 1, nx + 1))
    psi_y = np.broadcast_to(ye[:, None], (ny + 1, nx + 1))
    seg_a, seg_b, seg_kind, bucket, rows = _assemble(
        mask, psi_x, psi_y, closed_edges, dtype)

    from ..grid import _is_uniform
    ms = 1.5 * min(np.diff(xe).min(), np.diff(ye).min())
    # Loose tolerance: coordinates may be f32-rounded images of an
    # exactly-uniform axis; a 1e-4 fractional cell-locate error is
    # harmless here (buckets cover the 3x3 neighborhood, and in_water
    # only needs the containing cell).
    return Boundaries(
        seg_a=jnp.asarray(seg_a), seg_b=jnp.asarray(seg_b),
        seg_kind=jnp.asarray(seg_kind), bucket=jnp.asarray(bucket),
        x_edges=jnp.asarray(xe), y_edges=jnp.asarray(ye),
        water=jnp.asarray(mask), cell_rows=jnp.asarray(rows),
        uniform=_is_uniform(xe, 1e-4) and _is_uniform(ye, 1e-4),
        max_step2=jnp.asarray(ms * ms),
    )


def build_boundaries_curv(mask_rho, x2d, y2d, curv: CurvMap,
                          closed_edges=False,
                          dtype=np.float64) -> Boundaries:
    """createBounds for curvilinear grids: boundary segments are the
    quad-cell edges of the psi (corner) mesh; cell location goes
    through the grid's inverse map (``cell_of`` dispatches on
    ``curv``).  ``x_edges``/``y_edges`` become a uniform bounding-box
    raster (used only as the settlement pruning lattice)."""
    mask = np.asarray(mask_rho).astype(np.int32)
    ny, nx = mask.shape
    x2 = np.asarray(x2d, np.float64)
    y2 = np.asarray(y2d, np.float64)
    psi_x, psi_y = _psi_mesh(x2, y2)
    seg_a, seg_b, seg_kind, bucket, rows = _assemble(
        mask, psi_x, psi_y, closed_edges, dtype)

    xe = np.linspace(psi_x.min(), psi_x.max(), nx + 1)
    ye = np.linspace(psi_y.min(), psi_y.max(), ny + 1)
    # inside-mesh residual tolerance: a quarter of the shortest cell
    # edge (points farther than that from their clamped rim cell are
    # outside the domain)
    ex = np.hypot(np.diff(x2, axis=1), np.diff(y2, axis=1)).min()
    ey = np.hypot(np.diff(x2, axis=0), np.diff(y2, axis=0)).min()
    tol = 0.25 * min(ex, ey)
    ms = 1.5 * min(ex, ey)
    return Boundaries(
        seg_a=jnp.asarray(seg_a), seg_b=jnp.asarray(seg_b),
        seg_kind=jnp.asarray(seg_kind), bucket=jnp.asarray(bucket),
        x_edges=jnp.asarray(xe), y_edges=jnp.asarray(ye),
        water=jnp.asarray(mask), cell_rows=jnp.asarray(rows),
        uniform=True, curv=curv,
        curv_tol2=jnp.asarray(tol * tol),
        max_step2=jnp.asarray(ms * ms),
    )


def cell_of(bounds: Boundaries, x, y):
    """Rho-cell index of a point (clamped to the grid)."""
    if bounds.curv is not None:
        ny, nx = bounds.water.shape
        ti, tj, _ = curv_logical(bounds.curv, nx, ny, x, y)
        # boundary cell (j,i) spans rho logical [i-0.5, i+0.5]
        i = jnp.clip(jnp.floor(ti + 0.5), 0.0, nx - 1.0).astype(jnp.int32)
        j = jnp.clip(jnp.floor(tj + 0.5), 0.0, ny - 1.0).astype(jnp.int32)
        return i, j
    if bounds.uniform:
        xe, ye = bounds.x_edges, bounds.y_edges
        ti = (x - xe[0]) / (xe[1] - xe[0])
        tj = (y - ye[0]) / (ye[1] - ye[0])
        i = jnp.clip(jnp.floor(ti).astype(jnp.int32), 0,
                     bounds.water.shape[1] - 1)
        j = jnp.clip(jnp.floor(tj).astype(jnp.int32), 0,
                     bounds.water.shape[0] - 1)
        return i, j
    i = jnp.clip(jnp.searchsorted(bounds.x_edges, x, side="right") - 1,
                 0, bounds.water.shape[1] - 1)
    j = jnp.clip(jnp.searchsorted(bounds.y_edges, y, side="right") - 1,
                 0, bounds.water.shape[0] - 1)
    return i.astype(jnp.int32), j.astype(jnp.int32)


def in_water(bounds: Boundaries, x, y):
    """mbounds analog: is the point in a water cell of the domain?"""
    nx = bounds.water.shape[1]
    if bounds.curv is not None:
        ny = bounds.water.shape[0]
        ti, tj, r2 = curv_logical(bounds.curv, nx, ny, x, y)
        i = jnp.clip(jnp.floor(ti + 0.5), 0.0, nx - 1.0).astype(jnp.int32)
        j = jnp.clip(jnp.floor(tj + 0.5), 0.0, ny - 1.0).astype(jnp.int32)
        inside = r2 <= bounds.curv_tol2
        wet = bounds.cell_rows[j * nx + i, 0] > 0.5
        return inside & wet
    i, j = cell_of(bounds, x, y)
    inside = ((x >= bounds.x_edges[0]) & (x <= bounds.x_edges[-1])
              & (y >= bounds.y_edges[0]) & (y <= bounds.y_edges[-1]))
    wet = bounds.cell_rows[j * nx + i, 0] > 0.5
    return inside & wet


def reflect(bounds: Boundaries, x0, y0, x1, y1, open_exits: bool,
            n_iter: int = 4, eps: float = 1e-6):
    """intersect_reflect analog, fully vectorized.

    Returns (x, y, hit_land_count, exited, stuck):
      x, y            final positions after up to n_iter reflections
      hit_land_count  number of land-segment bounces (TrackCollisions)
      exited          crossed an open segment (only if open_exits)
      stuck           endpoint still in a land cell after n_iter passes
                      (caller maps this to status=ERROR)
    """
    dtype = x0.dtype
    n = x0.shape[0]
    hit_land = jnp.zeros(n, jnp.int32)
    exited = jnp.zeros(n, bool)
    px0, py0, px1, py1 = x0, y0, x1, y1

    nx_cells = bounds.water.shape[1]
    s_max = (bounds.cell_rows.shape[1] - 8) // 8
    ms2 = None

    for it in range(n_iter):
        ci, cj = cell_of(bounds, px0, py0)
        rows = bounds.cell_rows[cj * nx_cells + ci]     # (N, 8+8*S_max)
        if it == 0:
            # per-cell displacement-guard radii of the PRE-move cell
            # (lanes 3/4, _cell_max_step2) — used by the guard below
            ms2 = (rows[:, 3].astype(dtype), rows[:, 4].astype(dtype))
        slots = rows[:, 8:].reshape(-1, s_max, 8).astype(dtype)
        ax = slots[..., 0]
        ay = slots[..., 1]
        kind = slots[..., 4].astype(jnp.int32)
        valid = slots[..., 5] > 0.5

        dx = (px1 - px0)[:, None]
        dy = (py1 - py0)[:, None]
        ex = slots[..., 2] - ax
        ey = slots[..., 3] - ay
        apx = ax - px0[:, None]
        apy = ay - py0[:, None]
        denom = dx * ey - dy * ex
        denom_safe = jnp.where(jnp.abs(denom) < 1e-30,
                               jnp.asarray(1e-30, dtype), denom)
        tp = (apx * ey - apy * ex) / denom_safe         # along particle path
        ts = (apx * dy - apy * dx) / denom_safe         # along segment
        crossing = (valid & (jnp.abs(denom) > 1e-30)
                    & (tp > 0.0) & (tp <= 1.0)
                    & (ts >= 0.0) & (ts <= 1.0))
        tp_masked = jnp.where(crossing, tp, jnp.asarray(jnp.inf, dtype))
        first = jnp.argmin(tp_masked, axis=1)
        # select the first-crossing segment via a one-hot reduction
        # (see ltjax.tension._gather_intervals)
        onehot_b = first[:, None] == jnp.arange(tp.shape[1])
        onehot = onehot_b.astype(dtype)
        any_cross = jnp.any(crossing & onehot_b, axis=1)
        act = any_cross & ~exited

        tpf = jnp.sum(jnp.where(onehot_b, tp_masked, 0.0), axis=1)
        tpf = jnp.where(act, tpf, 0.0)
        exf = jnp.sum(ex * onehot, axis=1)
        eyf = jnp.sum(ey * onehot, axis=1)
        kindf = jnp.sum(kind * onehot.astype(kind.dtype), axis=1)

        ix = px0 + tpf * (px1 - px0)                    # intersection point
        iy = py0 + tpf * (py1 - py0)
        rx = px1 - ix                                   # remaining segment
        ry = py1 - iy
        elen2 = jnp.maximum(exf * exf + eyf * eyf,
                            jnp.asarray(1e-30, dtype))
        proj = (rx * exf + ry * eyf) / elen2
        rrx = 2.0 * proj * exf - rx                     # specular reflection
        rry = 2.0 * proj * eyf - ry

        is_open_hit = act & (kindf == OPEN)
        if open_exits:
            newly_exited = is_open_hit
            do_reflect = act & (kindf == LAND)
        else:
            newly_exited = jnp.zeros_like(is_open_hit)
            do_reflect = act

        # nudge the restart point off the wall to avoid re-hitting it
        nrm = jnp.sqrt(jnp.maximum(rrx * rrx + rry * rry,
                                   jnp.asarray(1e-30, dtype)))
        nx0 = ix + eps * rrx / nrm
        ny0 = iy + eps * rry / nrm

        px0 = jnp.where(do_reflect, nx0, px0)
        py0 = jnp.where(do_reflect, ny0, py0)
        px1 = jnp.where(do_reflect, ix + rrx, px1)
        py1 = jnp.where(do_reflect, iy + rry, py1)
        # exited particles stop at the open-boundary crossing point
        px1 = jnp.where(newly_exited, ix, px1)
        py1 = jnp.where(newly_exited, iy, py1)
        hit_land = hit_land + (do_reflect & (kindf == LAND)).astype(jnp.int32)
        exited = exited | newly_exited

    stuck = ~exited & ~in_water(bounds, px1, py1)
    # --- tunnel guard ----------------------------------------------------
    # The per-cell buckets cover the 3x3 neighborhood of the pre-move
    # cell, which guarantees crossing detection only for displacements
    # up to ~1 cell (docstring assumption; same regime the reference's
    # adjacent-element search addresses).  A faster particle can step
    # clean over a thin land spit whose segments are not in its bucket:
    # both endpoints in water, no crossing ever seen.  Catch it by
    # midpoint test on the UNREFLECTED straight path of particles that
    # had no boundary interaction at all (for interacting particles the
    # net chord legitimately passes outside water).  Midpoint-on-land =>
    # stuck => status ERROR upstream: loud, never silent.
    no_interact = (hit_land == 0) & ~exited & ~stuck
    xm = 0.5 * (x0 + px1)
    ym = 0.5 * (y0 + py1)
    tunneled = no_interact & ~in_water(bounds, xm, ym)
    stuck = stuck | tunneled
    # --- max-displacement guard ------------------------------------------
    # The midpoint test above still misses a >=2-cell jump across a thin
    # spit with BOTH midpoint and endpoint in water.  The 3x3 bucket
    # guarantees crossing detection only within ~1.5 LOCAL cells of the
    # pre-move cell, so any longer single-step displacement is flagged
    # stuck (-> ERROR upstream): loud, never a silent tunnel.  The
    # thresholds are the PRE-MOVE CELL's own PER-AXIS radii (cell_rows
    # lanes 3/4), not the global minimum — on variable-resolution grids
    # a coarse offshore cell legitimately hosts displacements far
    # beyond the finest river cell's radius (advisor finding r4-high).
    # Runs whose flow legitimately moves particles further per internal
    # step than 1.5 local cells violate the bucket assumption and must
    # reduce idt.
    if bounds.max_step2 is not None:
        ms2x, ms2y = ms2
        over = (((x1 - x0) ** 2 > ms2x) | ((y1 - y0) ** 2 > ms2y))
        stuck = stuck | (~exited & over)
    return px1, py1, hit_land, exited, stuck


def dump_boundaries(bounds: Boundaries, outpath: str,
                    to_lonlat=None) -> None:
    """Reference parity: ``output_xyBounds``/``output_llBounds``
    boundary dumps (boundary_module.f90 [conf: M], enabled by the
    ``BoundaryBLNs`` flag) — one CSV row per segment endpoint pair with
    its kind, for eyeballing createBounds output.

    ``to_lonlat(x, y) -> (lon, lat)`` additionally writes the
    geographic version.
    """
    import os

    os.makedirs(outpath, exist_ok=True)
    a = np.asarray(bounds.seg_a)
    b = np.asarray(bounds.seg_b)
    kind = np.asarray(bounds.seg_kind)
    with open(os.path.join(outpath, "xyBounds.csv"), "w") as f:
        f.write("ax,ay,bx,by,kind\n")
        for s in range(a.shape[0]):
            f.write(f"{a[s, 0]:.3f},{a[s, 1]:.3f},{b[s, 0]:.3f},"
                    f"{b[s, 1]:.3f},{'OPEN' if kind[s] else 'LAND'}\n")
    if to_lonlat is not None:
        alon, alat = to_lonlat(a[:, 0], a[:, 1])
        blon, blat = to_lonlat(b[:, 0], b[:, 1])
        with open(os.path.join(outpath, "llBounds.csv"), "w") as f:
            f.write("alon,alat,blon,blat,kind\n")
            for s in range(a.shape[0]):
                f.write(f"{alon[s]:.8f},{alat[s]:.8f},{blon[s]:.8f},"
                        f"{blat[s]:.8f},{'OPEN' if kind[s] else 'LAND'}\n")


def reflect_vertical(z, zeta_p, h_p):
    """Surface/bottom specular reflection (SURVEY.md SS3.2 [conf: M]).

    z > zeta  ->  2*zeta - z ;  z < -h  ->  -2h - z ; then clamp.
    Returns (z', hit_surface, hit_bottom).
    """
    above = z > zeta_p
    z1 = jnp.where(above, 2.0 * zeta_p - z, z)
    below = z1 < -h_p
    z2 = jnp.where(below, -2.0 * h_p - z1, z1)
    z3 = jnp.clip(z2, -h_p, zeta_p)
    return z3, above, below

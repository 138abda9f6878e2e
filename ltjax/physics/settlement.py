"""Habitat-polygon settlement.

Reference: settlement_module.f90 + point_in_polygon_module.f90
(SURVEY.md SS2.1 #9/#10 [conf: H feature, M details]): ``initSettlement``
loads habitat polygons and hole polygons from CSV and maps them to grid
elements to prune the tests; ``testSettlement`` settles a particle that
is older than ``pediage`` and inside a habitat polygon (and not inside
a hole), freezing it and recording the polygon id.

Batched redesign: polygons are padded vertex arrays; a host-side
raster pass assigns each rho cell its candidate polygon ids (padded,
-1 filled) from bounding-box overlap, so the device-side test is a
fixed-shape gather + vectorized ray-casting point-in-polygon over
(candidates x vertices) — no per-particle polygon loop.

Polygon CSV format (reference ``habitatfile``/``holefile`` [conf: M]):
rows of ``lon, lat, polyid`` (vertices of each polygon contiguous; the
User's Guide's column order is honored loosely — a 3-column file with
the id in the last column).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class Polygons(NamedTuple):
    verts_x: jax.Array    # (P, Vmax) padded with the last vertex
    verts_y: jax.Array    # (P, Vmax)
    nverts: jax.Array     # (P,)
    poly_id: jax.Array    # (P,) external polygon ids
    cell_cands: jax.Array  # (Ny, Nx, Cmax) candidate polygon rows, -1 pad

    @property
    def n_polys(self) -> int:
        return self.verts_x.shape[0]


def read_polygon_csv(path: str):
    """Parse a polygon CSV into [(poly_id, (V,2) vertices), ...]."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p for p in line.replace(",", " ").split() if p]
            if len(parts) < 3:
                continue
            rows.append((float(parts[0]), float(parts[1]), int(float(parts[2]))))
    polys = []
    cur_id, cur = None, []
    for x, y, pid in rows:
        if cur_id is None or pid != cur_id:
            if cur:
                polys.append((cur_id, np.asarray(cur)))
            cur_id, cur = pid, []
        cur.append((x, y))
    if cur:
        polys.append((cur_id, np.asarray(cur)))
    return polys


def build_polygons(polys, x_edges, y_edges, dtype=np.float64) -> Optional[Polygons]:
    """Pad polygons + rasterize candidate lists onto the rho-cell grid.

    polys: [(poly_id, (V, 2) xy-vertex array), ...] in *internal meter*
    coordinates (callers project lon/lat first).
    """
    if not polys:
        return None
    P = len(polys)
    vmax = max(len(v) for _, v in polys)
    vx = np.zeros((P, vmax), dtype)
    vy = np.zeros((P, vmax), dtype)
    nv = np.zeros(P, np.int32)
    pid = np.zeros(P, np.int32)
    for k, (i, v) in enumerate(polys):
        n = len(v)
        vx[k, :n] = v[:, 0]
        vy[k, :n] = v[:, 1]
        vx[k, n:] = v[-1, 0]   # pad by repeating last vertex (degenerate
        vy[k, n:] = v[-1, 1]   # edges contribute no crossings)
        nv[k] = n
        pid[k] = i

    ny = len(y_edges) - 1
    nx = len(x_edges) - 1
    cell_lists = [[[] for _ in range(nx)] for _ in range(ny)]
    xe = np.asarray(x_edges)
    ye = np.asarray(y_edges)
    for k in range(P):
        x0, x1 = vx[k].min(), vx[k].max()
        y0, y1 = vy[k].min(), vy[k].max()
        i0 = max(0, int(np.searchsorted(xe, x0, "right")) - 1)
        i1 = min(nx - 1, int(np.searchsorted(xe, x1, "right")) - 1)
        j0 = max(0, int(np.searchsorted(ye, y0, "right")) - 1)
        j1 = min(ny - 1, int(np.searchsorted(ye, y1, "right")) - 1)
        for j in range(j0, j1 + 1):
            for i in range(i0, i1 + 1):
                cell_lists[j][i].append(k)
    cmax = max(1, max(len(cell_lists[j][i]) for j in range(ny)
                      for i in range(nx)))
    cands = np.full((ny, nx, cmax), -1, np.int32)
    for j in range(ny):
        for i in range(nx):
            ids = cell_lists[j][i]
            cands[j, i, :len(ids)] = ids

    return Polygons(verts_x=jnp.asarray(vx), verts_y=jnp.asarray(vy),
                    nverts=jnp.asarray(nv), poly_id=jnp.asarray(pid),
                    cell_cands=jnp.asarray(cands))


def point_in_polygon(vx, vy, px, py):
    """Vectorized ray-casting test.

    vx, vy: (..., Vmax) padded vertex loops; px, py: (...,) points.
    Returns boolean (...,).  Padding by repeated vertices is safe: a
    degenerate edge has y1 == y2 and contributes no crossing.
    """
    x1 = vx
    y1 = vy
    x2 = jnp.roll(vx, -1, axis=-1)
    y2 = jnp.roll(vy, -1, axis=-1)
    p = px[..., None]
    q = py[..., None]
    straddles = (y1 > q) != (y2 > q)
    dy = jnp.where(straddles, y2 - y1, 1.0)
    x_cross = x1 + (q - y1) * (x2 - x1) / dy
    crossings = jnp.sum(straddles & (p < x_cross), axis=-1)
    return (crossings % 2) == 1


def _locate_edges(edges, v, nmax: int, uniform: bool):
    """Cell index of v in an edge lattice.

    uniform=True uses arithmetic locate instead of a per-query
    binary search (same rule as boundary.cell_of).
    """
    if uniform:
        t = (v - edges[0]) / (edges[1] - edges[0])
        return jnp.clip(jnp.floor(t).astype(jnp.int32), 0, nmax - 1)
    return jnp.clip(jnp.searchsorted(edges, v, side="right") - 1,
                    0, nmax - 1).astype(jnp.int32)


def test_settlement(polys: Optional[Polygons], holes: Optional[Polygons],
                    x_edges, y_edges, x, y, eligible,
                    uniform: bool = False):
    """testSettlement analog for the whole batch.

    Returns (settles, poly_id): settles[i] True if particle i is inside
    a habitat polygon (and not inside any hole) and eligible[i].
    """
    if polys is None:
        n = x.shape[0]
        return jnp.zeros(n, bool), jnp.full(n, -1, jnp.int32)
    i = _locate_edges(x_edges, x, polys.cell_cands.shape[1], uniform)
    j = _locate_edges(y_edges, y, polys.cell_cands.shape[0], uniform)
    cands = polys.cell_cands[j, i]                 # (N, Cmax)
    valid = cands >= 0
    ck = jnp.maximum(cands, 0)
    inside = point_in_polygon(polys.verts_x[ck], polys.verts_y[ck],
                              x[:, None], y[:, None]) & valid  # (N, Cmax)
    hit_any = jnp.any(inside, axis=1)
    first = jnp.argmax(inside, axis=1)
    pid = jnp.where(hit_any,
                    polys.poly_id[ck[jnp.arange(x.shape[0]), first]], -1)

    if holes is not None:
        hi = _locate_edges(x_edges, x, holes.cell_cands.shape[1], uniform)
        hj = _locate_edges(y_edges, y, holes.cell_cands.shape[0], uniform)
        hc = holes.cell_cands[hj, hi]
        hvalid = hc >= 0
        hk = jnp.maximum(hc, 0)
        in_hole = jnp.any(
            point_in_polygon(holes.verts_x[hk], holes.verts_y[hk],
                             x[:, None], y[:, None]) & hvalid, axis=1)
        hit_any = hit_any & ~in_hole
    settles = hit_any & eligible
    return settles, jnp.where(settles, pid, -1).astype(jnp.int32)

"""Multi-chip execution: particle data-parallelism x eta-strip domain
tiles with halo exchange and particle migration.

Reference: NONE — LTRANS v2b is a serial Fortran program (SURVEY.md
SS2.2 [conf: H]).  This layer is the new first-class parallelism design
specified by SURVEY.md SS2.2/SS7 and BASELINE.json config 5:

  * mesh axes ``("dp", "tile")`` — ``dp`` shards the particle batch
    (pure data parallelism; particles are independent given fields),
    ``tile`` decomposes the ocean domain into eta (y) strips.
  * velocity/zeta/Aks fields are sharded over ``tile`` along their eta
    axis; each step starts with a **halo exchange** (``lax.ppermute``
    of the strip edges inside one ``shard_map``) so every tile can
    interpolate across its strip boundary.
  * particles live in fixed-capacity per-(dp, tile) slot buffers; after
    each external step, particles whose y crossed strip ownership are
    **migrated** with ``lax.all_to_all`` (fixed per-destination
    capacity; overflow is flagged, never silently lost in transit).
  * collectives go to the device interconnect (NCCL on GPUs);
    everything (exchange + internal-step scan + migration) is one
    compiled ``shard_map`` per external step.

Single-device equivalence: the tiled step reproduces the unsharded step
exactly (same gathers, same clamp semantics) because per-tile grids are
edge-replicated continuations of the global grid — see
tests/test_shard.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from . import packed as _pk
from . import state as st
from .config import Config
from .fields import FieldSet
from .grid import Grid
from .step import StepContext, internal_step, mode_flags

EMPTY = -1  # status code for an unoccupied particle slot


class TileSpec(NamedTuple):
    """Static decomposition parameters."""
    ndp: int          # particle-DP mesh axis size
    ntiles: int       # domain-tile mesh axis size (eta strips)
    halo: int         # halo rows per side (must cover max displacement
                      #   per external step + the interpolation stencil)
    ny_loc: int       # owned rho rows per tile (global pad = ntiles*ny_loc)
    cap: int          # particle slots per (dp, tile) shard
    mig_cap: int      # migration slots per destination tile

    @property
    def ny_pad(self) -> int:
        return self.ntiles * self.ny_loc

    @property
    def ny_ext(self) -> int:
        return self.ny_loc + 2 * self.halo


class TiledStatic(NamedTuple):
    """Per-tile static grid data (leading axis = tile, sharded P('tile'))
    plus replicated tile-ownership edges."""
    y_rho_t: jax.Array     # (ntiles, ny_ext)
    y_v_t: jax.Array       # (ntiles, ny_ext)
    h_t: jax.Array         # (ntiles, ny_ext, nx)
    mask_rho_t: jax.Array  # (ntiles, ny_ext, nx)
    mask_u_t: jax.Array    # (ntiles, ny_ext, nx-1)
    mask_v_t: jax.Array    # (ntiles, ny_ext, nx)
    tile_edges: jax.Array  # (ntiles+1,) y ownership boundaries (replicated)


def make_spec(cfg: Config, ny: int, numpar: int, ndp: int, ntiles: int,
              halo: int = 4, slack: float = 1.5) -> TileSpec:
    ny_loc = -(-ny // ntiles)
    cap = max(8, int(np.ceil(numpar * slack / (ndp * ntiles))))
    mig_cap = max(8, cap // 4)
    return TileSpec(ndp=ndp, ntiles=ntiles, halo=halo, ny_loc=ny_loc,
                    cap=cap, mig_cap=mig_cap)


def halo_rows_needed(v_max: float, dt: float, dy_min: float) -> int:
    """Halo rows covering the worst-case displacement in one external
    step (particles only migrate between external steps, so within one
    they may interpolate up to v_max*dt past their strip) plus one row
    of interpolation stencil."""
    return int(np.ceil(v_max * dt / dy_min)) + 1


def make_mesh(spec: TileSpec, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = spec.ndp * spec.ntiles
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    arr = np.asarray(devices[:n]).reshape(spec.ndp, spec.ntiles)
    return Mesh(arr, ("dp", "tile"))


# ---------------------------------------------------------------------------
# eta padding / per-tile static-grid construction (host-side numpy, once)
# ---------------------------------------------------------------------------

def _extend_axis(ax: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Continue a strictly increasing axis by lo/hi rows of edge spacing."""
    d0 = ax[1] - ax[0]
    d1 = ax[-1] - ax[-2]
    below = ax[0] + d0 * np.arange(-lo, 0)
    above = ax[-1] + d1 * np.arange(1, hi + 1)
    return np.concatenate([below, ax, above])


def pad_eta(arr: np.ndarray, eta_axis: int, ny_pad: int) -> np.ndarray:
    """Edge-replicate an array's eta axis up to ny_pad rows.

    Edge replication (not zeros) preserves the unsharded engine's
    clamp-at-rim interpolation semantics exactly.
    """
    n = arr.shape[eta_axis]
    if n >= ny_pad:
        return arr
    pads = [(0, 0)] * arr.ndim
    pads[eta_axis] = (0, ny_pad - n)
    return np.pad(arr, pads, mode="edge")


def build_tiled_static(grid: Grid, spec: TileSpec) -> TiledStatic:
    """Precompute per-tile extended grid strips (numpy, once at init)."""
    H, ny_loc, ntiles = spec.halo, spec.ny_loc, spec.ntiles
    ny_pad = spec.ny_pad
    dtype = np.asarray(grid.y_rho).dtype

    y_pad = pad_eta(np.asarray(grid.y_rho), 0, ny_pad)
    # keep the padded axis strictly increasing (pad_eta replicates the
    # last coordinate; continue it uniformly instead)
    ny = grid.ny
    if ny_pad > ny:
        d = y_pad[ny - 1] - y_pad[ny - 2]
        y_pad[ny:] = y_pad[ny - 1] + d * np.arange(1, ny_pad - ny + 1)
    y_ext = _extend_axis(y_pad, H, H)                       # (ny_pad+2H,)

    # v axis: midpoints of the padded rho axis, padded to ny_pad rows,
    # then extended — aligned with the identically padded v field rows.
    y_v = 0.5 * (y_pad[1:] + y_pad[:-1])                    # (ny_pad-1,)
    y_v_pad = np.concatenate([y_v, [y_v[-1] + (y_v[-1] - y_v[-2])]])
    y_v_ext = _extend_axis(y_v_pad, H, H)

    h_pad = pad_eta(np.asarray(grid.h), 0, ny_pad)
    h_ext = np.pad(h_pad, ((H, H), (0, 0)), mode="edge")
    mr_pad = pad_eta(np.asarray(grid.mask_rho), 0, ny_pad)
    mr_ext = np.pad(mr_pad, ((H, H), (0, 0)), mode="edge")
    mu_pad = pad_eta(np.asarray(grid.mask_u), 0, ny_pad)
    mu_ext = np.pad(mu_pad, ((H, H), (0, 0)), mode="edge")
    mv_pad = pad_eta(np.asarray(grid.mask_v), 0, ny_pad)
    mv_ext = np.pad(mv_pad, ((H, H), (0, 0)), mode="edge")

    ny_ext = spec.ny_ext

    def strips(a):
        return np.stack([a[t * ny_loc: t * ny_loc + ny_ext]
                         for t in range(ntiles)])

    # ownership edges: cell-edge midpoints at strip boundaries; the
    # outermost edges are +-inf so clipping covers the whole real line
    edges = np.empty(ntiles + 1, dtype)
    edges[0] = -np.inf
    edges[-1] = np.inf
    for t in range(1, ntiles):
        r = t * ny_loc
        edges[t] = 0.5 * (y_pad[r - 1] + y_pad[r])

    return TiledStatic(
        y_rho_t=jnp.asarray(strips(y_ext)),
        y_v_t=jnp.asarray(strips(y_v_ext)),
        h_t=jnp.asarray(strips(h_ext)),
        mask_rho_t=jnp.asarray(strips(mr_ext).astype(np.int32)),
        mask_u_t=jnp.asarray(strips(mu_ext).astype(np.int32)),
        mask_v_t=jnp.asarray(strips(mv_ext).astype(np.int32)),
        tile_edges=jnp.asarray(edges),
    )


def process_tile_rows(mesh: Mesh, spec: TileSpec, ny: int):
    """Global rho-row range [lo, hi) owned by THIS process's tiles.

    Feeds RomsSeries(eta_slice=...) so each host reads only its
    hyperslab of the history files (SURVEY.md SS5.8); halo rows arrive
    via the in-step ppermute exchange, not from disk.
    """
    me = jax.process_index()
    dev = mesh.devices
    cols = sorted({c for r in range(dev.shape[0])
                   for c in range(dev.shape[1])
                   if dev[r, c].process_index == me})
    lo = min(cols) * spec.ny_loc
    hi = min((max(cols) + 1) * spec.ny_loc, ny)
    return lo, hi


def globalize_fields(fs_local: FieldSet, mesh: Mesh,
                     spec: TileSpec) -> FieldSet:
    """Assemble the logically-global sharded FieldSet from per-process
    local slabs (jax.make_array_from_process_local_data).

    ``fs_local`` leaves must already be eta-padded to this process's
    owned row count (a multiple of ny_loc); times is replicated.
    Single-process runs never need this (the whole padded field is
    local) — it is the multi-host assembly step of the per-host
    hyperslab input pipeline.
    """
    from jax.sharding import NamedSharding

    ny_pad = spec.ny_pad

    def glob(a, pspec):
        a = np.asarray(a)
        gshape = a.shape[:1] + (ny_pad,) + a.shape[2:]
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, pspec), a, gshape)

    f3 = P(None, "tile", None, None)
    return FieldSet(
        zeta=glob(fs_local.zeta, P(None, "tile", None)),
        u=glob(fs_local.u, f3), v=glob(fs_local.v, f3),
        w=glob(fs_local.w, f3), aks=glob(fs_local.aks, f3),
        salt=glob(fs_local.salt, f3), temp=glob(fs_local.temp, f3),
        times=jax.make_array_from_process_local_data(
            NamedSharding(mesh, P()), np.asarray(fs_local.times),
            np.asarray(fs_local.times).shape))


def pad_fieldset_eta(fs: FieldSet, ny_pad: int) -> FieldSet:
    """Edge-replicate every field's eta axis (uniformly axis 1 in the
    K-last layout) to ny_pad rows (v included: its ny-1 rows pad
    identically, matching the per-tile v axis).

    Device-side (jnp.pad edge mode): the per-step driver calls this on
    already-resident arrays; a host round-trip here would serialize the
    input pipeline.
    """

    def pad(a):
        a = jnp.asarray(a)
        n = a.shape[1]
        if n >= ny_pad:
            return a
        pads = [(0, 0)] * a.ndim
        pads[1] = (0, ny_pad - n)
        return jnp.pad(a, pads, mode="edge")

    return FieldSet(zeta=pad(fs.zeta), u=pad(fs.u), v=pad(fs.v),
                    w=pad(fs.w), aks=pad(fs.aks), salt=pad(fs.salt),
                    temp=pad(fs.temp), times=jnp.asarray(fs.times))


# ---------------------------------------------------------------------------
# in-shard helpers
# ---------------------------------------------------------------------------

def _halo_extend(arr, halo: int, ntiles: int, axis_name: str):
    """Attach halo rows from eta-neighbor tiles via ppermute.

    arr: local (3, ny_loc, ...) strip — eta is axis 1 for every field
    leaf in the K-last layout.  Domain-edge tiles fill their missing
    halo with edge-row replication, reproducing the unsharded
    clamp-at-rim semantics.
    """
    if ntiles == 1:
        lo = jnp.repeat(arr[:, :1], halo, axis=1)
        hi = jnp.repeat(arr[:, -1:], halo, axis=1)
        return jnp.concatenate([lo, arr, hi], axis=1)
    top = arr[:, -halo:]
    bot = arr[:, :halo]
    up = lax.ppermute(top, axis_name,
                      [(t, t + 1) for t in range(ntiles - 1)])
    dn = lax.ppermute(bot, axis_name,
                      [(t + 1, t) for t in range(ntiles - 1)])
    t_idx = lax.axis_index(axis_name)
    edge_lo = jnp.repeat(arr[:, :1], halo, axis=1)
    edge_hi = jnp.repeat(arr[:, -1:], halo, axis=1)
    halo_lo = jnp.where(t_idx == 0, edge_lo, up)
    halo_hi = jnp.where(t_idx == ntiles - 1, edge_hi, dn)
    return jnp.concatenate([halo_lo, arr, halo_hi], axis=1)


def _sentinel(p: st.Particles, x_mid, y_mid) -> st.Particles:
    """An EMPTY slot located safely mid-tile (keeps locate() benign)."""
    dtype = p.x.dtype
    return st.Particles(
        x=jnp.asarray(x_mid, dtype), y=jnp.asarray(y_mid, dtype),
        z=jnp.asarray(-1.0, dtype), dob=jnp.asarray(0.0, dtype),
        age=jnp.asarray(0.0, dtype),
        status=jnp.asarray(EMPTY, jnp.int32),
        pid=jnp.asarray(-1, jnp.int32),
        settle_poly=jnp.asarray(-1, jnp.int32),
        hit_land=jnp.asarray(0, jnp.int32),
        hit_bottom=jnp.asarray(0, jnp.int32),
        salt=jnp.asarray(0.0, dtype), temp=jnp.asarray(0.0, dtype))


def _take(p: st.Particles, idx, sent: st.Particles) -> st.Particles:
    """Gather slots by index; out-of-range indices yield the sentinel."""
    n = p.x.shape[0]

    def g(a, s):
        ap = jnp.concatenate([a, jnp.broadcast_to(
            jnp.asarray(s, a.dtype), (1,) + a.shape[1:])], 0)
        return ap[jnp.minimum(idx, n)]

    return jax.tree.map(g, p, sent)


def _migrate(p: st.Particles, spec: TileSpec, tile_edges, x_mid, y_mid,
             axis_name: str):
    """Route particles to their owning tile with a fixed-capacity
    all_to_all (SURVEY.md SS2.2 'sparse all-to-all migration').

    Leavers beyond mig_cap stay local flagged ERROR; merge overflow
    beyond cap is dropped and counted.  Returns (p', overflow_count).
    """
    ntiles = spec.ntiles
    sent = _sentinel(p, x_mid, y_mid)
    my_t = lax.axis_index(axis_name)
    valid = p.status != EMPTY
    dest = jnp.clip(
        jnp.searchsorted(tile_edges, p.y, side="right") - 1, 0, ntiles - 1
    ).astype(jnp.int32)
    dest = jnp.where(valid, dest, my_t)
    leave = valid & (dest != my_t)

    n = p.x.shape[0]
    selected = jnp.zeros(n, bool)
    sends = []
    for t in range(ntiles):
        m = leave & (dest == t) & (my_t != t)
        idx = jnp.nonzero(m, size=spec.mig_cap, fill_value=n)[0]
        sends.append(_take(p, idx, sent))
        sel_t = jnp.zeros(n + 1, bool).at[idx].set(True)[:n]
        selected = selected | sel_t
    send = jax.tree.map(lambda *xs: jnp.stack(xs), *sends)
    recv = jax.tree.map(
        lambda a: lax.all_to_all(a, axis_name, 0, 0), send)

    # overflowed leavers stay local, flagged ERROR (never silently lost)
    overflow_leave = leave & ~selected
    keep = (valid & ~leave) | overflow_leave
    status_kept = jnp.where(overflow_leave, st.ERROR, p.status)
    p_kept = p._replace(status=status_kept)
    kidx = jnp.nonzero(keep, size=n, fill_value=n)[0]
    kept = _take(p_kept, kidx, sent)

    cand = jax.tree.map(
        lambda k, r: jnp.concatenate(
            [k, r.reshape((-1,) + r.shape[2:])], 0), kept, recv)
    cvalid = cand.status != EMPTY
    fidx = jnp.nonzero(cvalid, size=n, fill_value=cand.x.shape[0])[0]
    out = _take(cand, fidx, sent)
    n_drop = (jnp.sum(cvalid) - jnp.sum(out.status != EMPTY)
              + jnp.sum(overflow_leave))
    return out, n_drop.astype(jnp.int32)


# ---------------------------------------------------------------------------
# the tiled external step
# ---------------------------------------------------------------------------

def make_tiled_step(ctx: StepContext, cfg: Config, spec: TileSpec,
                    tiled: TiledStatic, mesh: Mesh, base_key):
    """Compile one multi-device external step.

    (particles (ndp, ntiles, cap), padded 3-record FieldSet, t0,
    ext_idx) -> (particles', overflow (ndp, ntiles))

    One shard_map: halo-exchange fields -> advance the local particle
    slots one external step with a per-tile local Grid -> migrate.
    """
    grid = ctx.grid
    n_int = cfg.internal_steps
    idt = float(cfg.idt)
    fast = mode_flags(cfg) == "fast"

    fs_specs = FieldSet(
        zeta=P(None, "tile", None), u=P(None, "tile", None, None),
        v=P(None, "tile", None, None), w=P(None, "tile", None, None),
        aks=P(None, "tile", None, None), salt=P(None, "tile", None, None),
        temp=P(None, "tile", None, None), times=P())
    part_spec = jax.tree.map(lambda _: P("dp", "tile"),
                             st.Particles(*(0,) * 12))
    tiled_specs = TiledStatic(
        y_rho_t=P("tile"), y_v_t=P("tile"), h_t=P("tile"),
        mask_rho_t=P("tile"), mask_u_t=P("tile"), mask_v_t=P("tile"),
        tile_edges=P())

    def body(pbuf, fs, ts, t0, ext_idx):
        # --- halo-extend the local field strips --------------------------
        ext = functools.partial(_halo_extend, halo=spec.halo,
                                ntiles=spec.ntiles, axis_name="tile")
        fs_loc = FieldSet(zeta=ext(fs.zeta), u=ext(fs.u), v=ext(fs.v),
                          w=ext(fs.w), aks=ext(fs.aks), salt=ext(fs.salt),
                          temp=ext(fs.temp), times=fs.times)

        # --- per-tile local grid -----------------------------------------
        y_loc = ts.y_rho_t[0]
        if grid.curv is not None:
            # curvilinear: single tile (run.py enforces mesh_tiles == 1,
            # halo == 0), so the "local" grid IS the global grid — the
            # inverse-map locate needs the whole 2-D coordinate mesh
            grid_loc = grid
            ctx_loc = ctx
        else:
            grid_loc = Grid(
                x_rho=grid.x_rho, y_rho=y_loc, x_u=grid.x_u,
                y_v=ts.y_v_t[0], h=ts.h_t[0], mask_rho=ts.mask_rho_t[0],
                mask_u=ts.mask_u_t[0], mask_v=ts.mask_v_t[0],
                s_rho=grid.s_rho, Cs_r=grid.Cs_r, s_w=grid.s_w,
                Cs_w=grid.Cs_w, hc=grid.hc, vtransform=grid.vtransform,
                uniform=grid.uniform)
            ctx_loc = StepContext(grid=grid_loc, bounds=ctx.bounds,
                                  polys=ctx.polys, holes=ctx.holes)

        p = jax.tree.map(lambda a: a.reshape(a.shape[2:]), pbuf)
        x_mid = grid.x_rho[grid.nx // 2]
        y_mid = y_loc[y_loc.shape[0] // 2]

        prec = _pk.build_packed_records(grid_loc, fs_loc) if fast else None

        def scan_body(carry, i):
            t = t0 + i * idt
            return internal_step(ctx_loc, cfg, base_key, carry, fs_loc, t,
                                 ext_idx * n_int + i, prec), None

        p, _ = lax.scan(scan_body, p, jnp.arange(n_int))
        p, n_drop = _migrate(p, spec, ts.tile_edges, x_mid, y_mid, "tile")

        pbuf = jax.tree.map(lambda a: a.reshape((1, 1) + a.shape), p)
        return pbuf, n_drop.reshape(1, 1)

    shmapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(part_spec, fs_specs, tiled_specs, P(), P()),
        out_specs=(part_spec, P("dp", "tile")),
        check_vma=False)

    @jax.jit
    def ext_step(pbuf, fs, t0, ext_idx):
        return shmapped(pbuf, fs, tiled, t0, ext_idx)

    return ext_step


# ---------------------------------------------------------------------------
# host-side scatter / gather
# ---------------------------------------------------------------------------

def scatter_particles(p: st.Particles, spec: TileSpec,
                      tile_edges) -> st.Particles:
    """Host-side: place particles into (ndp, ntiles, cap) slot buffers
    by tile ownership (round-robin over dp within each tile)."""
    edges = np.asarray(tile_edges)
    y = np.asarray(p.y)
    dest = np.clip(np.searchsorted(edges, y, side="right") - 1, 0,
                   spec.ntiles - 1)
    leaves = {f: np.asarray(getattr(p, f)) for f in p._fields}
    n = y.shape[0]
    # rank each particle within its tile (stable), round-robin over dp
    order = np.argsort(dest, kind="stable")
    dsorted = dest[order]
    starts = np.searchsorted(dsorted, np.arange(spec.ntiles))
    rank = np.arange(n) - starts[dsorted]
    if rank.size and rank.max() >= spec.ndp * spec.cap:
        raise ValueError(
            f"a tile holds {rank.max() + 1} particles > ndp*cap="
            f"{spec.ndp * spec.cap}; raise slack")
    dp_idx = rank % spec.ndp
    slot = rank // spec.ndp
    # park empty slots mid-tile so locate() stays benign
    fin_lo = np.where(np.isfinite(edges[:-1]), edges[:-1], 0.0)
    fin_hi = np.where(np.isfinite(edges[1:]), edges[1:], 0.0)
    lo = np.where(np.isfinite(edges[:-1]), edges[:-1], fin_hi - 2.0)
    hi = np.where(np.isfinite(edges[1:]), edges[1:], fin_lo + 2.0)
    y_park = 0.5 * (lo + hi)                                # (ntiles,)
    x_park = float(np.asarray(p.x).mean()) if n else 0.0
    out = {}
    for f, a in leaves.items():
        if f == "status":
            fill = EMPTY
        elif f in ("pid", "settle_poly"):
            fill = -1
        elif f == "z":
            fill = -1.0
        elif f == "x":
            fill = x_park
        else:
            fill = 0
        buf = np.full((spec.ndp, spec.ntiles, spec.cap) + a.shape[1:], fill,
                      a.dtype)
        if f == "y":
            buf[:] = y_park[None, :, None]
        buf[dp_idx, dsorted, slot] = a[order]
        out[f] = buf
    return st.Particles(**{f: jnp.asarray(v) for f, v in out.items()})


def gather_particles(pbuf: st.Particles) -> st.Particles:
    """Host-side: flatten slot buffers back to a pid-ordered batch."""
    flat = {f: np.asarray(getattr(pbuf, f)).reshape(
        -1, *np.asarray(getattr(pbuf, f)).shape[3:])
        for f in pbuf._fields}
    keep = flat["status"] != EMPTY
    order = np.argsort(flat["pid"][keep], kind="stable")
    return st.Particles(**{f: jnp.asarray(v[keep][order])
                           for f, v in flat.items()})


def local_block(pbuf: st.Particles) -> st.Particles:
    """THIS process's addressable region of the sharded slot buffers,
    as host-numpy leaves with the local (ndp_loc, ntiles_loc, cap)
    block shape.

    Multi-host-safe: assembles only ``addressable_shards`` — never
    np.asarray on a globally-sharded array (which raises for
    non-addressable devices).  The per-process region of a (dp, tile)
    product sharding is a box, so stitching shard blocks at their
    index offsets reconstructs it exactly.
    """
    def one(arr):
        shards = list(arr.addressable_shards)

        def bound(ix, a, lo=True):
            if lo:
                return 0 if ix.start is None else ix.start
            return arr.shape[a] if ix.stop is None else ix.stop

        los = [min(bound(s.index[a], a) for s in shards)
               for a in range(arr.ndim)]
        his = [max(bound(s.index[a], a, lo=False) for s in shards)
               for a in range(arr.ndim)]
        out = np.empty([h - l for l, h in zip(los, his)],
                       np.dtype(arr.dtype))
        for s in shards:
            sl = tuple(slice(bound(ix, a) - lo, bound(ix, a, lo=False) - lo)
                       for a, (ix, lo) in enumerate(zip(s.index, los)))
            out[sl] = np.asarray(s.data)
        return out

    return st.Particles(**{f: one(getattr(pbuf, f))
                           for f in pbuf._fields})


def local_flat(pbuf: st.Particles) -> st.Particles:
    """local_block flattened to a 1-D batch INCLUDING empty slots
    (status == EMPTY) — constant length per host across the run, which
    is what the per-host trajectory shard files need (snapshot datasets
    are resizable in time, fixed in particle).  Readers/mergers filter
    status < 0 and sort by pid (out.writer.merge_shards)."""
    blk = local_block(pbuf)
    return st.Particles(**{f: jnp.asarray(v.reshape(-1, *v.shape[3:]))
                           for f, v in blk._asdict().items()})


def globalize_slots(p_local: st.Particles, mesh: Mesh,
                    spec: TileSpec) -> st.Particles:
    """Re-form the globally-sharded slot buffers from per-process local
    blocks (multi-host checkpoint resume; inverse of local_block for an
    unchanged mesh)."""
    from jax.sharding import NamedSharding

    def glob(a):
        a = np.asarray(a)
        gshape = (spec.ndp, spec.ntiles) + a.shape[2:]
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, P("dp", "tile")), a, gshape)

    return st.Particles(**{f: glob(getattr(p_local, f))
                           for f in p_local._fields})

"""Run driver: init -> external-step loop -> output -> shutdown.

Reference: ``program LTRANS`` / ``ini_LTRANS`` / ``fin_LTRANS``
(SURVEY.md SS3.1/SS3.5 [conf: H structure]).  CLI:

    python -m ltjax.run path/to/LTRANS.data [--resume]

The namelist file is the reference's own configuration format
(ltjax.config loads it unmodified).  Structured JSON-line logging per
external step (SURVEY.md SS5.5) replaces the reference's stdout
progress prints; WriteModelTiming maps to the per-phase timing summary.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np

from . import checkpoint as ckpt
from . import compile_cache
from . import convert
from . import state as st
from .config import Config, config_from_namelist
from .fields import stack_records
from .grid import Grid
from .io.prefetch import Prefetcher
from .io.roms import RomsSeries, grid_from_roms, read_grid
from .out.writer import TrajectoryWriter
from .physics import boundary as bd
from .physics import settlement as stl
from .step import (StepContext, make_external_step, mode_flags,
                   summary_counts)


def _project_polys(polys, cfg: Config):
    out = []
    for pid, v in polys:
        x = convert.lon2x(v[:, 0], v[:, 1], cfg.lonmin, cfg.latmin,
                          cfg.Earth_Radius, cfg.SphericalProjection)
        y = convert.lat2y(v[:, 1], cfg.latmin, cfg.Earth_Radius,
                          cfg.SphericalProjection)
        out.append((pid, np.stack([np.asarray(x), np.asarray(y)], -1)))
    return out


def build_context(cfg: Config, grid: Grid) -> StepContext:
    # grid-rim segments are tagged OPEN; whether they exit or reflect is
    # decided at reflect() time by cfg.OpenOceanBoundary
    if grid.curv is not None:
        xy = np.asarray(grid.curv.xy_flat).reshape(grid.ny, grid.nx, 2)
        bounds = bd.build_boundaries_curv(
            np.asarray(grid.mask_rho), xy[..., 0], xy[..., 1],
            grid.curv, closed_edges=False)
    else:
        bounds = bd.build_boundaries(
            np.asarray(grid.mask_rho), np.asarray(grid.x_rho),
            np.asarray(grid.y_rho), closed_edges=False)
    polys = holes = None
    if cfg.settlementon and cfg.habitatfile:
        hp = _project_polys(stl.read_polygon_csv(cfg.habitatfile), cfg)
        polys = stl.build_polygons(hp, np.asarray(bounds.x_edges),
                                   np.asarray(bounds.y_edges))
        if cfg.holesExist and cfg.holefile:
            hh = _project_polys(stl.read_polygon_csv(cfg.holefile), cfg)
            holes = stl.build_polygons(hh, np.asarray(bounds.x_edges),
                                       np.asarray(bounds.y_edges))
    return StepContext(grid=grid, bounds=bounds, polys=polys, holes=holes)


def load_grid(cfg: Config) -> Grid:
    dtype = jnp.dtype(cfg.dtype_pos)
    gd = read_grid(cfg.NCgridfile, cfg,
                   hist_path=None if not cfg.dirin else
                   RomsSeries(cfg).path_for(0))
    return grid_from_roms(gd, cfg, dtype)


def init_particles_from_parfile(cfg: Config) -> st.Particles:
    dtype = jnp.dtype(cfg.dtype_pos)
    arr = st.read_parfile(cfg.parfile)
    lon, lat, depth, dob = arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
    x = convert.lon2x(lon, lat, cfg.lonmin, cfg.latmin, cfg.Earth_Radius,
                      cfg.SphericalProjection)
    y = convert.lat2y(lat, cfg.latmin, cfg.Earth_Radius,
                      cfg.SphericalProjection)
    z = -np.abs(depth)  # depths may be given positive-down
    return st.init_particles(np.asarray(x), np.asarray(y), z, dob,
                             dtype=dtype)


class Timing:
    """WriteModelTiming analog: cumulative per-phase wall clock."""

    def __init__(self):
        self.acc = {}

    def add(self, phase: str, dt: float):
        self.acc[phase] = self.acc.get(phase, 0.0) + dt

    def summary(self):
        return dict(sorted(self.acc.items()))


class _Profiler:
    """SURVEY.md SS5.1: optional ``jax.profiler`` trace capture.

    ``LTJAX_PROFILE_DIR=/path`` captures a TensorBoard/Perfetto trace of
    external steps [start, stop) (post-JIT-warm-up by default; override
    with ``LTJAX_PROFILE_STEPS=start:stop``).  The reference's only
    profiling is the WriteModelTiming phase accumulator (LTRANS.f90
    [conf: M]); this is its device-level upgrade.
    """

    def __init__(self):
        self.dir = os.environ.get("LTJAX_PROFILE_DIR")
        steps = os.environ.get("LTJAX_PROFILE_STEPS", "1:3")
        a, _, b = steps.partition(":")
        self.start, self.stop = int(a), int(b or (int(a) + 2))
        self.active = False

    def tick(self, ext: int):
        if not self.dir:
            return
        if not self.active and self.start <= ext < self.stop:
            jax.profiler.start_trace(self.dir)
            self.active = True
        elif self.active and ext >= self.stop:
            jax.profiler.stop_trace()
            self.active = False

    def close(self):
        if self.active:
            jax.profiler.stop_trace()
            self.active = False


def log_start(cfg: Config, path: str, mesh=(1, 1)):
    """The run's first log line: the compute path mode_flags chose and
    the devices JAX runs it on."""
    dev = jax.devices()[0]
    print(json.dumps({
        "event": "start", "path": path, "numpar": cfg.numpar,
        "dtype_pos": cfg.dtype_pos, "mesh": list(mesh),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())}}), flush=True)


def _apply_debug_flags():
    """SURVEY.md SS5.2: ``LTJAX_DEBUG_NANS=1`` enables jax_debug_nans —
    any NaN produced by a jitted step fails loudly with a traceback
    instead of silently corrupting trajectories."""
    if os.environ.get("LTJAX_DEBUG_NANS"):
        jax.config.update("jax_debug_nans", True)


def run(cfg: Config, resume: bool = False,
        series_paths: Optional[List[str]] = None) -> st.Particles:
    if cfg.mesh_particles * cfg.mesh_tiles > 1:
        return run_sharded(cfg, resume=resume, series_paths=series_paths)
    cfg.validate()
    if cfg.dtype_pos == "float64" and not jax.config.jax_enable_x64:
        # without this, f64 requests silently truncate to f32
        jax.config.update("jax_enable_x64", True)
    compile_cache.configure()
    _apply_debug_flags()
    profiler = _Profiler()
    timing = Timing()
    t0 = time.perf_counter()

    grid = load_grid(cfg)
    ctx = build_context(cfg, grid)
    if cfg.BoundaryBLNs:
        bd.dump_boundaries(
            ctx.bounds, cfg.outpath,
            to_lonlat=lambda x, y: (
                convert.x2lon(x, y, cfg.lonmin, cfg.latmin,
                              cfg.Earth_Radius, cfg.SphericalProjection),
                convert.y2lat(y, cfg.latmin, cfg.Earth_Radius,
                              cfg.SphericalProjection)))
    series = RomsSeries(cfg, paths=series_paths)
    global_rec = 0

    if cfg.WriteParfile and cfg.parfile:
        # reference parity: echo the initial-particle file to the output
        # directory (LTRANS.data `WriteParfile` [conf: M])
        import shutil
        os.makedirs(cfg.outpath, exist_ok=True)
        shutil.copyfile(cfg.parfile,
                        os.path.join(cfg.outpath, "parfile_echo.csv"))

    start_ext = 0
    resumed_extra = None
    if resume:
        path = ckpt.latest(cfg.checkpoint_dir)
        if path:
            particles, start_ext, global_rec, resumed_extra = ckpt.load(path)
            series.seek(global_rec - 3)  # re-prime the 3-record buffer
        else:
            particles = init_particles_from_parfile(cfg)
    else:
        particles = init_particles_from_parfile(cfg)

    # --- prime the record window (initHydro) -----------------------------
    recs = [series.next_record() for _ in range(3)]
    if resumed_extra is None:
        global_rec += 3
        t_base = recs[0]["time"]
    else:
        # global_rec already counts the re-primed records; field times
        # must stay on the original run clock, not restart at zero
        t_base = resumed_extra.get(
            "t_base", recs[0]["time"] - (global_rec - 3) * cfg.dt)
    timing.add("hydro_init", time.perf_counter() - t0)

    log_start(cfg, mode_flags(cfg))
    prefetch = (Prefetcher(series.next_record, depth=2)
                if cfg.prefetch else None)

    writer = TrajectoryWriter(cfg)
    ext_step = make_external_step(ctx, cfg, jr.key(cfg.seed))

    # record window: ``window`` holds records
    # [win_start .. win_start + len(window) - 1]; external step e needs
    # records [e, e+1, e+2] (the reference's triple buffer)
    window: List[dict] = list(recs)
    win_start = global_rec - 3
    field_dtype = jnp.dtype(cfg.dtype_field)

    n_ext = cfg.external_steps
    if not resume:
        writer.snapshot(0.0, particles)
    exhausted = False
    try:
        for ext in range(start_ext, n_ext):
            # --- updateHydro: extend the window to record ext+2 ----------
            tw = time.perf_counter()
            while global_rec - 1 < ext + 2 and not exhausted:
                rec = prefetch.next() if prefetch else series.next_record()
                if rec is None:
                    exhausted = True
                    break
                window.append(rec)
                global_rec += 1
            if global_rec - 1 < ext + 2:
                print(json.dumps({"event": "series_exhausted", "ext": ext}))
                break
            while win_start < ext:                  # drop stale records
                window.pop(0)
                win_start += 1
            fs = stack_records(window[:3], t_base, field_dtype,
                               with_salt_temp=cfg.needs_salt_fields())
            timing.add("hydro_read", time.perf_counter() - tw)

            # --- compute one external step -------------------------------
            profiler.tick(ext)
            tc = time.perf_counter()
            t_ext = float(ext * cfg.dt)
            particles = ext_step(particles, fs, t_ext, ext)
            particles = jax.block_until_ready(particles)
            step_s = time.perf_counter() - tc
            timing.add("compute", step_s)

            counts = summary_counts(particles)
            if cfg.ErrorFlag == 0 and counts["error"] > 0:
                raise RuntimeError(
                    f"{counts['error']} particles hit location/"
                    f"interpolation errors at ext step {ext} "
                    f"(ErrorFlag=0 halts; set ErrorFlag>0 to continue)")

            if (ext + 1) % cfg.output_every_ext == 0:
                to = time.perf_counter()
                writer.snapshot(t_ext + cfg.dt, particles)
                timing.add("output", time.perf_counter() - to)

            if cfg.checkpoint_every and (ext + 1) % cfg.checkpoint_every == 0:
                ckpt.save(os.path.join(cfg.checkpoint_dir,
                                       f"ckpt_{ext + 1}.npz"),
                          particles, ext + 1, global_rec,
                          extra={"t_base": float(t_base)})

            log = {"ext": ext, "sim_t": t_ext + cfg.dt, "step_s": step_s,
                   "steps_per_s": cfg.numpar * cfg.internal_steps / step_s,
                   "stall_s": round(prefetch.stall_s, 4) if prefetch
                   else 0.0}
            log.update(counts)
            print(json.dumps(log))
    finally:
        profiler.close()
        if prefetch:
            prefetch.close()
        writer.close()
        series.close()

    if cfg.WriteModelTiming:
        print(json.dumps({"timing": timing.summary()}))
    return particles


def run_sharded(cfg: Config, resume: bool = False,
                series_paths: Optional[List[str]] = None) -> st.Particles:
    """Multi-chip driver: (dp x tile) mesh, halo exchange, migration.

    Production form of BASELINE.json config 5 (SURVEY.md SS2.2/SS7.2
    M5): particles live in fixed-capacity (ndp, ntiles, cap) slot
    buffers sharded over the mesh; fields are eta-padded and sharded
    over the tile axis; every external step is ONE compiled shard_map
    (halo ppermute -> internal-step scan -> all_to_all migration).
    Checkpoints save the slot buffers directly (resume preserves the
    slot layout bit-for-bit).  Multi-host: set JAX_COORDINATOR_ADDRESS
    (+ standard jax.distributed env) before launch; only process 0
    writes trajectory output.
    """
    from . import shard

    cfg.validate()
    compile_cache.configure()
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        # real multi-host: the standard env drives jax.distributed.
        # Bare-env launches (outside auto-detected clusters) must set
        # ALL THREE of JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
        # JAX_PROCESS_ID — an address alone would reach
        # jax.distributed.initialize with no process count and fail
        # with an opaque error (advisor finding r4-low); inside a
        # recognized cluster (where auto-detection fills them) the
        # count/id pair may be omitted together.
        kw = {}
        has_np = os.environ.get("JAX_NUM_PROCESSES")
        has_id = os.environ.get("JAX_PROCESS_ID")
        if bool(has_np) != bool(has_id):
            raise RuntimeError(
                "multi-host launch: set BOTH JAX_NUM_PROCESSES and "
                "JAX_PROCESS_ID alongside JAX_COORDINATOR_ADDRESS "
                "(or neither, inside an auto-detected cluster)")
        if has_np:
            kw = dict(num_processes=int(has_np),
                      process_id=int(has_id))
        jax.distributed.initialize(
            coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"], **kw)
    is_proc0 = jax.process_index() == 0
    multi = jax.process_count() > 1
    host_tag = f"_h{jax.process_index():03d}" if multi else ""
    if cfg.dtype_pos == "float64" and not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    _apply_debug_flags()
    profiler = _Profiler()
    timing = Timing()
    t0 = time.perf_counter()

    grid = load_grid(cfg)
    if grid.curv is not None and cfg.mesh_tiles > 1:
        raise NotImplementedError(
            "curvilinear grids shard over the PARTICLE axis only "
            "(mesh_particles = N, mesh_tiles = 1): eta-strip domain "
            "tiles assume rectilinear row slicing.  Particle data "
            "parallelism covers the multi-chip scaling need — "
            "particles are independent given the (replicated) fields.")
    ctx = build_context(cfg, grid)
    global_rec = 0

    ndp, ntiles = cfg.mesh_particles, cfg.mesh_tiles
    spec = shard.make_spec(cfg, grid.ny, cfg.numpar, ndp, ntiles,
                           halo=0 if grid.curv is not None
                           else cfg.halo_rows,
                           slack=cfg.migrate_capacity)
    mesh = shard.make_mesh(spec)
    # per-host hyperslab reads (SURVEY.md SS5.8): each host reads only
    # the eta rows its tiles own; halos ride the in-step ppermute
    eta_rows = (shard.process_tile_rows(mesh, spec, grid.ny)
                if jax.process_count() > 1 else None)
    local_rows = (None if eta_rows is None else
                  -(-(eta_rows[1] - eta_rows[0]) // spec.ny_loc)
                  * spec.ny_loc)
    series = RomsSeries(cfg, paths=series_paths, eta_slice=eta_rows)
    tiled = shard.build_tiled_static(grid, spec)
    if is_proc0:
        log_start(cfg, mode_flags(cfg), mesh=(ndp, ntiles))
    step = shard.make_tiled_step(ctx, cfg, spec, tiled, mesh,
                                 jr.key(cfg.seed))

    start_ext = 0
    resumed_extra = None
    pbuf = None
    if resume:
        path = ckpt.latest(cfg.checkpoint_dir, tag=host_tag)
        if path:
            saved, start_ext, global_rec, resumed_extra = ckpt.load(path)
            if multi:
                # per-host local blocks -> global sharded buffers
                # (mesh must be unchanged between runs)
                pbuf = shard.globalize_slots(saved, mesh, spec)
            elif saved.x.ndim == 3 and saved.x.shape[:2] == (ndp, ntiles):
                pbuf = saved                    # same mesh: exact layout
            else:
                # mesh changed between runs: re-scatter the flat batch
                flat = (shard.gather_particles(saved)
                        if saved.x.ndim == 3 else saved)
                pbuf = shard.scatter_particles(flat, spec,
                                               tiled.tile_edges)
    if pbuf is None:
        particles = init_particles_from_parfile(cfg)
        pbuf = shard.scatter_particles(particles, spec, tiled.tile_edges)
    # commit the slot buffers to the mesh sharding up front (scatter
    # builds host-replicated arrays; without this, multi-host
    # local_block/local_flat would see the full global buffers before
    # the first step and per-host shards after it)
    from jax.sharding import NamedSharding, PartitionSpec
    pbuf = jax.device_put(
        pbuf, NamedSharding(mesh, PartitionSpec("dp", "tile")))

    if resumed_extra is not None:
        series.seek(global_rec - 3)          # re-prime the record window
    recs = [series.next_record() for _ in range(3)]
    if resumed_extra is None:
        global_rec += 3
        t_base = recs[0]["time"]
    else:
        t_base = resumed_extra.get(
            "t_base", recs[0]["time"] - (global_rec - 3) * cfg.dt)
    timing.add("hydro_init", time.perf_counter() - t0)

    prefetch = (Prefetcher(series.next_record, depth=2)
                if cfg.prefetch else None)
    # multi-host: EVERY process streams its own shard file (fixed-length
    # rows = its local slot block incl. EMPTY slots; merge with
    # out.writer.merge_shards).  Single-process NC-only runs stream the
    # SAME way (one local shard file, merged into the standard global
    # file at close) so a 10M-particle multi-chip host never
    # materializes + pid-sorts the whole batch per snapshot (VERDICT r4
    # weak #8); CSV output keeps the gather path (CSV rows are global).
    stream_shard = (not multi) and cfg.writeNC and not cfg.writeCSV
    shard_tag_w = host_tag if multi else ("_shard0" if stream_shard else "")
    writer = (TrajectoryWriter(cfg, shard_tag=shard_tag_w)
              if (multi or is_proc0) else None)
    field_dtype = jnp.dtype(cfg.dtype_field)
    window: List[dict] = list(recs)
    win_start = global_rec - 3
    n_ext = cfg.external_steps
    drops_total = 0

    def snap_batch():
        # snapshot form: fixed slot rows (cheap D2H, no sort) when
        # streaming shard files; full pid-ordered gather otherwise
        return (shard.local_flat(pbuf) if (multi or stream_shard)
                else shard.gather_particles(pbuf))

    def final_batch():
        return (shard.local_flat(pbuf) if multi
                else shard.gather_particles(pbuf))

    if writer and not resume:
        writer.snapshot(0.0, snap_batch())
    exhausted = False
    try:
        for ext in range(start_ext, n_ext):
            tw = time.perf_counter()
            while global_rec - 1 < ext + 2 and not exhausted:
                rec = prefetch.next() if prefetch else series.next_record()
                if rec is None:
                    exhausted = True
                    break
                window.append(rec)
                global_rec += 1
            if global_rec - 1 < ext + 2:
                print(json.dumps({"event": "series_exhausted", "ext": ext}))
                return final_batch()
            while win_start < ext:
                window.pop(0)
                win_start += 1
            fs = stack_records(window[:3], t_base, field_dtype,
                               with_salt_temp=cfg.needs_salt_fields())
            if eta_rows is None:
                fs = shard.pad_fieldset_eta(fs, spec.ny_pad)
            else:
                # per-host slab -> pad to the owned row count -> global
                # sharded arrays (multi-host assembly)
                fs = shard.pad_fieldset_eta(fs, local_rows)
                fs = shard.globalize_fields(fs, mesh, spec)
            timing.add("hydro_read", time.perf_counter() - tw)

            profiler.tick(ext)
            tc = time.perf_counter()
            t_ext = float(ext * cfg.dt)
            pbuf, n_drop = step(pbuf, fs, t_ext, ext)
            pbuf = jax.block_until_ready(pbuf)
            step_s = time.perf_counter() - tc
            timing.add("compute", step_s)
            drops = int(jnp.sum(n_drop))
            drops_total += drops

            counts = summary_counts(pbuf)
            if cfg.ErrorFlag == 0 and (counts["error"] > 0 or drops > 0):
                raise RuntimeError(
                    f"{counts['error']} errored particles / {drops} "
                    f"migration overflows at ext step {ext} "
                    f"(ErrorFlag=0 halts; raise migrate_capacity or set "
                    f"ErrorFlag>0 to continue)")

            if writer and (ext + 1) % cfg.output_every_ext == 0:
                to = time.perf_counter()
                writer.snapshot(t_ext + cfg.dt, snap_batch())
                timing.add("output", time.perf_counter() - to)

            if cfg.checkpoint_every and (ext + 1) % cfg.checkpoint_every == 0:
                # multi-host: each host saves its addressable block only
                ckpt.save(os.path.join(cfg.checkpoint_dir,
                                       f"ckpt_{ext + 1}{host_tag}.npz"),
                          shard.local_block(pbuf) if multi else pbuf,
                          ext + 1, global_rec,
                          extra={"t_base": float(t_base)})

            log = {"ext": ext, "sim_t": t_ext + cfg.dt, "step_s": step_s,
                   "steps_per_s": cfg.numpar * cfg.internal_steps / step_s,
                   "migration_drops": drops,
                   "stall_s": round(prefetch.stall_s, 4) if prefetch
                   else 0.0}
            log.update(counts)
            print(json.dumps(log))
    finally:
        profiler.close()
        if prefetch:
            prefetch.close()
        if writer:
            writer.close()
        series.close()
        if stream_shard and writer is not None:
            # fold the single-host shard file into the standard global
            # layout (pid-sorted union, EMPTY slots dropped) — one
            # end-of-run pass instead of a full gather+sort per snapshot
            from .out.writer import merge_shards
            sp_ = os.path.join(cfg.outpath,
                               cfg.NCOutFile + "_shard0.nc")
            if os.path.exists(sp_):
                merge_shards([sp_], os.path.join(
                    cfg.outpath, cfg.NCOutFile + ".nc"))
                os.remove(sp_)

    if cfg.WriteModelTiming:
        print(json.dumps({"timing": timing.summary()}))
    return final_batch()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m ltjax.run LTRANS.data [--resume]")
        return 2
    cfg = config_from_namelist(argv[0])
    run(cfg, resume="--resume" in argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

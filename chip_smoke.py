"""Smoke check of ltjax on an NVIDIA GPU: the main path, end to end.

    python chip_smoke.py             # phases 1-4 (+ the gpu tests), one card
    python chip_smoke.py --cards 4   # phase 5 only: the sharded run, 4 cards

Phases (one process; it alone opens the card):

1. Card: ``nvidia-smi`` name and power limit, JAX's device kind and count.
2. CLI end to end at the bench's flagship size: a geographic
   solid-body ROMS series (200x200, 20 s-levels, fields in f64), a
   1M-particle parfile and an ``LTRANS.data`` are generated under
   ``.smoke/``; ``ltjax.run.main`` runs four external steps; the
   written NetCDF is compared with the analytic trajectories.  Prints
   compile time, time per external step, peak device memory,
   ``memory_analysis()`` of the step, and the interpolation's bytes/s.
3. Fast path vs the native reference (``fast_interp=False``) at 100k
   particles with turbulence and a swimming behavior, under
   ``default_matmul_precision("highest")`` and the default.
4. Every path ``mode_flags`` can choose, in every bench variant, at 100k
   particles: one external step each, no ERROR, finite state; then the
   tests marked ``gpu``.
5. (``--cards 4``) ``run_sharded`` at 10M particles on a 2x2 (particle x
   tile) mesh vs the unsharded one-card run of the same case.

Exits non-zero, printing no result, unless JAX's first device is a GPU.
The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
LONMIN, LATMIN = -76.0, 37.0
FULL = dict(nx=200, ny=200, us=20, numpar=1_000_000, n_ext=4)


def check_device():
    """JAX's devices, or SystemExit unless the first one is a GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs an NVIDIA GPU; JAX's first "
                         f"device is {devs[0].platform!r}")
    return devs


def card_line() -> str:
    """``name, power.limit`` of the card(s), as nvidia-smi prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}, default=str), flush=True)


def f32_ulp(v: float) -> float:
    return float(np.spacing(np.float32(abs(v))))


class _Tee(io.TextIOBase):
    """stdout that is also kept, line by line, for parsing."""

    def __init__(self, out):
        self.out, self.buf = out, []

    def write(self, s):
        self.out.write(s)
        self.buf.append(s)
        return len(s)

    def flush(self):
        self.out.flush()

    def json_lines(self):
        out = []
        for line in "".join(self.buf).splitlines():
            if line.startswith("{"):
                out.append(json.loads(line))
        return out


# --------------------------------------------------------------------------
# phase 2: the CLI at the flagship size
# --------------------------------------------------------------------------

def write_case(root: str, nx: int, ny: int, us: int, numpar: int,
               n_ext: int, dt: int = 3600, idt: int = 120, seed: int = 0):
    """Generate a solid-body ROMS series, a parfile and an LTRANS.data.

    Lengths scale with the grid (1 km cells); particles start in the
    middle 60% of the domain, where a rotation of omega*t over the run
    keeps them inside.  Returns (case, namelist path, x0, y0, z0) with
    the release positions in metres (float64).
    """
    import jax
    import jax.numpy as jnp
    from ltjax import convert, synth

    L = 1000.0 * nx
    with jax.enable_x64(True):      # grid and fields computed in f64
        case = synth.make_solid_body_case(
            nx=nx, ny=ny, us=us, lx=L, ly=1000.0 * ny, h0=50.0,
            omega=5e-5, dtype=jnp.float64)
        synth.write_roms_files(case, os.path.join(root, "roms"),
                               n_records=n_ext + 2, dt=float(dt),
                               records_per_file=n_ext + 2, geographic=True,
                               lonmin=LONMIN, latmin=LATMIN)
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.2 * L, 0.8 * L, numpar)
    y0 = rng.uniform(0.2 * 1000.0 * ny, 0.8 * 1000.0 * ny, numpar)
    z0 = rng.uniform(-40.0, -5.0, numpar)
    lat = convert.y2lat(y0, LATMIN)
    lon = convert.x2lon(x0, y0, LONMIN, LATMIN)
    parfile = os.path.join(root, "parfile.csv")
    # 1e-10 degrees of print rounding is ~1e-5 m: the metre positions
    # above stand for what the engine reads back
    np.savetxt(parfile, np.column_stack([lon, lat, z0, np.zeros(numpar)]),
               fmt="%.10f,%.10f,%.6f,%.1f")
    nml = os.path.join(root, "LTRANS.data")
    with open(nml, "w") as f:
        f.write(f"""&numparticles
  numpar = {numpar}
/
&timeparam
  days = {n_ext * dt / 86400.0!r}, iprint = {dt}, dt = {dt}, idt = {idt}
/
&hydroparam
  us = {us}, ws = {us + 1}, hc = 50.0, Vtransform = 1
/
&turbparam
  HTurbOn = .FALSE., VTurbOn = .FALSE.
/
&behavparam
  Behavior = 0, OpenOceanBoundary = .TRUE.
/
&convparam
  SphericalProjection = .TRUE., lonmin = {LONMIN}, latmin = {LATMIN}
/
&romsgrid
  NCgridfile = '{root}/roms/grid.nc'
/
&romsoutput
  dirin = '{root}/roms/', prefix = 'ocean_his_', suffix = '.nc', numdigits = 4
/
&parloc
  parfile = '{parfile}'
/
&output
  outpath = '{root}/out', NCOutFile = 'smoke', writeNC = .TRUE.,
  writeCSV = .FALSE.
/
&other
  ErrorFlag = 0, WriteModelTiming = .TRUE.
/
&engine
  dtype_pos = 'float32', dtype_field = 'float32'
/
""")
    return case, nml, x0, y0, z0


def analytic_errors(case, out_nc: str, x0, y0, z0):
    """Max horizontal and vertical error of every written snapshot
    against the closed-form trajectories, and the snapshot times."""
    from ltjax import convert
    from ltjax.io.nc import NCFile

    with NCFile(out_nc) as f:
        t = f.read("model_time")
        lon, lat, depth = f.read("lon"), f.read("lat"), f.read("depth")
        pid = f.read("pid")
    eh = ez = 0.0
    for k in range(len(t)):
        y = convert.lat2y(lat[k], LATMIN)
        x = convert.lon2x(lon[k], lat[k], LONMIN, LATMIN)
        xt, yt, zt = case.analytic(x0[pid], y0[pid], z0[pid], float(t[k]))
        eh = max(eh, float(np.hypot(x - xt, y - yt).max()))
        ez = max(ez, float(np.abs(depth[k] - zt).max()))
    return eh, ez, t


def phase_cli(root: str, nx: int, ny: int, us: int, numpar: int,
              n_ext: int) -> dict:
    """Phase 2.  Raises AssertionError when a check fails."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr
    from ltjax import run as ltrun
    from ltjax.config import config_from_namelist
    from ltjax.fields import stack_records
    from ltjax.io.roms import RomsSeries
    from ltjax.step import make_external_step

    t0 = time.perf_counter()
    case, nml, x0, y0, z0 = write_case(root, nx, ny, us, numpar, n_ext)
    gen_s = time.perf_counter() - t0

    res = {"gen_s": gen_s}
    cfg = config_from_namelist(nml)
    # compile the step the CLI will run, on the CLI's own inputs (the
    # CLI then finds it in the persistent cache)
    grid = ltrun.load_grid(cfg)
    ctx = ltrun.build_context(cfg, grid)
    series = RomsSeries(cfg)
    recs = [series.next_record() for _ in range(3)]
    series.close()
    fs = stack_records(recs, recs[0]["time"], jnp.float32)
    p = ltrun.init_particles_from_parfile(cfg)
    step = make_external_step(ctx, cfg, jr.key(cfg.seed))
    tc = time.perf_counter()
    compiled = step.lower(p, fs, 0.0, 0).compile()
    res["compile_s"] = time.perf_counter() - tc
    ma = compiled.memory_analysis()
    res["memory_analysis"] = {
        k: getattr(ma, k) for k in dir(ma)
        if k.endswith("_in_bytes") and not k.startswith("_")}

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = ltrun.main([nml])
    assert rc == 0, f"ltjax.run.main returned {rc}"
    logs = tee.json_lines()
    start = [r for r in logs if r.get("event") == "start"]
    steps = [r for r in logs if "step_s" in r]
    assert start and start[0]["path"] == "fast", start
    assert len(steps) == n_ext, steps
    assert all(r["error"] == 0 for r in steps), steps
    assert steps[-1]["active"] == numpar, steps[-1]
    res["step_s"] = [r["step_s"] for r in steps]
    res["first_step_s"] = steps[0]["step_s"]
    steady = float(np.median(res["step_s"][1:]))
    res["steady_step_s"] = steady
    res["particle_steps_per_s"] = numpar * cfg.internal_steps / steady
    stats = jax.devices()[0].memory_stats() or {}
    res["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")

    eh, ez, t = analytic_errors(case, os.path.join(root, "out", "smoke.nc"),
                                x0, y0, z0)
    assert len(t) == n_ext + 1, t
    # Tolerance: the field is exactly representable (linear in x, y;
    # w = 0) and RK4's truncation at omega*idt = 6e-3 is ~1e-8 m, so
    # the error is float32 position rounding: at most one ulp of the
    # largest coordinate per internal step, plus the release rounding.
    n_steps = n_ext * cfg.internal_steps
    tol_h = (n_steps + 1) * f32_ulp(1000.0 * max(nx, ny))
    tol_z = (n_steps + 1) * f32_ulp(50.0)
    res.update(err_h_m=eh, tol_h_m=tol_h, err_z_m=ez, tol_z_m=tol_z)
    assert eh <= tol_h, (eh, tol_h)
    assert ez <= tol_z, (ez, tol_z)
    return res


def phase_interp(nx: int, ny: int, us: int, numpar: int,
                 reps: int = 3) -> dict:
    """Time the interpolation alone (stage tables + RK4 displacement,
    one external step of internal steps) and rate its bytes."""
    import jax
    import jax.numpy as jnp
    import bench
    from ltjax import packed as pk

    cfg, ctx, fs, p = bench.build(numpar=numpar, nx=nx, ny=ny, us=us)
    grid, n_int, idt = ctx.grid, cfg.internal_steps, float(cfg.idt)

    @jax.jit
    def interp(x, y, z):
        prec = pk.build_packed_records(grid, fs)

        def body(c, i):
            x, y, z = c
            tabs = pk.stage_tables(grid, prec, i * idt, idt,
                                   cfg.tension_sigma)
            dx, dy, dz = pk.rk4_displacement_packed(
                grid, tabs, x, y, z, cfg.tension_sigma, cfg.z0, idt)
            return (x + dx, y + dy, z + dz), None

        return jax.lax.scan(body, (x, y, z), jnp.arange(n_int))[0]

    out = jax.block_until_ready(interp(p.x, p.y, p.z))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(interp(*out))
        ts.append(time.perf_counter() - t0)
    sec = float(np.median(ts))
    nbytes = bench.interp_bytes(numpar, grid, n_int)
    return {"interp_s": sec, "interp_bytes": nbytes,
            "interp_bytes_per_s": nbytes / sec}


# --------------------------------------------------------------------------
# phase 3: fast path vs the native reference
# --------------------------------------------------------------------------

def phase_reference(numpar: int, nx: int = 200, ny: int = 200,
                    us: int = 20) -> dict:
    """One external step, fast vs native, turbulence + behavior 1."""
    import dataclasses
    import jax
    import jax.random as jr
    import bench
    from ltjax import state as st
    from ltjax.step import make_external_step

    cfg, ctx, fs, p = bench.build(numpar=numpar, nx=nx, ny=ny, us=us,
                                  variant="turb")
    cfg = dataclasses.replace(cfg, Behavior=1, swimslow=1e-3,
                              swimfast=3e-3, pediage=5e6)

    def one(c):
        return jax.block_until_ready(
            make_external_step(ctx, c, jr.key(0))(p, fs, 0.0, 0))

    with jax.default_matmul_precision("highest"):
        nat = one(dataclasses.replace(cfg, fast_interp=False))
        fast_hi = one(cfg)
    fast_def = one(cfg)
    # Tolerance: tests/test_packed.py pins the fast scheme to the native
    # one up to rounding on this linear case (1e-6 m in f64 over one
    # external step).  In float32 that rounding is at most one ulp of
    # the coordinate per internal step.  A swimming particle within
    # rounding of its zone edge may take the other branch: that moves
    # it vertically by at most 2*swimfast*idt per step, and the shear-
    # free flow keeps its horizontal track — allowed for 1e-4 of them.
    n = cfg.internal_steps
    tol_h = n * f32_ulp(1000.0 * max(nx, ny))
    tol_z = n * f32_ulp(50.0)
    flip_z = 2.0 * cfg.swimfast * cfg.idt * n
    res = {"tol_h_m": tol_h, "tol_z_m": tol_z, "flip_bound_z_m": flip_z}
    for name, a in (("highest", fast_hi), ("default", fast_def)):
        status = np.asarray(a.status)
        assert np.array_equal(status, np.asarray(nat.status)), name
        assert int((status == st.ERROR).sum()) == 0, name
        dh = np.hypot(np.asarray(a.x) - np.asarray(nat.x),
                      np.asarray(a.y) - np.asarray(nat.y))
        dz = np.abs(np.asarray(a.z) - np.asarray(nat.z))
        r = res[name] = {"max_dxy_m": float(dh.max()),
                         "max_dz_m": float(dz.max()),
                         "n_dz_over_tol": int((dz > tol_z).sum())}
        assert dh.max() <= tol_h, (name, r)
        assert r["n_dz_over_tol"] <= max(1, numpar // 10_000), (name, r)
        assert dz.max() <= flip_z, (name, r)
    # a float32 matmul running in TF32 would make these two differ
    res["fast_default_vs_highest_max_m"] = float(max(
        np.abs(np.asarray(fast_def.x) - np.asarray(fast_hi.x)).max(),
        np.abs(np.asarray(fast_def.y) - np.asarray(fast_hi.y)).max(),
        np.abs(np.asarray(fast_def.z) - np.asarray(fast_hi.z)).max()))
    res["tf32_on_path"] = res["fast_default_vs_highest_max_m"] > 0.0
    return res


# --------------------------------------------------------------------------
# phase 4: every path and variant compiles and runs
# --------------------------------------------------------------------------

def phase_paths(numpar: int, nx: int = 200, ny: int = 200,
                us: int = 20) -> dict:
    import dataclasses
    import jax
    import jax.random as jr
    import bench
    from ltjax import state as st
    from ltjax.step import make_external_step, mode_flags

    res = {}
    for variant in bench.VARIANTS:
        cfg, ctx, fs, p = bench.build(numpar=numpar, nx=nx, ny=ny, us=us,
                                      variant=variant)
        cfgs = [cfg]
        if variant == "advect":
            # the native path (adaptive tension is native-only)
            cfgs.append(dataclasses.replace(cfg, tension_sigma=-1.0))
        for c in cfgs:
            t0 = time.perf_counter()
            out = jax.block_until_ready(
                make_external_step(ctx, c, jr.key(0))(p, fs, 0.0, 0))
            key = f"{variant}/{mode_flags(c)}"
            status = np.asarray(out.status)
            n_err = int((status == st.ERROR).sum())
            finite = all(np.isfinite(np.asarray(a)).all()
                         for a in (out.x, out.y, out.z))
            res[key] = {"s": time.perf_counter() - t0, "error": n_err,
                        "active": int((status == st.ACTIVE).sum()),
                        "settled": int((status == st.SETTLED).sum())}
            assert n_err == 0 and finite, (key, res[key])
    return res


def phase_gpu_tests() -> dict:
    """The tests marked ``gpu``, in this process (one process per card)."""
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "--noconftest",
                      "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    assert rc == 0, f"gpu tests failed (pytest exit {rc})"
    return {"pytest_rc": int(rc)}


# --------------------------------------------------------------------------
# phase 5: the sharded path across four cards
# --------------------------------------------------------------------------

def phase_sharded(root: str, numpar: int, nx: int = 200, ny: int = 200,
                  us: int = 20, n_ext: int = 2, mesh=(2, 2)) -> dict:
    """run_sharded on a (particle x tile) mesh vs the one-device run()."""
    from ltjax import run as ltrun
    from ltjax import shard
    from ltjax.config import config_from_namelist

    case, nml, _, _, _ = write_case(root, nx, ny, us, numpar, n_ext)
    # halo: the farthest a particle moves in one external step (speed
    # omega*r at the release square's corner, r = 0.3*sqrt(2)*L) plus
    # one stencil row
    dt = config_from_namelist(nml).dt
    v_max = case.omega * 0.3 * np.sqrt(2.0) * 1000.0 * max(nx, ny)
    common = dict(writeNC=False, migrate_capacity=1.5,
                  halo_rows=shard.halo_rows_needed(v_max, dt, 1000.0))
    ref_cfg = config_from_namelist(nml, **common)
    sh_cfg = config_from_namelist(nml, mesh_particles=mesh[0],
                                  mesh_tiles=mesh[1], **common)
    # the one-card reference first, while its card's memory is unused
    t0 = time.perf_counter()
    ref = ltrun.run(ref_cfg)
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    sh = ltrun.run_sharded(sh_cfg)
    t_sh = time.perf_counter() - t0
    assert np.array_equal(np.asarray(sh.pid), np.asarray(ref.pid))
    assert np.array_equal(np.asarray(sh.status), np.asarray(ref.status))
    dh = np.hypot(np.asarray(sh.x, np.float64) - np.asarray(ref.x),
                  np.asarray(sh.y, np.float64) - np.asarray(ref.y))
    dz = np.abs(np.asarray(sh.z, np.float64) - np.asarray(ref.z))
    # Tolerance: each tile locates on its own strip of the grid axis,
    # so cell fractions differ from the global ones by float32 rounding;
    # the bound is one ulp of the coordinate per internal step.
    n_steps = n_ext * ref_cfg.internal_steps
    tol_h = n_steps * f32_ulp(1000.0 * max(nx, ny))
    tol_z = n_steps * f32_ulp(50.0)
    res = {"numpar": numpar, "mesh": list(mesh), "sharded_s": t_sh,
           "one_card_s": t_ref, "max_dxy_m": float(dh.max()),
           "max_dz_m": float(dz.max()), "tol_h_m": tol_h, "tol_z_m": tol_z}
    assert dh.max() <= tol_h and dz.max() <= tol_z, res
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    if args.cards == 4:
        # the unsharded 10M reference peaks near 57 GB on one 80 GB card
        # (fast path, float32): more than the 75% JAX reserves by default
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.92")
    devs = check_device()
    if len(devs) < args.cards:
        raise SystemExit(f"--cards {args.cards}: JAX sees {len(devs)}")
    from ltjax import compile_cache
    cache = compile_cache.configure()
    import bench

    dev = devs[0]
    card = card_line()
    emit("card", nvidia_smi=card, kind=dev.device_kind, count=len(devs),
         compile_cache=cache)
    root = os.path.join(ROOT, ".smoke")
    t_all = time.perf_counter()
    if args.cards == 4:
        emit("sharded", **phase_sharded(os.path.join(root, "sharded"),
                                        numpar=10_000_000))
    else:
        r = phase_cli(os.path.join(root, "cli"), **FULL)
        emit("cli", **r)
        ri = phase_interp(FULL["nx"], FULL["ny"], FULL["us"],
                          FULL["numpar"])
        peak = bench.peak_hbm_bytes_per_s(dev.device_kind)
        emit("interp", **ri, hbm_peak_bytes_per_s=peak,
             share_of_hbm_peak=ri["interp_bytes_per_s"] / peak)
        emit("reference", **phase_reference(100_000))
        emit("paths", **phase_paths(100_000))
        emit("gpu_tests", **phase_gpu_tests())
    emit("done", wall_s=time.perf_counter() - t_all)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

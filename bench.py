"""Throughput benchmark: particle-steps/s per card on the transport path.

Protocol: the flagship case (BASELINE.json config 1 scaled to 1M
particles on a 200x200 grid with 20 s-levels), the same compiled
external step that ``python -m ltjax.run`` uses, external steps of 30
internal steps each, ``block_until_ready`` timing after a warm-up
call, median of the repeats.  Prints ONE JSON line naming the device:

  {"metric": "particle-steps/s@1M", "value": N, "unit": "particle-steps/s",
   "device": {"platform": "gpu", "kind": "...", "count": 1}}

    python bench.py [variant] [numpar]

Runs only on a GPU: a rate measured on the CPU is not a device number.
``build`` is also the case generator of chip_smoke.py and the tests.
"""

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr

from ltjax import compile_cache
from ltjax import synth
from ltjax import state as st
from ltjax.config import Config
from ltjax.fields import FieldSet
from ltjax.physics import boundary as bd
from ltjax.step import StepContext, make_external_step, summary_counts

VARIANTS = ("advect", "turb", "behavior", "dvm", "settle", "salt", "curv")
E_REP = 4         # external steps per timed repeat
REPS = 5

# Device-memory bandwidth by jax device_kind (NVIDIA H100 / H200 data
# sheets: SXM 3.35 TB/s, PCIe 2.0 TB/s, NVL 3.9 TB/s, H200 4.8 TB/s).
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 SXM5 80GB": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
    "NVIDIA H200": 4.8e12,
}


def peak_hbm_bytes_per_s(device_kind: str) -> float:
    """Published device-memory bandwidth; KeyError for an unknown card."""
    return PEAK_HBM_BYTES_PER_S[device_kind]


def interp_bytes(numpar: int, grid, n_int: int, itemsize: int = 4) -> int:
    """Bytes the fast path's interpolation moves in one external step.

    Per internal step: three stage tables (ltjax.packed.collapse_stage)
    each read the (3, C, nv) record table and write (C, 4*HL) pair rows
    plus (C, 8) zeta/h rows; each particle's four RK4 stages gather two
    pair rows apiece and its x, y, z are read and written once.
    """
    from ltjax import packed as pk
    C = grid.ny * grid.nx
    nv = pk.n_value_lanes(grid.us, grid.ws)
    HL = pk.half_lanes(grid.us, grid.ws)
    tables = 3 * (3 * C * nv + C * (4 * HL + 8)) * itemsize
    gathers = numpar * (4 * 2 * 4 * HL + 6) * itemsize
    return n_int * (tables + gathers)


def build(numpar=1_000_000, nx=200, ny=200, us=20, dt=3600, idt=120,
          n_records=3, variant="advect"):
    """variant: "advect" (BASELINE config 1), "turb" (config 2/3:
    HTurb + Visser VTurb on Aks), "behavior" (config-4 style: type-6
    sinking + mortality), "dvm" (type-3 diel vertical migration),
    "settle" (config 4: sinking + settlement polygons), "salt"
    (salinity-cued ontogeny + SaltTempOn sampling), "curv" (config 3's
    curvilinear estuary-style grid).  Lengths scale with the grid so
    small grids keep the same geometry."""
    dtype = jnp.float32
    L = 1000.0 * nx                       # 1 km cells
    kw = {}
    if variant == "turb":
        kw = dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True,
                  readAks=True)
    elif variant == "behavior":
        # slow sinking keeps the front above the bottom log layer over
        # the measured window
        kw = dict(Behavior=6, sink=5e-5, mortality=True, deadage=5e6)
    elif variant == "dvm":
        kw = dict(Behavior=3, swimslow=1e-3, swimfast=3e-3,
                  pediage=5e6)
    elif variant == "settle":
        kw = dict(Behavior=6, sink=5e-5, settlementon=True,
                  pediage=0.0)
    elif variant == "salt":
        kw = dict(Behavior=4, readSalt=True, SaltTempOn=True,
                  swimslow=1e-3, swimfast=3e-3, pediage=5e6,
                  Sgradient=0.5)
    elif variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    cfg = Config(numpar=numpar, dt=dt, idt=idt, us=us, ws=us + 1,
                 OpenOceanBoundary=True, dtype_pos="float32",
                 reflect_iters=2, **kw)
    if variant == "curv":
        case = synth.make_curv_case(nx=nx, ny=ny, us=us, lx=L, ly=L,
                                    h0=50.0, omega=5e-5, amp=0.03,
                                    dtype=dtype)
        grid = case.grid
        bounds = bd.build_boundaries_curv(np.asarray(grid.mask_rho),
                                          case.x2d, case.y2d, grid.curv)
    else:
        case = synth.make_solid_body_case(nx=nx, ny=ny, us=us, lx=L,
                                          ly=L, h0=50.0, omega=5e-5,
                                          dtype=dtype)
        grid = case.grid
        bounds = bd.build_boundaries(np.asarray(grid.mask_rho),
                                     np.asarray(grid.x_rho),
                                     np.asarray(grid.y_rho))
    polys = holes = None
    if variant == "settle":
        from ltjax.physics import settlement as stl
        # a habitat square of 6% of the domain side in the rotation
        # path (config 4 spirit: sparse habitat)
        a, b = 0.6 * L, 0.66 * L
        poly = [(101, np.asarray([[a, a], [b, a], [b, b], [a, b]]))]
        polys = stl.build_polygons(poly, np.asarray(bounds.x_edges),
                                   np.asarray(bounds.y_edges))
    ctx = StepContext(grid=grid, bounds=bounds, polys=polys, holes=holes)
    fs = synth.fieldset_window(case, -float(dt) / 2, float(dt), n_records,
                               dtype=jnp.float32)
    if variant == "turb":
        # parabolic Aks(z) profile so the Visser RDM terms are real
        # (the synthetic case ships zero diffusivity)
        z_w = 50.0 * np.asarray(case.grid.s_w)
        K = 1e-4 + 4e-3 * (1.0 - (2.0 * z_w / 50.0 + 1.0) ** 2)
        fs = fs._replace(aks=jnp.broadcast_to(
            jnp.asarray(K, jnp.float32)[None, None, None, :],
            fs.aks.shape))
    if cfg.needs_salt_fields():
        # salinity increasing with depth (a halocline cue for 4/5)
        z_r = 50.0 * np.asarray(case.grid.s_rho)
        S = (30.0 - 0.05 * z_r).astype(np.float32)
        fs = fs._replace(salt=jnp.broadcast_to(
            jnp.asarray(S)[None, None, None, :], fs.salt.shape))
    rng = np.random.default_rng(0)
    # sinking variants start shallower so the front stays clear of the
    # bottom log layer over the measured window
    z_lo = -25.0 if variant in ("behavior", "settle") else -40.0
    p = st.init_particles(rng.uniform(0.2 * L, 0.8 * L, numpar),
                          rng.uniform(0.2 * L, 0.8 * L, numpar),
                          rng.uniform(z_lo, -5.0, numpar), dtype=dtype)
    p = p._replace(status=jnp.full(numpar, st.ACTIVE, jnp.int32))
    return cfg, ctx, fs, p


def window(fsR: FieldSet, e: int) -> FieldSet:
    """Records [e, e+1, e+2] of a record window (external step e)."""
    return FieldSet(*(a[e:e + 3] for a in fsR[:-1]),
                    times=fsR.times[e:e + 3])


def main():
    variant = sys.argv[1] if len(sys.argv) > 1 else "advect"
    numpar = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    compile_cache.configure()
    cfg, ctx, fsR, p = build(numpar=numpar, n_records=E_REP + 2,
                             variant=variant)
    step = make_external_step(ctx, cfg, jr.key(0))

    def rep(pp):
        for e in range(E_REP):
            pp = step(pp, window(fsR, e), float(e * cfg.dt), e)
        return pp

    p = jax.block_until_ready(rep(p))          # warm-up / compile
    rates = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        p = jax.block_until_ready(rep(p))      # chained: distinct work
        rates.append(cfg.numpar * cfg.internal_steps * E_REP
                     / (time.perf_counter() - t0))
    errs = summary_counts(p)["error"]
    if errs:
        sys.exit(f"{errs} particles ended in ERROR")
    tag = "" if variant == "advect" else f"[{variant}]"
    scale = (f"@{numpar // 1_000_000}M" if numpar >= 1_000_000
             else f"@{numpar}")
    print(json.dumps({
        "metric": f"particle-steps/s{scale}{tag}",
        "value": float(np.median(rates)),
        "unit": "particle-steps/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()

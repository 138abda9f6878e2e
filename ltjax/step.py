"""The time-stepping core: internal step assembly + external-step scan.

Reference: ``run_External_Timestep`` / ``run_Internal_Timestep`` /
``update_particles`` in LTRANS.f90 (SURVEY.md SS3.2 [conf: H]): per
internal step each particle is released/aged, advected by RK4, kicked
by HTurb/VTurb/behavior, boundary-reflected, settled, and sampled.

Design (SURVEY.md SS7.1): one *external* step is a single jitted
``lax.scan`` over the internal steps, with the whole particle batch
updated per operator under status masks — the hot loop never leaves
the device.  All configuration flags are Python constants captured at
trace time, so disabled operators cost nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import packed as pk
from . import state as st
from .config import Config
from .fields import FieldSet
from .grid import Grid
from .physics import behavior as bh
from .physics import boundary as bd
from .physics import settlement as stl
from .physics import turb as tb
from .physics.advect import (AdvectParams, find_currents, rk4_displacement,
                             sample_scalar, zeta_h_at)


class StepContext(NamedTuple):
    """Static per-run data captured by the compiled step."""
    grid: Grid
    bounds: bd.Boundaries
    polys: Optional[stl.Polygons]
    holes: Optional[stl.Polygons]


def make_params(cfg: Config):
    adv = AdvectParams(sigma=cfg.tension_sigma, z0=cfg.z0, idt=float(cfg.idt))
    turb = tb.TurbParams(ConstantHTurb=cfg.ConstantHTurb,
                         ConstantVTurb=cfg.ConstantVTurb,
                         use_aks=cfg.readAks, sigma=cfg.tension_sigma,
                         idt=float(cfg.idt))
    beh = bh.BehaveParams(
        behavior=cfg.Behavior, mortality=cfg.mortality, deadage=cfg.deadage,
        pediage=cfg.pediage, swimstart=cfg.swimstart, swimslow=cfg.swimslow,
        swimfast=cfg.swimfast, Sgradient=cfg.Sgradient, sink=cfg.sink,
        Hswimspeed=cfg.Hswimspeed, Swimdepth=cfg.Swimdepth,
        twistart=cfg.twistart, twiend=cfg.twiend, Em=cfg.Em, Kp=cfg.Kp,
        thresh=cfg.thresh, idt=float(cfg.idt), sigma=cfg.tension_sigma,
        stochastic=cfg.stochastic_mortality)
    return adv, turb, beh


def internal_step(ctx: StepContext, cfg: Config, base_key,
                  p: st.Particles, fields: FieldSet, t, step_idx,
                  prec: "pk.PackedRecords | None" = None) -> st.Particles:
    """One internal timestep for the whole particle batch.

    ``prec`` (packed per-record tables) selects the fast path: advection
    and the zeta/h lookups run on ltjax.packed's stage tables (column
    splines, fit-then-blend); turbulence, behavior and scalar sampling
    keep the native interpolation.  ``prec=None`` is the native path.
    """
    adv, turb, beh = make_params(cfg)
    grid, bounds = ctx.grid, ctx.bounds
    dtype = p.x.dtype
    idt = jnp.asarray(float(cfg.idt), dtype)
    tt = jnp.asarray(t, dtype)
    fast = prec is not None
    if fast:
        tabs = pk.stage_tables(grid, prec, t, float(cfg.idt),
                               cfg.tension_sigma)

    # --- release (DOB reached) & masks ---------------------------------
    release = (p.status == st.NOT_RELEASED) & (tt >= p.dob)
    status = jnp.where(release, st.ACTIVE, p.status)
    active = status == st.ACTIVE

    # --- advection ------------------------------------------------------
    if fast:
        dxa, dya, dza = pk.rk4_displacement_packed(
            grid, tabs, p.x, p.y, p.z, cfg.tension_sigma, cfg.z0,
            float(cfg.idt))
    else:
        dxa, dya, dza = rk4_displacement(grid, fields, p.x, p.y, p.z, tt,
                                         adv)

    dx, dy, dz = dxa, dya, dza

    # --- turbulence -----------------------------------------------------
    if cfg.HTurbOn:
        hx, hy = tb.hturb(base_key, step_idx, p.pid, idt,
                          cfg.ConstantHTurb, dtype)
        dx = dx + hx
        dy = dy + hy
    if cfg.VTurbOn:
        dz = dz + tb.vturb(grid, fields, base_key, step_idx, p.pid,
                           p.x, p.y, p.z, tt, turb)

    # --- behavior -------------------------------------------------------
    dies = jnp.zeros(p.n, bool)
    if cfg.Behavior != 0 or cfg.mortality:
        if fast:
            zeta_p, h_p = pk.zeta_h_packed(grid, tabs[0], p.x, p.y)
        else:
            zeta_p, h_p = zeta_h_at(grid, fields, p.x, p.y, tt)
        if cfg.Behavior == 7:
            if fast:
                cur = pk.find_currents_packed(grid, tabs[0], p.x, p.y,
                                              p.z, cfg.tension_sigma,
                                              cfg.z0)[:2]
            else:
                cur = find_currents(grid, fields, p.x, p.y, p.z, tt,
                                    adv)[:2]
        else:
            cur = (jnp.zeros(p.n, dtype), jnp.zeros(p.n, dtype))
        bx, by, bz, dies = bh.behave(grid, fields, base_key, step_idx,
                                     p.pid, p.x, p.y, p.z, tt, p.age,
                                     zeta_p, h_p, cur, beh)
        dx = dx + bx
        dy = dy + by
        dz = dz + bz

    # --- horizontal boundary reflection ---------------------------------
    x1 = p.x + dx
    y1 = p.y + dy
    xr, yr, hits, exited, stuck = bd.reflect(
        bounds, p.x, p.y, x1, y1,
        open_exits=cfg.OpenOceanBoundary, n_iter=cfg.reflect_iters)

    # --- vertical reflection at the new column --------------------------
    z1 = p.z + dz
    if fast:
        zeta1, h1 = pk.zeta_h_packed(grid, tabs[2], xr, yr)
    else:
        zeta1, h1 = zeta_h_at(grid, fields, xr, yr, tt + idt)
    zr, hit_surf, hit_bot = bd.reflect_vertical(z1, zeta1, h1)

    # --- settlement ------------------------------------------------------
    settles = jnp.zeros(p.n, bool)
    spid = jnp.full(p.n, -1, jnp.int32)
    if cfg.settlementon and ctx.polys is not None:
        eligible = active & ((p.age + idt) >= cfg.pediage) & ~exited & ~stuck
        settles, spid = stl.test_settlement(
            ctx.polys, ctx.holes, bounds.x_edges, bounds.y_edges,
            xr, yr, eligible, uniform=bounds.uniform)

    # --- apply updates under the active mask -----------------------------
    new_x = jnp.where(active, xr, p.x)
    new_y = jnp.where(active, yr, p.y)
    new_z = jnp.where(active, zr, p.z)
    new_age = jnp.where(status >= st.ACTIVE, tt + idt - p.dob, p.age)

    new_status = status
    new_status = jnp.where(active & exited, st.OUT_OF_DOMAIN, new_status)
    new_status = jnp.where(active & stuck, st.ERROR, new_status)
    if cfg.mortality:
        new_status = jnp.where(active & dies & ~exited, st.DEAD, new_status)
    if cfg.settlementon:
        new_status = jnp.where(active & settles & (new_status == st.ACTIVE),
                               st.SETTLED, new_status)

    new_poly = jnp.where((new_status == st.SETTLED) & (p.settle_poly < 0),
                         spid, p.settle_poly)

    hit_land = p.hit_land
    hit_bottom = p.hit_bottom
    if cfg.TrackCollisions:
        hit_land = hit_land + jnp.where(active, hits, 0)
        hit_bottom = hit_bottom + jnp.where(active & hit_bot, 1, 0)

    salt = p.salt
    temp = p.temp
    if cfg.SaltTempOn:
        salt = jnp.where(active, sample_scalar(
            grid, fields, fields.salt, new_x, new_y, new_z, tt + idt,
            cfg.tension_sigma), p.salt)
        temp = jnp.where(active, sample_scalar(
            grid, fields, fields.temp, new_x, new_y, new_z, tt + idt,
            cfg.tension_sigma), p.temp)

    return st.Particles(
        x=new_x, y=new_y, z=new_z, dob=p.dob, age=new_age,
        status=new_status, pid=p.pid, settle_poly=new_poly,
        hit_land=hit_land, hit_bottom=hit_bottom, salt=salt, temp=temp)


def mode_flags(cfg: Config) -> str:
    """The compute path a configuration gets: ``"fast"`` (packed-table
    interpolation, ltjax.packed) or ``"native"`` (reference-ordered
    per-particle interpolation, ltjax.physics.advect).

    Decided from the configuration alone: adaptive tension
    (``tension_sigma < 0``) varies per interval and particle, which
    only the native path implements.
    """
    if cfg.fast_interp and cfg.tension_sigma >= 0:
        return "fast"
    return "native"


def make_external_step(ctx: StepContext, cfg: Config, base_key):
    """Compile one external step: scan of cfg.internal_steps internal
    steps, fields fixed (the triple buffer covers [t_c, t_f]).

    On the fast path the per-record packed tables are built once per
    external step (dense, grid-sized) and the scan body runs the
    gather-optimized interpolation."""
    n_int = cfg.internal_steps
    idt = float(cfg.idt)
    fast = mode_flags(cfg) == "fast"

    @jax.jit
    def ext_step(p: st.Particles, fields: FieldSet, t0, ext_idx):
        prec = pk.build_packed_records(ctx.grid, fields) if fast else None

        def body(carry, i):
            t = t0 + i * idt
            step_idx = ext_idx * n_int + i
            return internal_step(ctx, cfg, base_key, carry, fields, t,
                                 step_idx, prec), None

        p2, _ = jax.lax.scan(body, p, jnp.arange(n_int))
        return p2

    return ext_step


def summary_counts(p: st.Particles):
    """Structured per-step observability counters (SURVEY.md SS5.5)."""
    return {
        "not_released": int(jnp.sum(p.status == st.NOT_RELEASED)),
        "active": int(jnp.sum(p.status == st.ACTIVE)),
        "settled": int(jnp.sum(p.status == st.SETTLED)),
        "dead": int(jnp.sum(p.status == st.DEAD)),
        "out_of_domain": int(jnp.sum(p.status == st.OUT_OF_DOMAIN)),
        "error": int(jnp.sum(p.status == st.ERROR)),
    }

"""RK4 advection through interpolated ROMS velocity fields.

Reference contract (SURVEY.md SS3.2, LTRANS.f90 ``update_particles`` /
``find_currents`` [conf: H structure, M details]):

  find_currents(x, y, z, t) =
    per time level (b, c, f):
      horizontal bilinear interp of every s-level  -> water-column profile
      vertical tension-spline fit + eval at particle z  (WCTS_ITPI)
    quadratic time interpolation across the 3 records  (polintd)
    near-bottom log-layer decay of u, v to zero at roughness z0
  RK4:  k1 at t; k2, k3 at t+dt/2 (midpoint positions); k4 at t+dt;
        displacement = dt*(k1 + 2k2 + 2k3 + k4)/6 per component.

Everything is batched over the full particle vector — no per-particle
loop, no element search (structured-grid index arithmetic instead).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import tension
from ..fields import FieldSet
from ..grid import Grid
from ..interp import (interp2d, interp_columns, locate_rho, locate_u,
                      locate_uvr, locate_v, polintd)
from ..scoord import s_depths


class AdvectParams(NamedTuple):
    """Static-ish numerics parameters for the advection path."""
    sigma: float = 0.0        # spline tension (dimensionless); <0 => adaptive
    z0: float = 0.0005        # bottom roughness height [m]
    idt: float = 120.0        # internal step [s]


def _eval_profile(zk, prof, z, sigma):
    """Fit + evaluate the vertical tension spline per (time, particle).

    zk, prof: (3, N, K); z: (N,) -> (3, N)
    """
    if sigma < 0:
        sig = tension.adaptive_sigma(zk, prof)
    else:
        sig = jnp.asarray(sigma, zk.dtype)
    z2 = tension.fit(zk, prof, sig)
    sigb = jnp.broadcast_to(sig, zk[..., :-1].shape)
    return tension.evaluate(zk, prof, z2, sigb, jnp.broadcast_to(z, zk.shape[:-1]))


def find_currents(grid: Grid, fields: FieldSet, x, y, z, t,
                  params: AdvectParams = AdvectParams()):
    """(u, v, w) at arbitrary particle positions and time.

    Returns velocities in the dtype of x (positions), so f64 runs stay
    f64 end-to-end while f32 runs stay f32.
    """
    dtype = x.dtype
    ((iu, ju, fxu, fyu), (iv, jv, fxv, fyv),
     (ir, jr, fxr, fyr)) = locate_uvr(grid, x, y)

    u_prof = interp_columns(fields.u, iu, ju, fxu.astype(fields.u.dtype),
                            fyu.astype(fields.u.dtype)).astype(dtype)  # (3,N,us)
    v_prof = interp_columns(fields.v, iv, jv, fxv.astype(fields.v.dtype),
                            fyv.astype(fields.v.dtype)).astype(dtype)
    w_prof = interp_columns(fields.w, ir, jr, fxr.astype(fields.w.dtype),
                            fyr.astype(fields.w.dtype)).astype(dtype)  # (3,N,ws)
    zeta_p = interp2d(fields.zeta, ir, jr, fxr.astype(fields.zeta.dtype),
                      fyr.astype(fields.zeta.dtype)).astype(dtype)     # (3,N)
    h_p = interp2d(grid.h, ir, jr, fxr.astype(grid.h.dtype),
                   fyr.astype(grid.h.dtype)).astype(dtype)             # (N,)

    # z of s-levels per time record (zeta varies across records)
    z_r = s_depths(zeta_p, h_p, grid.s_rho.astype(dtype),
                   grid.Cs_r.astype(dtype), grid.hc, grid.vtransform)  # (3,N,us)
    z_w = s_depths(zeta_p, h_p, grid.s_w.astype(dtype),
                   grid.Cs_w.astype(dtype), grid.hc, grid.vtransform)  # (3,N,ws)

    u_l = _eval_profile(z_r, u_prof, z, params.sigma)   # (3, N)
    v_l = _eval_profile(z_r, v_prof, z, params.sigma)
    w_l = _eval_profile(z_w, w_prof, z, params.sigma)

    times = fields.times.astype(dtype)
    u_t = polintd(u_l, times, jnp.asarray(t, dtype))
    v_t = polintd(v_l, times, jnp.asarray(t, dtype))
    w_t = polintd(w_l, times, jnp.asarray(t, dtype))

    # Near-bottom log-layer: u,v decay to 0 at roughness height z0 below
    # the lowest rho level (LTRANS.f90 find_currents [conf: M]).
    z0 = jnp.asarray(params.z0, dtype)
    zab = z + h_p                                   # height above bottom
    ztb = z_r[1, :, 0] + h_p                        # lowest rho level height
    ztb = jnp.maximum(ztb, 2.0 * z0)
    decay = jnp.log(jnp.maximum(zab, z0) / z0) / jnp.log(ztb / z0)
    factor = jnp.where(zab < ztb, jnp.clip(decay, 0.0, 1.0), 1.0)
    return u_t * factor, v_t * factor, w_t


def rk4_displacement(grid: Grid, fields: FieldSet, x, y, z, t,
                     params: AdvectParams = AdvectParams()):
    """One RK4 internal step's advective displacement (dx, dy, dz)."""
    idt = jnp.asarray(params.idt, x.dtype)
    half = 0.5 * idt
    u1, v1, w1 = find_currents(grid, fields, x, y, z, t, params)
    u2, v2, w2 = find_currents(grid, fields, x + u1 * half, y + v1 * half,
                               z + w1 * half, t + half, params)
    u3, v3, w3 = find_currents(grid, fields, x + u2 * half, y + v2 * half,
                               z + w2 * half, t + half, params)
    u4, v4, w4 = find_currents(grid, fields, x + u3 * idt, y + v3 * idt,
                               z + w3 * idt, t + idt, params)
    sixth = idt / 6.0
    dx = sixth * (u1 + 2.0 * u2 + 2.0 * u3 + u4)
    dy = sixth * (v1 + 2.0 * v2 + 2.0 * v3 + v4)
    dz = sixth * (w1 + 2.0 * w2 + 2.0 * w3 + w4)
    return dx, dy, dz


def sample_scalar(grid: Grid, fields: FieldSet, field, x, y, z, t,
                  sigma=0.0):
    """Sample a rho-grid scalar (salt/temp/dens) at particle positions.

    Same interpolation contract as find_currents: horizontal bilinear
    per s-level, time polintd of the profile, vertical tension spline
    (the reference's optional salt/temp sampling, SaltTempOn
    [conf: H feature]).
    """
    dtype = x.dtype
    ir, jr, fxr, fyr = locate_rho(grid, x, y)
    fd = field.dtype
    prof = interp_columns(field, ir, jr, fxr.astype(fd),
                          fyr.astype(fd)).astype(dtype)          # (3,N,us)
    zeta_l = interp2d(fields.zeta, ir, jr, fxr.astype(fd),
                      fyr.astype(fd)).astype(dtype)
    h_p = interp2d(grid.h, ir, jr, fxr.astype(grid.h.dtype),
                   fyr.astype(grid.h.dtype)).astype(dtype)
    times = fields.times.astype(dtype)
    tt = jnp.asarray(t, dtype)
    prof_t = polintd(prof, times, tt)
    zeta_t = polintd(zeta_l, times, tt)
    z_r = s_depths(zeta_t, h_p, grid.s_rho.astype(dtype),
                   grid.Cs_r.astype(dtype), grid.hc, grid.vtransform)
    sig = jnp.asarray(sigma, dtype)
    z2 = tension.fit(z_r, prof_t, sig)
    sigb = jnp.broadcast_to(sig, z_r[..., :-1].shape)
    return tension.evaluate(z_r, prof_t, z2, sigb, z)


def zeta_h_at(grid: Grid, fields: FieldSet, x, y, t):
    """Free surface (time-interpolated) and bathymetry at particles."""
    dtype = x.dtype
    ir, jr, fxr, fyr = locate_rho(grid, x, y)
    zeta_l = interp2d(fields.zeta, ir, jr, fxr.astype(fields.zeta.dtype),
                      fyr.astype(fields.zeta.dtype)).astype(dtype)
    h_p = interp2d(grid.h, ir, jr, fxr.astype(grid.h.dtype),
                   fyr.astype(grid.h.dtype)).astype(dtype)
    zeta_p = polintd(zeta_l, fields.times.astype(dtype), jnp.asarray(t, dtype))
    return zeta_p, h_p

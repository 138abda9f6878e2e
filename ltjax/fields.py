"""Triple-buffered hydrodynamic field slabs (device side).

Reference: the back/center/forward time-record buffers filled by
``initHydro``/``updateHydro`` (hydrodynamic_module.f90, SURVEY.md SS3.3
[conf: H]).  Axis order is (time=3, [level], eta, xi); the record times
ride along as a (3,) array so the whole struct is one jit-able pytree.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class FieldSet(NamedTuple):
    """Level-resolved fields are stored **K-last**: (3, eta, xi, K).

    ROMS files are (K, eta, xi); we transpose on ingest so a particle's
    water-column gather pulls one contiguous K-vector per corner node
    (a row gather) instead of K strided element gathers.  The eta axis is uniformly
    axis 1 for every leaf, which is also what the domain-tile sharding
    slices (ltjax.shard).
    """
    zeta: jax.Array   # (3, Ny, Nx)
    u: jax.Array      # (3, Ny, Nx-1, us)
    v: jax.Array      # (3, Ny-1, Nx, us)
    w: jax.Array      # (3, Ny, Nx, ws)
    aks: jax.Array    # (3, Ny, Nx, ws)   vertical diffusivity at w-levels
    salt: jax.Array   # (3, Ny, Nx, us)  (zeros when SaltTempOn is off)
    temp: jax.Array   # (3, Ny, Nx, us)
    times: jax.Array  # (3,) record times [s since run start]


def _klast(a, dtype):
    """(3, K, eta, xi) -> (3, eta, xi, K), materialized contiguous."""
    if isinstance(a, np.ndarray):
        return jnp.asarray(np.ascontiguousarray(np.moveaxis(a, 1, -1)),
                           dtype)
    return jnp.moveaxis(jnp.asarray(a, dtype), 1, -1) + 0


def make_fieldset(zeta, u, v, w, aks, times, salt=None, temp=None,
                  dtype=jnp.float32) -> FieldSet:
    """Inputs in ROMS record layout (3, K, eta, xi); stored K-last."""
    zeta = jnp.asarray(zeta, dtype)
    u = _klast(u, dtype)
    w = _klast(w, dtype)
    # salt/temp live on the rho grid: (3, Ny, Nx, us)
    rho_shape = w.shape[:3] + u.shape[-1:]
    salt = jnp.zeros(rho_shape, dtype) if salt is None else _klast(salt, dtype)
    temp = jnp.zeros(rho_shape, dtype) if temp is None else _klast(temp, dtype)
    return FieldSet(
        zeta=zeta,
        u=u,
        v=_klast(v, dtype),
        w=w,
        aks=_klast(aks, dtype),
        salt=salt,
        temp=temp,
        times=jnp.asarray(times, jnp.float64
                          if dtype == jnp.float64 else jnp.float32),
    )


def stack_records(recs, t_base, dtype=jnp.float32,
                  with_salt_temp: bool = False) -> FieldSet:
    """Build an R-record FieldSet window from record dicts.

    ``recs``: list of record dicts as produced by
    ltjax.io.roms.RomsSeries.next_record (ROMS ([K,] eta, xi) layout,
    host numpy or device arrays — the prefetcher device_puts them).
    R = 3 is the classic triple buffer (``initHydro``/``updateHydro``,
    SURVEY.md SS3.3).
    """
    def pile(key, klast=True):
        xs = jnp.stack([jnp.asarray(r[key], dtype) for r in recs])
        return jnp.moveaxis(xs, 1, -1) if klast else xs

    zeta = pile("zeta", klast=False)
    u = pile("u")
    w = pile("w")
    rho_shape = w.shape[:3] + u.shape[-1:]
    salt = (pile("salt") if with_salt_temp
            else jnp.zeros(rho_shape, dtype))
    temp = (pile("temp") if with_salt_temp
            else jnp.zeros(rho_shape, dtype))
    tdt = jnp.float64 if dtype == jnp.float64 else jnp.float32
    times = jnp.asarray([float(r["time"]) - float(t_base) for r in recs],
                        tdt)
    return FieldSet(zeta=zeta, u=u, v=pile("v"), w=w, aks=pile("aks"),
                    salt=salt, temp=temp, times=times)


def rotate(fs: FieldSet, zeta, u, v, w, aks, t_new, salt=None, temp=None
           ) -> FieldSet:
    """Shift b<-c, c<-f and install a new forward record (updateHydro).

    New records arrive in ROMS layout ([K,] eta, xi)."""

    def shift(buf, new):
        return jnp.concatenate([buf[1:], new[None].astype(buf.dtype)], axis=0)

    def shift_k(buf, new):
        new = jnp.moveaxis(jnp.asarray(new), 0, -1)  # (K,e,x) -> (e,x,K)
        return jnp.concatenate([buf[1:], new[None].astype(buf.dtype)], axis=0)

    return FieldSet(
        zeta=shift(fs.zeta, jnp.asarray(zeta)),
        u=shift_k(fs.u, u),
        v=shift_k(fs.v, v),
        w=shift_k(fs.w, w),
        aks=shift_k(fs.aks, aks),
        salt=(shift_k(fs.salt, salt) if salt is not None
              else shift(fs.salt, fs.salt[2])),
        temp=(shift_k(fs.temp, temp) if temp is not None
              else shift(fs.temp, fs.temp[2])),
        times=shift(fs.times, jnp.asarray(t_new)),
    )

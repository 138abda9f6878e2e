"""Spatial locality: Hilbert ordering of the particle batch.

Reference: none — the reference visits particles in storage order
(LTRANS.f90 ``do n=1,numpar``).  A cell-order sort of the state puts
particles that read the same grid-table rows next to each other, so
the interpolation gathers hit neighbouring memory.  Relative dispersion
over one external step is small compared to bulk drift, so a sort stays
useful for several steps.

The permutation is applied by packing the 12 state columns into
(N, 16) rows (int columns bitcast to f32) and row-gathering them: one
gather instead of 12.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import state as st

_F = ("x", "y", "z", "dob", "age", "salt", "temp")          # float cols
_I = ("status", "pid", "settle_poly", "hit_land", "hit_bottom")  # int32


def hilbert_key(i, j, bits: int = 15):
    """Hilbert-curve index of non-negative int coords (i=x, j=y).

    Unlike Morton order, a contiguous run of Hilbert indices is always
    spatially connected (bbox ~ O(sqrt(run length))), so fixed-size
    runs of particles cover compact patches of cells with no heavy tail
    of discontinuous runs.

    bits=15 keeps d = x^2-area index < 2^30 (int32-safe); grids are
    far smaller than 32768 cells per side.
    """
    x = jnp.clip(i, 0, (1 << bits) - 1).astype(jnp.uint32)
    y = jnp.clip(j, 0, (1 << bits) - 1).astype(jnp.uint32)
    d = jnp.zeros_like(x)
    s = jnp.uint32(1 << (bits - 1))
    one = jnp.uint32(1)
    for _ in range(bits):
        rx = jnp.where((x & s) > 0, one, 0).astype(jnp.uint32)
        ry = jnp.where((y & s) > 0, one, 0).astype(jnp.uint32)
        d = d + s * s * ((3 * rx) ^ ry)
        # rotate quadrant
        flip = (ry == 0) & (rx == 1)
        xf = jnp.where(flip, s - 1 - x, x)
        yf = jnp.where(flip, s - 1 - y, y)
        swap = ry == 0
        x, y = (jnp.where(swap, yf, xf), jnp.where(swap, xf, yf))
        s = s >> 1
    return d.astype(jnp.int32)


def morton_key(i, j, bits: int = 14):
    """Interleave the bits of two non-negative int32 coords (Z-order)."""
    def spread(v):
        v = v.astype(jnp.uint32) & ((1 << bits) - 1)
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v
    return (spread(i) | (spread(j) << 1)).astype(jnp.int32)


def _pack_rows(p: st.Particles) -> jax.Array:
    """(N, 16) f32 rows; int32 columns ride along bitcast to f32."""
    cols = [p._asdict()[k].astype(jnp.float32) for k in _F]
    cols += [jax.lax.bitcast_convert_type(p._asdict()[k], jnp.float32)
             for k in _I]
    rows = jnp.stack(cols, axis=-1)                       # (N, 12)
    pad = jnp.zeros((rows.shape[0], 16 - rows.shape[1]), jnp.float32)
    return jnp.concatenate([rows, pad], axis=-1)


def _unpack_rows(rows: jax.Array, like: st.Particles) -> st.Particles:
    vals = {}
    for k, c in zip(_F, range(len(_F))):
        vals[k] = rows[:, c].astype(like._asdict()[k].dtype)
    for k, c in zip(_I, range(len(_F), len(_F) + len(_I))):
        vals[k] = jax.lax.bitcast_convert_type(rows[:, c], jnp.int32)
    return st.Particles(**vals)


def sort_by_cell(p: st.Particles, i, j, aspect_y: int = 1,
                 depth_band=None, n_bands: int = 1):
    """Hilbert-sort the state by cell index; returns (p_sorted, perm).

    ``depth_band`` (optional int32 array, values clipped to
    ``[0, n_bands-1]``, ``n_bands`` <= 6): make the band the MAJOR sort
    key, Hilbert order within each band — particles at similar height
    above the seabed share horizontal velocity in depth-sheared flow.
    Banded keys use 14 Hilbert bits (vs 15) so band+frozen fit int32;
    grids are far below 2^14 cells per side either way.

    ``aspect_y`` (power of two): coarsen the eta coordinate by this
    factor in the Hilbert key, so equal-length key runs cover
    ``aspect_y``x more cells in eta than in xi — runs come out tall.

    Frozen particles (settled / dead / out-of-domain / errored — any
    status that can never move again) sort AFTER all live ones: they
    stay wherever they froze while the flow moves on, so leaving them
    inline would scatter stragglers through every run of live ones.

    Requires f32 positions: the permutation row-gather packs every
    column into f32 lanes and preserves each bit pattern exactly.
    """
    if aspect_y > 1:
        j = j >> (int(aspect_y).bit_length() - 1)
    frozen = p.status >= st.SETTLED
    if depth_band is None:
        key = hilbert_key(i, j)                # < 2^30 (bits=15)
        key = key + jnp.where(frozen, jnp.int32(1) << 30, 0)
    else:
        nb = int(n_bands)
        assert 1 <= nb <= 6, "n_bands must be in [1, 6] (int32 key room)"
        key = hilbert_key(i, j, bits=14)       # < 2^28
        band = jnp.clip(depth_band.astype(jnp.int32), 0, nb - 1)
        band = jnp.where(frozen, jnp.int32(7), band)   # frozen sort last
        key = key + (band << 28)               # 7 * 2^28 < 2^31
    perm = jnp.argsort(key)
    rows = _pack_rows(p)[perm]
    return _unpack_rows(rows, p), perm


def unsort(p: st.Particles, perm) -> st.Particles:
    """Invert sort_by_cell's permutation (restores storage order)."""
    n = perm.shape[0]
    inv = jnp.zeros(n, perm.dtype).at[perm].set(
        jnp.arange(n, dtype=perm.dtype))
    rows = _pack_rows(p)[inv]
    return _unpack_rows(rows, p)

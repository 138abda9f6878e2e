"""Counter-based per-particle RNG streams.

Reference: random_module.f90 (a Fortran mt19937 port) + norm_module.f90
(Box-Muller) draw from ONE sequential global stream (SURVEY.md SS2.1
#12/#13 [conf: H]) — order-dependent and unshardable.  The
replacement here derives a Threefry-2x32 block per (seed, step, substream,
particle-id): order- and sharding-invariant and restart-stable
(SURVEY.md SS4 determinism tests).  Exact stochastic-path equality with
the Fortran is impossible by construction; statistical equivalence is
what the well-mixed-condition tests assert.

The generator is implemented HERE in plain jnp uint32 ops (not via
jax.random), so any implementation of the step — an XLA path or a
hand-written kernel — can run the *identical* arithmetic and take the
same stochastic path.  Substream ids keep draws within one internal
step independent.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr

# substream ids
HTURB = 0
VTURB = 1
BEHAVE = 2
MORTALITY = 3   # behavior random-walk mixing draw
DEATH = 4       # stochastic-mortality survival draw (Config.
                #   stochastic_mortality; independent of MORTALITY so
                #   turning the mode on never perturbs the walk)

# plain Python int (a module-level jnp scalar would be a captured
# device constant)
_PARITY = 0x1BD11BDA
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (the jax.random core PRF).

    All args uint32, broadcastable; returns (uint32, uint32).  Written
    with plain jnp ops only, so a hand-written kernel can mirror it.
    """
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    x0 = jnp.asarray(x0, jnp.uint32)
    x1 = jnp.asarray(x1, jnp.uint32)
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(_PARITY))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]

    def rotl(v, r):
        return (v << jnp.uint32(r)) | (v >> jnp.uint32(32 - r))

    for block in range(5):
        for r in range(4):
            x0 = x0 + x1
            x1 = rotl(x1, _ROT[(block % 2) * 4 + r])
            x1 = x1 ^ x0
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + jnp.uint32(block + 1)
    return x0, x1


def seed_words(base_key):
    """(k0, k1) uint32 scalars from a jax PRNG key or an int seed."""
    if isinstance(base_key, (int,)):
        return (jnp.uint32(base_key & 0xFFFFFFFF),
                jnp.uint32((base_key >> 32) & 0xFFFFFFFF))
    kd = jr.key_data(base_key).reshape(-1).astype(jnp.uint32)
    if kd.shape[0] >= 2:
        return kd[0], kd[1]
    return kd[0], jnp.uint32(0)


def stream_key(base_key, step, substream: int):
    """Per-(step, substream) derived key pair (two uint32 scalars)."""
    k0, k1 = seed_words(base_key)
    return threefry2x32(k0, k1, jnp.asarray(step, jnp.uint32),
                        jnp.uint32(substream))


def particle_bits(sk0, sk1, pids):
    """Two uint32 words per particle for a derived stream key."""
    p = pids.astype(jnp.uint32)
    return threefry2x32(sk0, sk1, p, jnp.zeros_like(p))


def bits_to_uniform(bits, dtype=jnp.float32):
    """uint32 -> (0, 1): 24-bit mantissa, offset half an ulp from 0.

    The top 24 bits are moved into an int32 before the float cast —
    the value fits in 24 bits, so the int32 reinterpretation is exact
    and no uint32->float conversion is needed.
    """
    dt = jnp.dtype(dtype).type
    top = jax.lax.bitcast_convert_type(bits >> jnp.uint32(8), jnp.int32)
    return top.astype(dt) * dt(2.0 ** -24) + dt(2.0 ** -25)


def bits_to_symmetric(bits, dtype=jnp.float32):
    """uint32 -> (-1, 1)."""
    dt = jnp.dtype(dtype).type
    return bits_to_uniform(bits, dt) * dt(2.0) - dt(1.0)


def box_muller(b0, b1, dtype=jnp.float32):
    """Two N(0,1) deviates from two uint32 words."""
    dt = jnp.dtype(dtype).type
    u1 = bits_to_uniform(b0, dt)
    u2 = bits_to_uniform(b1, dt)
    r = jnp.sqrt(dt(-2.0) * jnp.log(u1))
    th = dt(2.0 * 3.14159265358979) * u2
    return r * jnp.cos(th), r * jnp.sin(th)


def normal(base_key, step, substream, pids, shape_per=(), dtype=jnp.float32):
    """N(0,1) per particle; shape_per () or (2,) (one Threefry block)."""
    sk0, sk1 = stream_key(base_key, step, substream)
    b0, b1 = particle_bits(sk0, sk1, pids)
    n0, n1 = box_muller(b0, b1, dtype)
    if shape_per == ():
        return n0
    if shape_per == (2,):
        return jnp.stack([n0, n1], axis=-1)
    # wider draws: extra counter-advanced blocks
    outs = [n0, n1]
    need = 1
    for s in shape_per:
        need *= s
    blk = 1
    while len(outs) < need:
        b0, b1 = threefry2x32(sk0, sk1, pids.astype(jnp.uint32),
                              jnp.full_like(pids, blk).astype(jnp.uint32))
        n0, n1 = box_muller(b0, b1, dtype)
        outs += [n0, n1]
        blk += 1
    return jnp.stack(outs[:need], axis=-1).reshape(pids.shape + shape_per)


def uniform(base_key, step, substream, pids, shape_per=(),
            minval=0.0, maxval=1.0, dtype=jnp.float32):
    """U(minval, maxval) per particle; shape_per () or (2,)."""
    sk0, sk1 = stream_key(base_key, step, substream)
    b0, b1 = particle_bits(sk0, sk1, pids)
    dt = jnp.dtype(dtype).type
    u0 = bits_to_uniform(b0, dt)
    u1 = bits_to_uniform(b1, dt)
    lo = dt(minval)
    span = dt(maxval) - dt(minval)
    if shape_per == ():
        return lo + span * u0
    assert shape_per == (2,), shape_per
    return jnp.stack([lo + span * u0, lo + span * u1], axis=-1)

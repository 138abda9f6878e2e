"""Batched tension-spline interpolation (TSPACK-subset analog).

Reference: ``tension_module.f90`` — a subset of TSPACK (Renka, ACM TOMS
716) used by the reference for ALL vertical water-column interpolation
(velocities, Aks, salt, temp): construction ``TSPSI`` + evaluation
``HVAL``/``HPVAL`` (SURVEY.md SS2.1 #11 [conf: H TSPACK, M routine set]).

This is NOT a port of TSPACK.  We use the classic C2 spline-under-
tension formulation (Cline, CACM 1974): on each interval the
interpolant satisfies H'''' = T^2 H'' and is written in terms of knot
second derivatives z_i obtained from a tridiagonal system, with natural
end conditions (z_0 = z_{n-1} = 0).  Tension is the dimensionless
per-interval parameter u = T*h (TSPACK's normalization): u -> 0 gives
the natural cubic spline, u -> inf the linear interpolant.

Everything is batched over arbitrary leading axes and jit/vmap-safe:
knots may differ per batch element (each particle's water column has
its own z-levels).  The tridiagonal solve is a Thomas-algorithm
``lax.scan`` over the ~20 vertical levels with the particle batch
vectorized.

Interval form used everywhere below (h = x_{j+1}-x_j, B2 = (x-x_j)/h,
B1 = 1-B2, u = tension):

  H(x)  = y_j*B1 + y_{j+1}*B2 + h^2 * (z_j*gs(u,B1) + z_{j+1}*gs(u,B2))
  H'(x) = (y_{j+1}-y_j)/h + h * (z_j*ds(u,B1) - z_{j+1}*ds(u,B2))

  gs(u,B) = (sinh(u*B)/sinh(u) - B) / u^2     -> (B^3-B)/6   as u->0
  ds(u,B) = (1 - u*cosh(u*B)/sinh(u)) / u^2   -> 1/6 - B^2/2 as u->0

Small-u branches use series accurate to O(u^6) so the implementation is
stable in float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

def _u_small(dtype):
    """Series/exact crossover for the dimensionless tension.

    The exact branch loses ~eps/u^2 relative accuracy to cancellation,
    so the crossover is dtype-aware: tight for f64 (the series is
    near-machine-accurate there), wide for f32.
    """
    return 0.02 if jnp.finfo(dtype).bits >= 64 else 0.5


def _gs(u, B):
    """(sinh(uB)/sinh(u) - B)/u^2, stable for all u >= 0."""
    u = jnp.asarray(u)
    B = jnp.asarray(B)
    small = _u_small(jnp.result_type(u, B))
    us = jnp.where(u < small, 1.0, u)  # safe value for exact branch
    # Exact branch via exponentials (no overflow for large u):
    #   sinh(uB)/sinh(u) = exp(u(B-1)) * (1-exp(-2uB)) / (1-exp(-2u))
    ratio = jnp.exp(us * (B - 1.0)) * (-jnp.expm1(-2.0 * us * B)) / (
        -jnp.expm1(-2.0 * us)
    )
    exact = (ratio - B) / (us * us)
    # Series branch: sinh x = x(1 + x^2/6 + x^4/120 + x^6/5040 + ...)
    #   gs = B*[(B^2-1)/6 + u^2(B^4-1)/120 + u^4(B^6-1)/5040] / (1+c)
    u2 = u * u
    B2 = B * B
    c = u2 / 6.0 + u2 * u2 / 120.0 + u2 * u2 * u2 / 5040.0
    series = B * ((B2 - 1.0) / 6.0 + u2 * (B2 * B2 - 1.0) / 120.0
                  + u2 * u2 * (B2 * B2 * B2 - 1.0) / 5040.0) / (1.0 + c)
    return jnp.where(u < small, series, exact)


def _ds(u, B):
    """(1 - u*cosh(uB)/sinh(u))/u^2, stable for all u >= 0."""
    u = jnp.asarray(u)
    B = jnp.asarray(B)
    small = _u_small(jnp.result_type(u, B))
    us = jnp.where(u < small, 1.0, u)
    #   u*cosh(uB)/sinh(u) = u * exp(u(B-1)) * (1+exp(-2uB)) / (1-exp(-2u))
    ratio = us * jnp.exp(us * (B - 1.0)) * (1.0 + jnp.exp(-2.0 * us * B)) / (
        -jnp.expm1(-2.0 * us)
    )
    exact = (1.0 - ratio) / (us * us)
    # Series: u cosh(uB)/sinh(u) = (1 + u^2B^2/2 + u^4B^4/24 + ...)/(1+c)
    #   => ds = [(1/6 - B^2/2) + u^2(1/120 - B^4/24) + u^4(1/5040 - B^6/720)]
    #           / (1+c)
    u2 = u * u
    B2 = B * B
    c = u2 / 6.0 + u2 * u2 / 120.0 + u2 * u2 * u2 / 5040.0
    series = ((1.0 / 6.0 - B2 / 2.0) + u2 * (1.0 / 120.0 - B2 * B2 / 24.0)
              + u2 * u2 * (1.0 / 5040.0 - B2 * B2 * B2 / 720.0)) / (1.0 + c)
    return jnp.where(u < small, series, exact)


def _coefs(u, h):
    """Tridiagonal coefficients for one interval.

    off(u,h)  = (h/u^2)(1 - u/sinh u)      -> h/6 as u->0
    diag(u,h) = (h/u^2)(u*coth u - 1)      -> h/3 as u->0
    """
    small = _u_small(jnp.result_type(u, h))
    us = jnp.where(u < small, 1.0, u)
    # u/sinh(u) = 2u e^{-u} / (1-e^{-2u});  u coth u = u(1+e^{-2u})/(1-e^{-2u})
    em = -jnp.expm1(-2.0 * us)
    u_over_sinh = 2.0 * us * jnp.exp(-us) / em
    u_coth = us * (1.0 + jnp.exp(-2.0 * us)) / em
    off_e = (h / (us * us)) * (1.0 - u_over_sinh)
    diag_e = (h / (us * us)) * (u_coth - 1.0)
    u2 = u * u
    off_s = h * (1.0 / 6.0 - 7.0 * u2 / 360.0 + 31.0 * u2 * u2 / 15120.0)
    diag_s = h * (1.0 / 3.0 - u2 / 45.0 + 2.0 * u2 * u2 / 945.0)
    off = jnp.where(u < small, off_s, off_e)
    diag = jnp.where(u < small, diag_s, diag_e)
    return off, diag


def _thomas(dl, d, du, b):
    """Batched Thomas tridiagonal solve along the LAST axis.

    dl/d/du/b: (..., n); dl[...,0] and du[...,n-1] ignored.  The solve
    axis is the small vertical-level count (~20), so it is UNROLLED:
    XLA fuses the whole recurrence into a few kernels over the big
    batch axes, instead of a 2n-step sequential scan that materializes
    every carry.
    """
    n = d.shape[-1]
    if n > 64:  # fall back to scan for unusually deep columns
        return _thomas_scan(dl, d, du, b)
    cp = jnp.zeros_like(d[..., 0])
    dp = jnp.zeros_like(d[..., 0])
    cps, dps = [], []
    for i in range(n):
        denom = d[..., i] - dl[..., i] * cp
        cp = du[..., i] / denom
        dp = (b[..., i] - dl[..., i] * dp) / denom
        cps.append(cp)
        dps.append(dp)
    x = jnp.zeros_like(d[..., 0])
    xs = [None] * n
    for i in reversed(range(n)):
        x = dps[i] - cps[i] * x
        xs[i] = x
    return jnp.stack(xs, axis=-1)


def _thomas_scan(dl, d, du, b):
    n = d.shape[-1]
    dl_t = jnp.moveaxis(dl, -1, 0)
    d_t = jnp.moveaxis(d, -1, 0)
    du_t = jnp.moveaxis(du, -1, 0)
    b_t = jnp.moveaxis(b, -1, 0)

    def fwd(carry, inp):
        cp_prev, dp_prev = carry
        dli, di, dui, bi = inp
        denom = di - dli * cp_prev
        cp = dui / denom
        dp = (bi - dli * dp_prev) / denom
        return (cp, dp), (cp, dp)

    zeros = jnp.zeros_like(d_t[0])
    (_, _), (cps, dps) = jax.lax.scan(fwd, (zeros, zeros),
                                      (dl_t, d_t, du_t, b_t))

    def bwd(x_next, inp):
        cp, dp = inp
        x = dp - cp * x_next
        return x, x

    _, xs = jax.lax.scan(bwd, zeros, (cps, dps), reverse=True)
    return jnp.moveaxis(xs, 0, -1)


def fit(xk, yk, sigma):
    """Fit the C2 tension spline: return knot second derivatives z2.

    xk, yk: (..., n) knots (xk strictly increasing along last axis).
    sigma:  scalar or (..., n-1) per-interval dimensionless tension.
    Natural end conditions (z2 = 0 at both ends).
    """
    h = xk[..., 1:] - xk[..., :-1]                     # (..., n-1)
    dy = (yk[..., 1:] - yk[..., :-1]) / h              # slopes
    sig = jnp.broadcast_to(jnp.asarray(sigma, h.dtype), h.shape)
    off, dia = _coefs(sig, h)                          # (..., n-1)

    n = xk.shape[-1]
    # Interior equations i=1..n-2:
    #   off_{i-1} z_{i-1} + (dia_{i-1}+dia_i) z_i + off_i z_{i+1}
    #       = dy_i - dy_{i-1}
    # Assemble full-size system with identity rows at the ends (z=0).
    dl = jnp.concatenate([jnp.zeros_like(off[..., :1]), off], axis=-1)
    du = jnp.concatenate([off, jnp.zeros_like(off[..., :1])], axis=-1)
    d = jnp.concatenate(
        [jnp.ones_like(off[..., :1]),
         dia[..., :-1] + dia[..., 1:],
         jnp.ones_like(off[..., :1])], axis=-1)
    # zero out the off-diagonals of the identity end rows
    dl = dl.at[..., -1].set(0.0) if n > 1 else dl
    du = du.at[..., 0].set(0.0)
    b = jnp.concatenate(
        [jnp.zeros_like(off[..., :1]),
         dy[..., 1:] - dy[..., :-1],
         jnp.zeros_like(off[..., :1])], axis=-1)
    return _thomas(dl, d, du, b)


def _interval_index(xk, x):
    """Index j of the interval containing x (clamped to [0, n-2]).

    xk: (..., n); x: (...,) broadcastable to xk[..., 0].
    """
    n = xk.shape[-1]
    j = jnp.sum((x[..., None] >= xk[..., 1:]).astype(jnp.int32), axis=-1)
    return jnp.clip(j, 0, n - 2)


def _gather_intervals(x, xk, arrs):
    """Select per-query interval endpoints WITHOUT a lane gather.

    ``take_along_axis`` over the minor axis is a per-element dynamic
    gather.  Instead build the one-hot interval mask (..., n-1) once and reduce
    each requested (left, right) endpoint pair with multiplies+sums —
    pure VPU work.

    arrs: list of (..., n) knot arrays; returns the flat list
    [a0_left, a0_right, a1_left, a1_right, ...].
    """
    n = xk.shape[-1]
    j = _interval_index(xk, x)
    one_hot = (j[..., None]
               == jnp.arange(n - 1, dtype=j.dtype)).astype(xk.dtype)
    out = []
    for a in arrs:
        out.append(jnp.sum(a[..., :-1] * one_hot, axis=-1))
        out.append(jnp.sum(a[..., 1:] * one_hot, axis=-1))
    return out


def evaluate(xk, yk, z2, sigma, x):
    """Evaluate the tension spline at x (HVAL analog).

    x is clamped to the knot range (the reference clamps evaluation to
    the water column rather than extrapolating [conf: M]).
    """
    x = jnp.clip(x, xk[..., 0], xk[..., -1])
    sig = jnp.broadcast_to(jnp.asarray(sigma, xk.dtype),
                           xk[..., :-1].shape)
    sig = jnp.concatenate([sig, sig[..., -1:]], axis=-1)  # pad to n
    x0, x1, y0, y1, zz0, zz1, u, _ = _gather_intervals(
        x, xk, [xk, yk, z2, sig])
    h = x1 - x0
    B2 = (x - x0) / h
    B1 = 1.0 - B2
    return y0 * B1 + y1 * B2 + h * h * (zz0 * _gs(u, B1) + zz1 * _gs(u, B2))


def evaluate_deriv(xk, yk, z2, sigma, x):
    """Evaluate dH/dx at x (HPVAL analog); x clamped to knot range."""
    x = jnp.clip(x, xk[..., 0], xk[..., -1])
    sig = jnp.broadcast_to(jnp.asarray(sigma, xk.dtype),
                           xk[..., :-1].shape)
    sig = jnp.concatenate([sig, sig[..., -1:]], axis=-1)
    x0, x1, y0, y1, zz0, zz1, u, _ = _gather_intervals(
        x, xk, [xk, yk, z2, sig])
    h = x1 - x0
    B2 = (x - x0) / h
    B1 = 1.0 - B2
    return (y1 - y0) / h + h * (zz0 * _ds(u, B1) - zz1 * _ds(u, B2))


def adaptive_sigma(xk, yk, sigma_max=15.0):
    """Per-interval tension selection (SIGS-like heuristic).

    TSPACK's SIGS picks minimal tension preserving local monotonicity /
    convexity of the data [conf: M on the reference's exact use].  We use
    a deterministic 2-pass scheme: fit a cubic (sigma=0), compute knot
    derivatives, and where the Fritsch-Carlson monotonicity bounds
    (0 <= d/slope <= 3) are violated on a locally monotone interval,
    raise tension proportionally to the violation.
    """
    z2 = fit(xk, yk, jnp.zeros(()))
    h = xk[..., 1:] - xk[..., :-1]
    dy = (yk[..., 1:] - yk[..., :-1]) / h
    # knot derivative at the left/right ends of each interval (cubic z-form)
    d_left = dy - z2[..., :-1] * h / 3.0 - z2[..., 1:] * h / 6.0
    d_right = dy + z2[..., 1:] * h / 3.0 + z2[..., :-1] * h / 6.0
    eps = jnp.asarray(1e-30, h.dtype)
    slope = jnp.where(jnp.abs(dy) < eps, eps, dy)
    a = d_left / slope
    b = d_right / slope
    viol = jnp.maximum(jnp.maximum(-a, a - 3.0), jnp.maximum(-b, b - 3.0))
    sig = jnp.clip(3.0 * jnp.maximum(viol, 0.0), 0.0, sigma_max)
    return sig


def fit_eval(xk, yk, sigma, x):
    """Convenience: fit then evaluate (negative sigma => adaptive)."""
    if isinstance(sigma, (int, float)) and sigma < 0:
        sigma = adaptive_sigma(xk, yk)
    z2 = fit(xk, yk, sigma)
    return evaluate(xk, yk, z2, sigma, x)

"""Polynomial root finding on device.

The reference solves minimal-solver polynomials with a companion-matrix /
Durand-Kerner pair (base/polynomial.cc: FindPolynomialRootsCompanionMatrix,
FindPolynomialRootsDurandKerner). XLA lowers non-symmetric
eigendecomposition only on the CPU (jnp.linalg.eig), so the device choice is
Durand-Kerner: a fixed-length
simultaneous-iteration in complex64 that vmaps cleanly over hypothesis banks
(one RANSAC bank = thousands of degree-10 polynomials solved in one dispatch).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

Array = jax.Array


def polyval(coeffs: Array, z: Array) -> Array:
    """Evaluate a polynomial (highest-degree coefficient first) at z.

    coeffs [..., n+1] broadcasts against z [...] (real or complex)."""
    out = jnp.zeros_like(z) + coeffs[..., 0]
    for k in range(1, coeffs.shape[-1]):
        out = out * z + coeffs[..., k]
    return out


def polyder(coeffs: Array) -> Array:
    """Derivative coefficients (highest first)."""
    n = coeffs.shape[-1] - 1
    if n == 0:
        return jnp.zeros_like(coeffs[..., :1])
    powers = jnp.arange(n, 0, -1, dtype=coeffs.dtype)
    return coeffs[..., :-1] * powers


def find_roots(coeffs: Array, iters: int = 80, newton_iters: int = 3):
    """All complex roots of real polynomials via Durand-Kerner.

    coeffs: [..., n+1] real, highest-degree first. Returns (roots [..., n]
    complex64, ok [...] bool — False where the leading coefficient vanishes
    relative to the rest, i.e. the polynomial is of lower degree).

    Fixed iteration count keeps the whole solve one traced program; a short
    Newton polish on each root recovers the f32 accuracy Durand-Kerner's
    simultaneous update leaves on clustered roots.
    """
    deg = coeffs.shape[-1] - 1
    scale = jnp.max(jnp.abs(coeffs), axis=-1, keepdims=True)
    scale = jnp.where(scale > 0, scale, 1.0)
    c = coeffs / scale

    # geometric balancing z = s*u: minimal-solver polynomials routinely have
    # |lead| ~ 1e-7 * max|c| (near-infinite roots); monic division then
    # overflows f32 and Durand-Kerner emits NaNs. Choosing
    # s = (max|c_k>0| / |lead|)^(1/deg) makes the balanced lead coefficient
    # EQUAL to the largest magnitude, so monic normalization is always safe;
    # roots are mapped back by z = s*u at the end.
    lead_abs = jnp.abs(c[..., 0])
    tail_max = jnp.maximum(jnp.max(jnp.abs(c[..., 1:]), axis=-1), 1e-30)
    ok = lead_abs > 1e-30
    # clamp log(s) to 7 => s <= ~1100, keeping s^deg f32-safe for deg <= 10
    s = jnp.exp(
        jnp.clip(
            (jnp.log(tail_max) - jnp.log(jnp.maximum(lead_abs, 1e-30))) / deg,
            0.0,
            7.0,
        )
    )
    powers = s[..., None] ** jnp.arange(deg, -1, -1, dtype=jnp.float32)
    cb = c * powers
    lead = cb[..., :1]
    monic = cb / jnp.where(jnp.abs(lead) > 1e-30, lead, 1.0)
    monic_c = monic.astype(jnp.complex64)

    # classic DK init: powers of (0.4 + 0.9i) — not a root of unity, so
    # conjugate-symmetric configurations cannot lock the iteration
    base = jnp.power(
        jnp.asarray(0.4 + 0.9j, jnp.complex64),
        jnp.arange(1, deg + 1, dtype=jnp.float32),
    )
    z = jnp.broadcast_to(base, coeffs.shape[:-1] + (deg,))

    eye = jnp.eye(deg, dtype=bool)

    def dk_step(z, _):
        pz = polyval(monic_c[..., None, :], z)
        diff = z[..., :, None] - z[..., None, :]
        diff = jnp.where(eye, 1.0, diff)
        denom = jnp.prod(diff, axis=-1)
        denom = jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
        return z - pz / denom, None

    z, _ = jax.lax.scan(dk_step, z, None, length=iters)

    dmonic = polyder(monic_c)

    def newton_step(z, _):
        pz = polyval(monic_c[..., None, :], z)
        dz = polyval(dmonic[..., None, :], z)
        dz = jnp.where(jnp.abs(dz) < 1e-20, 1e-20, dz)
        return z - pz / dz, None

    z, _ = jax.lax.scan(newton_step, z, None, length=newton_iters)
    return z * s[..., None].astype(jnp.complex64), ok


def real_roots(coeffs: Array, rel_imag_tol: float = 1e-2, **kw):
    """Real roots of real polynomials: (roots [..., n] f32, valid [..., n]).

    A root counts as real when |imag| <= tol * (1 + |real|); invalid slots
    carry 0.0 with valid=False (fixed shapes for RANSAC banks)."""
    z, ok = find_roots(coeffs, **kw)
    re, im = jnp.real(z), jnp.imag(z)
    valid = (jnp.abs(im) <= rel_imag_tol * (1.0 + jnp.abs(re))) & ok[..., None]
    return jnp.where(valid, re, 0.0), valid

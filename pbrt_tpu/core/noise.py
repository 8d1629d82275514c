"""Perlin gradient noise + fBm / turbulence.

Reference analogue: /root/reference/src/pbrt/util/noise.h/.cpp (Noise, FBm,
Turbulence — used by the FBm/Windy/Wrinkled/Marble textures). Hash-based
gradients (no permutation tables) so the lattice hashing is pure
arithmetic.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import rng


def _gradient_dot(ix, iy, iz, fx, fy, fz):
    """Dot of a hashed lattice gradient with the offset vector."""
    h, _, _, _ = rng.pcg4d(ix, iy, iz, 0x9E3779B9)
    h = h & 15
    # 12 gradient directions (Perlin's scheme, branchless selection).
    u = jnp.where(h < 8, fx, fy)
    v = jnp.where(h < 4, fy, jnp.where((h == 12) | (h == 14), fx, fz))
    su = jnp.where((h & 1) == 0, u, -u)
    sv = jnp.where((h & 2) == 0, v, -v)
    return su + sv


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin(p):
    """Perlin noise at points p (..., 3) -> (...,) in about [-1, 1]."""
    pi = jnp.floor(p)
    pf = p - pi
    ix = pi[..., 0].astype(jnp.int32)
    iy = pi[..., 1].astype(jnp.int32)
    iz = pi[..., 2].astype(jnp.int32)
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]
    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def g(dx, dy, dz):
        return _gradient_dot(
            ix + dx, iy + dy, iz + dz, fx - dx, fy - dy, fz - dz
        )

    x00 = g(0, 0, 0) + u * (g(1, 0, 0) - g(0, 0, 0))
    x10 = g(0, 1, 0) + u * (g(1, 1, 0) - g(0, 1, 0))
    x01 = g(0, 0, 1) + u * (g(1, 0, 1) - g(0, 0, 1))
    x11 = g(0, 1, 1) + u * (g(1, 1, 1) - g(0, 1, 1))
    y0 = x00 + v * (x10 - x00)
    y1 = x01 + v * (x11 - x01)
    return y0 + w * (y1 - y0)


def fbm(p, octaves: int = 6, omega: float = 0.5):
    """Fractional Brownian motion (Noise summed over octaves)."""
    total = jnp.zeros(p.shape[:-1], p.dtype)
    lam = 1.0
    o = 1.0
    for _ in range(octaves):
        total = total + o * perlin(p * lam)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p, octaves: int = 6, omega: float = 0.5):
    """Sum of |noise| octaves (Turbulence, noise.cpp)."""
    total = jnp.zeros(p.shape[:-1], p.dtype)
    lam = 1.0
    o = 1.0
    for _ in range(octaves):
        total = total + o * jnp.abs(perlin(p * lam))
        lam *= 1.99
        o *= omega
    return total

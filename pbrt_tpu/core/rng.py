"""Stateless counter-based RNG for Monte Carlo sampling.

Reference analogue: PCG32 (/root/reference/src/pbrt/util/rng.h:25-34). The
C++ renderer carries mutable RNG state per thread; here every random number
is instead a *pure hash* of its coordinates (pixel, sample index, bounce,
dimension, seed) so the whole render is a deterministic function and any ray
can be replayed bit-exactly (the stateless `--debugstart`).

Hash: pcg3d/pcg4d-style mixed-congruential finalizers (Jarzynski & Olano,
"Hash Functions for GPU Rendering", JCGT 2020 — public domain algorithm).
All ops are uint32 with wrapping arithmetic.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def _u32(x):
    if isinstance(x, int):
        return _U32(x & 0xFFFFFFFF)
    return jnp.asarray(x).astype(_U32)


def hash_u32(x):
    """lowbias32 finalizer (Wellons): uint32 -> well-mixed uint32."""
    x = _u32(x)
    x ^= x >> 16
    x *= _U32(0x7FEB352D)
    x ^= x >> 15
    x *= _U32(0x846CA68B)
    x ^= x >> 16
    return x


def pcg4d(a, b, c, d):
    """4D -> 4D hash; returns four decorrelated uint32 streams."""
    v0, v1, v2, v3 = _u32(a), _u32(b), _u32(c), _u32(d)
    mul = _U32(1664525)
    inc = _U32(1013904223)
    v0 = v0 * mul + inc
    v1 = v1 * mul + inc
    v2 = v2 * mul + inc
    v3 = v3 * mul + inc
    v0 += v1 * v3
    v1 += v2 * v0
    v2 += v0 * v1
    v3 += v1 * v2
    v0 ^= v0 >> 16
    v1 ^= v1 >> 16
    v2 ^= v2 >> 16
    v3 ^= v3 >> 16
    v0 += v1 * v3
    v1 += v2 * v0
    v2 += v0 * v1
    v3 += v1 * v2
    return v0, v1, v2, v3


def u32_to_uniform(bits):
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def uniform_1d(pixel, sample, dim, seed=0):
    """One uniform float per (pixel, sample, dimension, seed) coordinate."""
    v0, _, _, _ = pcg4d(pixel, sample, dim, seed)
    return u32_to_uniform(v0)


def uniform_2d(pixel, sample, dim, seed=0):
    v0, v1, _, _ = pcg4d(pixel, sample, dim, seed)
    return u32_to_uniform(v0), u32_to_uniform(v1)


def uniform_4d(pixel, sample, dim, seed=0):
    return tuple(u32_to_uniform(v) for v in pcg4d(pixel, sample, dim, seed))

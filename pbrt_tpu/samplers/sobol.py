"""Exact Sobol' sequence evaluation from Joe-Kuo generator matrices.

The checked-in table (data/sobol_matrices.npy, regenerated by
tools/gen_sobol_tables.py) holds the 32-bit generator matrices of the first
256 dimensions of the Joe & Kuo (2008) new-joe-kuo-6 direction numbers —
public scientific data, same category as the CIE tables.

Reference analogue: SobolSample / SobolSampleBits
(/root/reference/src/pbrt/util/lowdiscrepancy.h:230-258) over
util/sobolmatrices.cpp. The C++ walks index bits with a data-dependent loop;
here a fixed 32-step fori_loop XOR-accumulates masked direction vectors —
branch-free and identical for every lane.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32

N_SOBOL_DIMS = 256


@functools.lru_cache(maxsize=1)
def _matrices_np() -> np.ndarray:
    path = os.path.join(os.path.dirname(__file__), "data", "sobol_matrices.npy")
    arr = np.load(path)
    assert arr.shape == (N_SOBOL_DIMS, 32) and arr.dtype == np.uint32
    return arr


def matrices() -> jnp.ndarray:
    """(256, 32) uint32 direction vectors; row d = dimension d.

    NOT cached as a jnp array: jnp.asarray inside a jit trace would yield a
    tracer, and caching that leaks it into later traces. The numpy table is
    cached; each trace embeds it as a constant.
    """
    return jnp.asarray(_matrices_np())


def sobol_bits(idx, dim):
    """Sobol' value (as uint32 in [0, 2^32)) of sample `idx` in dimension
    `dim`.

    idx: (...,) integer sample indices; dim: scalar (python int or traced)
    dimension, taken mod 256. The dimension row is fetched with a
    dynamic_slice (no per-lane gather — this backend lowers gathers
    per-element).
    """
    m = matrices()
    dim = jnp.asarray(dim, jnp.int32) % N_SOBOL_DIMS
    row = jax.lax.dynamic_slice_in_dim(m, dim, 1, axis=0)[0]  # (32,) uint32
    idx = jnp.asarray(idx).astype(_U32)

    def body(b, v):
        take = ((idx >> b) & _U32(1)).astype(_U32)
        return v ^ (take * row[b])

    return jax.lax.fori_loop(0, 32, body, jnp.zeros_like(idx))

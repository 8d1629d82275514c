"""Row gathers for the renderer's table lookups (materials, lights, small
geometry tables)."""

from __future__ import annotations

import jax.numpy as jnp


def gather_rows(table, idx):
    """table: (M, ...) array; idx: (N,) int32 -> (N, ...) gathered rows.

    jnp.asarray: callers may pass numpy tables (module-scope constants are
    kept numpy so imports never initialize the backend), and
    numpy.__getitem__ rejects traced indices.
    """
    return jnp.asarray(table)[idx]

"""Zero-gradient wrappers for intersection queries.

Visibility is discrete: the renderer's documented differentiation stance
(SURVEY.md section 7, parallel/train.py) is that gradients flow through
shading, emission and transmittance at FIXED hit points, while geometric /
discrete events are detached — matching differentiable-rendering practice
when silhouette terms are not needed. The Pallas traversal kernels
(ops/smallscene.py, ops/sweep.py) have no autodiff rules at all, so
without this wrapper reverse-mode over a kernel render fails outright;
with it, `jax.grad` of a full render works on every accelerator path and
produces exactly the detached-geometry gradients the dense jnp path
produces.

Reference analogue: the reference has no gradient system at all; this is
green-field per SURVEY.md section 5.8.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def detached_query(impl):
    """Wrap impl(accel, o, d, tmax, **static_kwargs) with a custom VJP
    returning zero cotangents for every input. Static keyword arguments
    (any_hit, interpret, block sizes, ...) pass through as hashable aux."""

    @functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
    def call(accel, o, d, tmax, static_kv):
        return impl(accel, o, d, tmax, **dict(static_kv))

    def fwd(accel, o, d, tmax, static_kv):
        out = impl(accel, o, d, tmax, **dict(static_kv))
        return out, (accel, o, d, tmax)

    def bwd(static_kv, res, g):
        accel, o, d, tmax = res

        def zero(x):
            # Integer leaves take float0 cotangents per JAX convention.
            if jnp.issubdtype(x.dtype, jnp.inexact):
                return jnp.zeros_like(x)
            import numpy as np

            return np.zeros(x.shape, jax.dtypes.float0)

        za = jax.tree_util.tree_map(zero, accel)
        return (za, jnp.zeros_like(o), jnp.zeros_like(d),
                jnp.zeros_like(tmax))

    call.defvjp(fwd, bwd)

    @functools.wraps(impl)
    def wrapper(accel, o, d, tmax, **kwargs):
        kwargs.setdefault("any_hit", False)
        kwargs.setdefault("interpret", False)
        return call(accel, o, d, tmax, tuple(sorted(kwargs.items())))

    return wrapper

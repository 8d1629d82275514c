"""Function integrator: sampler-evaluation test renders.

Reference analogue: FunctionIntegrator (cpu/integrators.h /
integrators.cpp): every pixel Monte-Carlo-integrates a known 2D test
function with the active sampler, so rendered-error images compare sampler
quality directly (the tool behind pbrt's sampler-convergence figures).
Batched form: one jit evaluates all pixels x samples at once.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..core.pytree import pytree, static_field

_FUNCTIONS = {
    # name -> (f(u, v), exact integral over [0,1]^2)
    "uniform": (lambda u, v: jnp.ones_like(u), 1.0),
    "linear": (lambda u, v: u, 0.5),
    "quadratic": (lambda u, v: u * v, 0.25),
    "sin": (
        lambda u, v: jnp.sin(jnp.pi * u) * jnp.sin(jnp.pi * v),
        (2.0 / jnp.pi) ** 2,
    ),
    "step": (lambda u, v: (u < 0.5).astype(jnp.float32) * 2.0, 1.0),
    "gaussian": (
        # exp(-50 r^2) about the center; separable, integral via erf.
        lambda u, v: jnp.exp(-50.0 * ((u - 0.5) ** 2 + (v - 0.5) ** 2)),
        (math.sqrt(math.pi / 50.0) * math.erf(0.5 * math.sqrt(50.0))) ** 2,
    ),
}


@pytree
class FunctionIntegrator:
    func: str = static_field(default="quadratic")
    skip_bad: bool = static_field(default=False)

    def render(self, resolution, spp: int, sampler_kind: str = "independent",
               seed: int = 0):
        """(ny, nx) per-pixel estimates + the exact integral value."""
        from ..samplers.samplers import Sampler

        nx, ny = resolution
        f, exact = _FUNCTIONS[self.func]
        sampler = Sampler.create(
            sampler_kind, spp=spp, seed=seed, nx=nx,
            log2_res=max(1, (max(nx, ny) - 1).bit_length()),
        )
        npix = nx * ny
        pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (spp,))
        sidx = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)

        @jax.jit
        def run(pixel, sidx):
            u, v = sampler.get_2d(pixel, sidx, 0)
            return jnp.mean(f(u, v).reshape(spp, ny, nx), axis=0)

        return run(pixel, sidx), exact

"""PSS-MLT (primary-sample-space Metropolis light transport) integrator.

Reference analogue: MLTIntegrator + MLTSampler
(/root/reference/src/pbrt/cpu/integrators.h:411-460,
 cpu/integrators.cpp:3026-3290): bootstrap a normalization constant b and
stationary chain seeds, then run Markov chains in [0,1)^D primary sample
space with Kelemen-style small/large-step mutations, splatting BOTH the
current and the proposed state with multiple-importance weights
(integrators.cpp:3219-3245).

Redesign (vs the reference's one-thread-per-chain + mutable
MLTSampler streams):

  * n_chains chains advance in LOCKSTEP: one lax.scan whose body evaluates
    the contribution function ONCE for all chains as a single batched
    wavefront trace — the Markov dependency is across *steps*, not across
    chains, so the chain axis is perfectly data-parallel.
  * The mutable lazily-evolved MLTSampler (samplers.h:910) becomes a dense
    (n_chains, D, 2) primary-sample tensor mutated EVERY step (the lazy
    per-dimension replay exists only to save scalar work on CPUs; a dense
    vector op is cheaper here) and replayed through `PSSSampler`, a drop-in
    object for the sampler protocol (get_1d/get_2d by dimension slot).
  * The underlying path is the spectral Path integrator (NEE+MIS) rather
    than the reference's BDPT-with-stream-splitting; the Markov layer is
    identical, the inner estimator differs (documented divergence — BDPT
    connections inside MLT need per-strategy splat queues that serialize
    badly; full-path contributions keep the hot loop a pure wavefront).

Estimator bookkeeping (balance heuristic over the "uniform large step" and
"stationary chain" techniques, per mutation step):

  splat(u') += rgb(u') * (a + 1{large}) / (p_large + y(u')/b)
  splat(u)  += rgb(u)  * (1 - a)        / (p_large + y(u)/b)
  image      = splat * npix / n_total_steps

with a = min(1, y'/y), y = luminance, b = E_uniform[y] from bootstrap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng, spectrum
from ..core.pytree import pytree, static_field
from ..films.rgb import spectrum_to_rgb
from ..scene import Scene
from .path import PathIntegrator

_LUM = np.asarray([0.2126729, 0.7151522, 0.0721750], np.float32)


@pytree
class PSSSampler:
    """Replay sampler: serves stored primary-sample-space coordinates.

    Mirrors MLTSampler::Get1D/Get2D (reference samplers.h:910-960) minus the
    lazy mutation bookkeeping: every dimension slot is already up to date.
    u has shape (N, D, 2) — one 2-vector per dimension *slot* so a get_2d
    never aliases the neighboring slot's get_1d.
    """

    u: jnp.ndarray  # (N, D, 2) in [0, 1)

    def _col(self, dim):
        d = jnp.clip(jnp.asarray(dim, jnp.int32), 0, self.u.shape[1] - 1)
        return jax.lax.dynamic_index_in_dim(self.u, d, axis=1, keepdims=False)

    def get_1d(self, pixel, sample_idx, dim):
        return self._col(dim)[:, 0]

    def get_2d(self, pixel, sample_idx, dim):
        c = self._col(dim)
        return c[:, 0], c[:, 1]


def _contribution(scene: Scene, camera, integrator, u):
    """Evaluate the path contribution function at PSS points u (N, D, 2).

    Dimension-slot layout matches render.camera_rays_full + PathIntegrator:
    slot 0 = film position (here: the WHOLE image, not one pixel's jitter),
    slot 2 = lens, slot 4 = hero wavelength, slots >= 8 = path decisions.
    Returns (pix, rgb, y): int32 pixel ids, (N, 3) sample value, luminance.
    """
    nx, ny = camera.resolution
    n = u.shape[0]
    pf = u[:, 0, :] * jnp.asarray([nx, ny], jnp.float32)
    out = camera.generate_rays(pf, u[:, 2, :])
    if len(out) == 3:
        o, d, w = out
    else:
        (o, d), w = out, jnp.ones((n,), jnp.float32)
    wl = spectrum.sample_visible(u[:, 4, 0])
    pixel = (
        jnp.clip(pf[:, 1].astype(jnp.int32), 0, ny - 1) * nx
        + jnp.clip(pf[:, 0].astype(jnp.int32), 0, nx - 1)
    )
    sampler = PSSSampler(u=u)
    L = integrator.trace(scene, o, d, wl, pixel, jnp.int32(0), sampler)
    rgb = spectrum_to_rgb(L, wl) * w[:, None]
    rgb = jnp.where(jnp.all(jnp.isfinite(rgb), axis=-1, keepdims=True), rgb, 0.0)
    y = jnp.maximum(jnp.sum(rgb * _LUM, axis=-1), 0.0)
    return pixel, rgb, y


def _uniform_block(chain, step, seed, n_vals):
    """(N, n_vals) decorrelated uniforms keyed by (chain, step, slot, seed)."""
    slots = jnp.arange(n_vals, dtype=jnp.int32)
    v0, _, _, _ = rng.pcg4d(
        chain[:, None], slots[None, :], step, seed ^ 0x6D2B79F5
    )
    return rng.u32_to_uniform(v0)


@pytree
class MLTIntegrator:
    """Metropolis over primary sample space; see module docstring."""

    base: PathIntegrator
    n_chains: int = static_field(default=4096)
    mutations_per_chain: int = static_field(default=256)
    bootstrap_factor: int = static_field(default=4)  # bootstrap = factor*chains
    sigma: float = static_field(default=0.01)
    p_large: float = static_field(default=0.3)

    @property
    def n_dims(self) -> int:
        return 8 + 8 * self.base.max_depth

    # -- bootstrap (integrators.cpp:3094-3132) -------------------------------

    def _bootstrap(self, scene, camera, seed: int):
        """Estimate b = E[y] and draw stationary chain starts ~ y."""
        d = self.n_dims
        n = self.n_chains
        eval_c = jax.jit(
            lambda u: _contribution(scene, camera, self.base, u)[2]
        )
        ys, us = [], []
        for k in range(self.bootstrap_factor):
            chain = jnp.arange(n, dtype=jnp.int32)
            bits = _uniform_block(chain, jnp.int32(-1 - k), jnp.int32(seed), d * 2)
            u = bits.reshape(n, d, 2)
            ys.append(np.asarray(eval_c(u)))
            us.append(np.asarray(u))
        y = np.concatenate(ys)
        u_all = np.concatenate(us)
        b = float(y.mean())
        if not (b > 0.0):
            return 0.0, jnp.asarray(u_all[:n])
        # Resample chain starts proportional to y — exactly the stationary
        # target, so no burn-in is needed (the reference's argument).
        cdf = np.cumsum(y)
        r = (np.arange(n) + np.random.default_rng(seed).random(n)) / n
        idx = np.searchsorted(cdf, r * cdf[-1], side="right")
        idx = np.clip(idx, 0, len(y) - 1)
        return b, jnp.asarray(u_all[idx])

    # -- mutation pass (integrators.cpp:3138-3260) ---------------------------

    def render(self, scene: Scene, camera, seed: int = 0) -> jnp.ndarray:
        """Run the chains; returns the (ny, nx, 3) linear-RGB image."""
        nx, ny = camera.resolution
        npix = nx * ny
        b, u0 = self._bootstrap(scene, camera, seed)
        if b == 0.0:
            return jnp.zeros((ny, nx, 3), jnp.float32)

        n, d = self.n_chains, self.n_dims
        chain = jnp.arange(n, dtype=jnp.int32)
        sig = self.sigma
        p_large = self.p_large

        @jax.jit
        def run(u0):
            pix0, rgb0, y0 = _contribution(scene, camera, self.base, u0)
            init = {
                "u": u0,
                "pix": pix0,
                "rgb": rgb0,
                "y": y0,
                "splat": jnp.zeros((npix + 1, 3), jnp.float32),
            }

            def step(carry, t):
                xi = _uniform_block(chain, t, jnp.int32(seed), 2 * d + 2)
                u_ctl = xi[:, :2]
                is_large = u_ctl[:, 0] < p_large
                # Small step: wrapped Gaussian perturbation, the reference's
                # ErfInv construction (samplers.h:938-947) with n_small = 1
                # because every dimension is refreshed every step.
                z = xi[:, 2:].reshape(n, d, 2)
                gauss = jnp.sqrt(2.0) * jax.scipy.special.erfinv(
                    jnp.clip(2.0 * z - 1.0, -0.99999994, 0.99999994)
                )
                u_small = (carry["u"] + sig * gauss) % 1.0
                u_prop = jnp.where(is_large[:, None, None], z, u_small)
                u_prop = jnp.clip(u_prop, 0.0, 1.0 - 1e-7)

                pix_p, rgb_p, y_p = _contribution(
                    scene, camera, self.base, u_prop
                )
                a = jnp.minimum(1.0, y_p / jnp.maximum(carry["y"], 1e-24))
                a = jnp.where(y_p <= 0.0, 0.0, a)

                w_prop = (a + is_large.astype(jnp.float32)) / (
                    p_large + y_p / b
                )
                w_cur = (1.0 - a) / (p_large + carry["y"] / b)
                splat = carry["splat"]
                splat = splat.at[pix_p].add(rgb_p * w_prop[:, None])
                splat = splat.at[carry["pix"]].add(
                    carry["rgb"] * w_cur[:, None]
                )

                acc = xi[:, 1] < a
                return {
                    "u": jnp.where(acc[:, None, None], u_prop, carry["u"]),
                    "pix": jnp.where(acc, pix_p, carry["pix"]),
                    "rgb": jnp.where(acc[:, None], rgb_p, carry["rgb"]),
                    "y": jnp.where(acc, y_p, carry["y"]),
                    "splat": splat,
                }, None

            final, _ = jax.lax.scan(
                step, init, jnp.arange(self.mutations_per_chain),
                length=self.mutations_per_chain,
            )
            total = self.n_chains * self.mutations_per_chain
            return final["splat"][:npix].reshape(ny, nx, 3) * (
                npix / total
            )

        return run(u0)


def render_mlt(scene, camera, max_depth: int = 5, seed: int = 0,
               mutations_per_pixel: int = 32, n_chains: int = 4096,
               sigma: float = 0.01, p_large: float = 0.3) -> jnp.ndarray:
    """Convenience wrapper sized like the reference CLI knobs
    (mutationsperpixel, chains; integrators.cpp:3272-3290)."""
    nx, ny = camera.resolution
    total = mutations_per_pixel * nx * ny
    mpc = max(1, total // n_chains)
    integ = MLTIntegrator(
        base=PathIntegrator(max_depth=max_depth),
        n_chains=n_chains,
        mutations_per_chain=mpc,
        sigma=sigma,
        p_large=p_large,
    )
    return integ.render(scene, camera, seed=seed)

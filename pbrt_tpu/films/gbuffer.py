"""GBuffer film: geometric/shading AOVs alongside radiance.

Reference analogue: GBufferFilm (/root/reference/src/pbrt/film.h:325-433)
with the ISET fork's extensions (film.h:155-156, 328-333): position, normal,
uv, albedo, depth, material id, instance/primitive id, per-pixel variance,
and optional per-wavelength-bucket radiance with SVD spectral-basis
compression at write time (film.cpp:836-1005).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..accel import api as accel_api
from ..core import rgb2spec
from ..core.vecmath import dot
from ..render import camera_rays
from .rgb import spectrum_to_rgb


def render_aovs(scene, camera, integrator, spp: int = 4, seed: int = 0,
                spectral_buckets: int = 0):
    """Render radiance + first-hit AOVs. Returns a dict of (ny, nx, C) arrays.

    Channels mirror GBufferFilm: rgb, p, n, uv, depth, albedo_rgb,
    material_id, prim_id, valid, variance (per-pixel luminance variance over
    samples), and optionally 'spectral' (ny, nx, spectral_buckets).
    """
    import jax

    from ..samplers.samplers import Sampler

    nx, ny = camera.resolution
    npix = nx * ny
    sampler = Sampler.create("independent", spp=spp, seed=seed)
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (spp,))
    sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)

    @jax.jit
    def run(scene):
        o, d, wl = camera_rays(camera, pixel, sample, sampler)
        radiance = integrator.trace(scene, o, d, wl, pixel, sample, sampler)
        rgb = spectrum_to_rgb(radiance, wl)  # (spp*npix, 3)

        # First-hit geometry AOVs (VisibleSurface, film.h:137-157).
        isect = accel_api.closest(scene, o, d)
        ns = isect.n * jnp.sign(
            jnp.where(
                dot(isect.n, isect.wo, keepdims=True) == 0.0,
                1.0,
                dot(isect.n, isect.wo, keepdims=True),
            )
        )
        params = scene.materials.gather(isect.mat)
        # Exact albedo RGB: project the fitted sigmoid spectrum back through
        # the albedo round-trip matrix (same quadrature used by the fit).
        rgb_from_s, lamq = rgb2spec._projection("srgb")
        alb_spec = rgb2spec.eval_sigmoid(params["albedo_coeffs"], lamq)
        albedo_rgb = alb_spec @ rgb_from_s.T  # (N, 3)

        def avg(x):
            return jnp.mean(x.reshape((spp, ny, nx) + x.shape[1:]), axis=0)

        lum = jnp.mean(rgb, axis=-1).reshape(spp, ny, nx)
        mean_l = jnp.mean(lum, axis=0)
        var = jnp.mean((lum - mean_l[None]) ** 2, axis=0) * (
            spp / max(spp - 1, 1)
        )

        out = {
            "rgb": avg(rgb),
            "p": avg(isect.p),
            "n": avg(ns),
            "uv": avg(isect.uv),
            "depth": avg(jnp.where(isect.valid, isect.t, 0.0)),
            "albedo_rgb": avg(albedo_rgb),
            "material_id": avg(isect.mat.astype(jnp.float32)),
            "prim_id": avg(isect.prim.astype(jnp.float32)),
            "valid": avg(isect.valid.astype(jnp.float32)),
            "variance": var,
        }
        if spectral_buckets > 0:
            from ..core import spectrum as spec_mod

            b = jnp.clip(
                (
                    (wl.lam - spec_mod.LAMBDA_MIN)
                    / (spec_mod.LAMBDA_MAX - spec_mod.LAMBDA_MIN)
                    * spectral_buckets
                ).astype(jnp.int32),
                0,
                spectral_buckets - 1,
            )
            oh = jax.nn.one_hot(b, spectral_buckets, dtype=radiance.dtype)
            w = spec_mod.safe_div(radiance, wl.pdf)
            spectral = jnp.einsum(
                "ns,nsb->nb", w, oh, precision=jax.lax.Precision.HIGHEST
            ) / radiance.shape[-1]
            out["spectral"] = avg(spectral)
        return out

    return {k: np.asarray(v) for k, v in run(scene).items()}


def spectral_basis_compress(spectral_img: np.ndarray, n_basis: int = 6):
    """SVD spectral-basis compression of a (ny, nx, B) radiance image.

    Reference: the ISET fork's Eigen BDCSVD compression at GBuffer write time
    (film.cpp:836-1005): returns (coefficients (ny, nx, n_basis),
    basis (n_basis, B)) with img ~= coeffs @ basis.
    """
    ny, nx, b = spectral_img.shape
    flat = spectral_img.reshape(-1, b)
    u, s, vt = np.linalg.svd(flat, full_matrices=False)
    basis = vt[:n_basis]  # (n_basis, B)
    coeffs = flat @ basis.T
    return coeffs.reshape(ny, nx, n_basis), basis

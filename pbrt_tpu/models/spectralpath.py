"""SpectralPath: chromatic-aberration band rendering (the ISET integrator).

Reference analogue: SpectralPathIntegrator
(/root/reference/src/pbrt/cpu/integrators.h:382-416, integrators.cpp:
2477-2951): the visible range is split into `numCABands` bands; each band is
traced with its own camera rays so wavelength-dependent optics (lens/eye
dispersion) produce true longitudinal/lateral chromatic aberration, and the
film accumulates per-band spectral radiance.

Design: bands are a python loop around the jitted per-band render (one
compile; band data are traced arguments), each band restricting
hero-wavelength sampling to its sub-range and regenerating camera rays via a
`camera_for_band` callback (e.g. a Navarro eye rebuilt at the band's center
wavelength).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import spectrum
from ..films.rgb import spectrum_to_rgb
from ..models.path import PathIntegrator
from ..render import camera_rays_full
from ..samplers.samplers import Sampler


def sample_band_wavelengths(u, band_lo, band_hi):
    """Hero sampling restricted to [band_lo, band_hi]."""
    rng_ = band_hi - band_lo
    lam0 = band_lo + u[..., None] * rng_
    delta = rng_ / spectrum.N_SPECTRUM
    offsets = jnp.arange(spectrum.N_SPECTRUM, dtype=lam0.dtype) * delta
    lam = lam0 + offsets
    lam = jnp.where(lam > band_hi, lam - rng_, lam)
    pdf = jnp.full_like(lam, 1.0 / rng_)
    return spectrum.SampledWavelengths(lam=lam, pdf=pdf)


def render_spectral(
    scene,
    camera_or_factory,
    n_bands: int = 8,
    spp_per_band: int = 8,
    seed: int = 0,
    max_depth: int = 5,
    integrator=None,
):
    """Render per-CA-band. Returns (rgb (ny,nx,3), spectral (ny,nx,n_bands)).

    camera_or_factory: a camera, or a callable band_center_nm -> camera
    (dispersion hook). The per-band estimate integrates radiance over its
    band; summing bands reproduces the full-range estimate.
    """
    factory = (
        camera_or_factory
        if callable(camera_or_factory) and not hasattr(camera_or_factory, "resolution")
        else (lambda lam_c: camera_or_factory)
    )
    camera0 = factory(560.0)
    nx, ny = camera0.resolution
    npix = nx * ny
    integ = integrator or PathIntegrator(max_depth=max_depth)
    sampler = Sampler.create("independent", spp=spp_per_band, seed=seed)

    edges = np.linspace(
        spectrum.LAMBDA_MIN, spectrum.LAMBDA_MAX, n_bands + 1
    )

    @jax.jit
    def render_band(camera_pytree, lo, hi):
        pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (spp_per_band,))
        sample = jnp.repeat(
            jnp.arange(spp_per_band, dtype=jnp.int32), npix
        )
        o, d, _, w = camera_rays_full(camera_pytree, pixel, sample, sampler)
        u_wl = sampler.get_1d(pixel, sample, 4)
        wl = sample_band_wavelengths(u_wl, lo, hi)
        radiance = integ.trace(scene, o, d, wl, pixel, sample, sampler)
        rgb = spectrum_to_rgb(radiance, wl) * w[:, None]
        rgb_img = jnp.mean(rgb.reshape(spp_per_band, ny, nx, 3), axis=0)
        # Band-integrated spectral radiance (mean of L/pdf over samples).
        band_val = jnp.mean(
            spectrum.safe_div(radiance, wl.pdf), axis=-1
        ) * w
        band_img = jnp.mean(
            band_val.reshape(spp_per_band, ny, nx), axis=0
        ) / (hi - lo)
        return rgb_img, band_img

    rgb_acc = np.zeros((ny, nx, 3), np.float32)
    bands = np.zeros((ny, nx, n_bands), np.float32)
    for b in range(n_bands):
        lo, hi = float(edges[b]), float(edges[b + 1])
        cam = factory(0.5 * (lo + hi))
        rgb_img, band_img = render_band(
            cam, jnp.float32(lo), jnp.float32(hi)
        )
        # Each band estimates its own sub-range integral (pdf restricted to
        # the band), so the full-range RGB is the SUM over bands.
        rgb_acc += np.asarray(rgb_img)
        bands[..., b] = np.asarray(band_img)
    return rgb_acc, bands

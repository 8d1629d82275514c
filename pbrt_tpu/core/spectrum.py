"""Sampled spectra and hero-wavelength sampling.

Reference analogue: SampledSpectrum / SampledWavelengths in
/root/reference/src/pbrt/util/spectrum.h:36-380. The ISET fork carries **31**
spectral samples per ray over 395-705 nm (spectrum.h:34-36); we carry **32**
(`N_SPECTRUM`), a power of two — one extra Monte Carlo wavelength sample,
identical estimator semantics.

A SampledSpectrum here is simply a float array whose trailing axis has extent
N_SPECTRUM; all arithmetic is plain jnp. SampledWavelengths is a pytree of
(lambda, pdf) arrays.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import cie
from .pytree import pytree

# Spectral lane count. Default 32 = the ISET fork's 31 samples plus one
# (spectrum.h:34). Upstream pbrt-v4 uses 4 hero wavelengths;
# set PBRT_TPU_NSPECTRUM=4/8 for the cheaper upstream-style mode (identical
# estimator semantics, ~4-8x less spectral compute per ray, slightly higher
# color noise at equal spp).
import os as _os

N_SPECTRUM = int(_os.environ.get("PBRT_TPU_NSPECTRUM", "32"))
LAMBDA_MIN = cie.LAMBDA_MIN
LAMBDA_MAX = cie.LAMBDA_MAX
_RANGE = LAMBDA_MAX - LAMBDA_MIN


@pytree
class SampledWavelengths:
    """Per-ray wavelength samples and their sampling pdfs.

    lam: (..., N_SPECTRUM) wavelengths in nm
    pdf: (..., N_SPECTRUM) pdf of each sample (0 marks a terminated lane)
    """

    lam: jnp.ndarray
    pdf: jnp.ndarray

    @property
    def hero(self):
        return self.lam[..., 0]

    def terminate_secondary(self):
        """Collapse to the hero wavelength after a dispersive event.

        Reference: SampledWavelengths::TerminateSecondary
        (src/pbrt/util/spectrum.h:346-353).
        """
        already = self.pdf[..., 1] == 0.0
        new_pdf = jnp.concatenate(
            [
                self.pdf[..., :1] / N_SPECTRUM,
                jnp.zeros_like(self.pdf[..., 1:]),
            ],
            axis=-1,
        )
        pdf = jnp.where(already[..., None], self.pdf, new_pdf)
        return SampledWavelengths(lam=self.lam, pdf=pdf)

    def secondary_terminated(self):
        return self.pdf[..., 1] == 0.0


def sample_uniform_hero(u):
    """Hero-wavelength sampling: one uniform hero + rotated strata.

    u: (...,) uniform samples. Returns SampledWavelengths with shape
    (..., N_SPECTRUM). Reference: SampledWavelengths::SampleUniform
    (src/pbrt/util/spectrum.h:303-320).
    """
    lam0 = LAMBDA_MIN + u[..., None] * _RANGE
    delta = _RANGE / N_SPECTRUM
    offsets = jnp.arange(N_SPECTRUM, dtype=lam0.dtype) * delta
    lam = lam0 + offsets
    lam = jnp.where(lam > LAMBDA_MAX, lam - _RANGE, lam)
    pdf = jnp.full_like(lam, 1.0 / _RANGE)
    return SampledWavelengths(lam=lam, pdf=pdf)


# --- Visible-sensitivity importance sampling -------------------------------
# pdf(lambda) proportional to sech^2(0.0072 (lambda - 538)); analytically
# invertible CDF. Reference: SampleVisibleWavelengths / VisibleWavelengthsPDF
# (src/pbrt/util/spectrum.h:357-380); the formula is from PBRT (public).
_VIS_A = 0.0072
_VIS_MU = 538.0


def _visible_pdf(lam):
    inside = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    norm = _VIS_A / (
        jnp.tanh(_VIS_A * (LAMBDA_MAX - _VIS_MU))
        - jnp.tanh(_VIS_A * (LAMBDA_MIN - _VIS_MU))
    )
    return jnp.where(inside, norm / jnp.cosh(_VIS_A * (lam - _VIS_MU)) ** 2, 0.0)


def _visible_sample(u):
    t0 = jnp.tanh(_VIS_A * (LAMBDA_MIN - _VIS_MU))
    t1 = jnp.tanh(_VIS_A * (LAMBDA_MAX - _VIS_MU))
    return _VIS_MU + jnp.arctanh(t0 + u * (t1 - t0)) / _VIS_A


def sample_visible(u):
    """Hero sampling with the visible-sensitivity importance distribution."""
    up = u[..., None] + jnp.arange(N_SPECTRUM, dtype=jnp.result_type(u, jnp.float32)) / N_SPECTRUM
    up = jnp.where(up > 1.0, up - 1.0, up)
    lam = _visible_sample(up)
    pdf = _visible_pdf(lam)
    return SampledWavelengths(lam=lam, pdf=pdf)


# --- Spectrum -> color ------------------------------------------------------


def safe_div(a, b):
    return jnp.where(b != 0.0, a / jnp.where(b == 0.0, 1.0, b), 0.0)


def to_xyz(values, wl: SampledWavelengths):
    """Monte Carlo estimate of the XYZ tristimulus of a sampled spectrum.

    values: (..., N_SPECTRUM); returns (..., 3).
    Reference: SampledSpectrum::ToXYZ (src/pbrt/util/spectrum.cpp).
    """
    cmf = cie.cie_xyz(wl.lam)  # (..., S, 3)
    integrand = safe_div(values, wl.pdf)[..., None] * cmf
    return jnp.mean(integrand, axis=-2) / cie.CIE_Y_INTEGRAL


def luminance(values, wl: SampledWavelengths):
    y = cie.cie_y(wl.lam)
    return jnp.mean(safe_div(values, wl.pdf) * y, axis=-1) / cie.CIE_Y_INTEGRAL


def average(values):
    return jnp.mean(values, axis=-1)


# --- Spectrum distributions evaluated at sampled wavelengths ---------------


def constant(value, lam):
    return jnp.broadcast_to(jnp.asarray(value)[..., None], lam.shape)


def piecewise_linear(lams_table, vals_table, lam):
    """Evaluate a piecewise-linear spectrum at sampled wavelengths.

    Reference: PiecewiseLinearSpectrum (src/pbrt/util/spectrum.h:478).
    """
    return jnp.interp(lam, lams_table, vals_table)


def blackbody_normalized(lam, temperature_k):
    return cie.normalized_blackbody(lam, temperature_k)

"""CIE colorimetry data: color matching functions and standard illuminants.

Reference analogue: the embedded CIE tables in
/root/reference/src/pbrt/util/spectrum.cpp:2666-2690. Rather than embedding
the 1-nm CIE 1931 tables, we use the multi-lobe Gaussian analytic fits of
Wyman, Sloan & Shirley, "Simple Analytic Approximations to the CIE XYZ Color
Matching Functions" (JCGT 2013) — sub-1% error, branch-free, and evaluable at
arbitrary wavelengths without gathers. The D65 illuminant uses the
standard published 10-nm CIE table with linear interpolation.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Visible range used throughout (matches the ISET fork:
# src/pbrt/util/spectrum.h:34-36 — LambdaMin 395, LambdaMax 705).
LAMBDA_MIN = 395.0
LAMBDA_MAX = 705.0


def _gauss(lam, alpha, mu, sigma1, sigma2):
    """Piecewise (asymmetric) Gaussian lobe used by the Wyman et al. fits.

    Written against numpy so build-time fitting never dispatches device
    ops; the render-time device path goes through the Chebyshev series
    below instead."""
    sigma = np.where(lam < mu, sigma1, sigma2)
    t = (lam - mu) / sigma
    return alpha * np.exp(-0.5 * t * t)


def _cie_x_gauss(lam):
    return (
        _gauss(lam, 1.056, 599.8, 37.9, 31.0)
        + _gauss(lam, 0.362, 442.0, 16.0, 26.7)
        + _gauss(lam, -0.065, 501.1, 20.4, 26.2)
    )


def _cie_y_gauss(lam):
    return _gauss(lam, 0.821, 568.8, 46.9, 40.5) + _gauss(
        lam, 0.286, 530.9, 16.3, 31.1
    )


def _cie_z_gauss(lam):
    return _gauss(lam, 1.217, 437.0, 11.8, 36.0) + _gauss(
        lam, 0.681, 459.0, 26.0, 13.8
    )


# Device-side evaluation uses Chebyshev series fitted to the Gaussian-lobe
# curves (Clenshaw = pure fused mul-adds; the lobes cost ~14 exp per sample).
_CHEB_LO, _CHEB_HI, _CHEB_DEG = 360.0, 830.0, 48
_CHEB_XYZ = None


def _cheb_xyz():
    global _CHEB_XYZ
    if _CHEB_XYZ is None:
        from . import cheb

        # Pure host-side fit: never touches the XLA backend, so
        # `import pbrt_tpu` stays backend-free (multi-process workers call
        # jax.distributed.initialize first) and scene build pays no RPCs.
        _CHEB_XYZ = tuple(
            cheb.chebfit_fn(fn, _CHEB_LO, _CHEB_HI, _CHEB_DEG)
            for fn in (_cie_x_gauss, _cie_y_gauss, _cie_z_gauss)
        )
    return _CHEB_XYZ


def cie_x(lam):
    from . import cheb

    return jnp.maximum(
        cheb.chebeval(lam, _cheb_xyz()[0], _CHEB_LO, _CHEB_HI), 0.0
    )


def cie_y(lam):
    from . import cheb

    return jnp.maximum(
        cheb.chebeval(lam, _cheb_xyz()[1], _CHEB_LO, _CHEB_HI), 0.0
    )


def cie_z(lam):
    from . import cheb

    return jnp.maximum(
        cheb.chebeval(lam, _cheb_xyz()[2], _CHEB_LO, _CHEB_HI), 0.0
    )


def cie_xyz(lam):
    """Stacked (..., 3) color matching functions."""
    return jnp.stack([cie_x(lam), cie_y(lam), cie_z(lam)], axis=-1)


# Integral of cie_y over the visible range; normalizes XYZ so that a constant
# unit spectrum under illuminant E maps to Y == 1 luminance-relative units.
# Computed once on host from the same analytic fit for self-consistency
# (reference analogue: CIE_Y_integral, src/pbrt/util/spectrum.h).
def _compute_y_integral() -> float:
    from . import cheb

    lam = np.linspace(360.0, 830.0, 4701)
    y = np.maximum(
        cheb.chebeval_np(lam, _cheb_xyz()[1], _CHEB_LO, _CHEB_HI), 0.0
    )
    return float(np.trapezoid(y, lam))


def __getattr__(name):
    # PEP 562 lazy attribute: materializing this constant evaluates a jnp
    # expression, which initializes the XLA backend — deferring it keeps
    # `import pbrt_tpu` backend-free so jax.distributed.initialize can run
    # first in multi-process workers (parallel/mp_worker.py).
    if name == "CIE_Y_INTEGRAL":
        val = _compute_y_integral()
        globals()["CIE_Y_INTEGRAL"] = val
        return val
    raise AttributeError(name)

# --- Standard illuminant D65, CIE publication values, 10 nm from 380 nm,
# normalized to 100 at 560 nm. Public colorimetric data.
_D65_LAMBDA_START = 380.0
_D65_STEP = 10.0
_D65_VALUES = np.array(
    [
        49.9755, 54.6482, 82.7549, 91.486, 93.4318, 86.6823, 104.865,
        117.008, 117.812, 114.861, 115.923, 108.811, 109.354, 107.802,
        104.790, 107.689, 104.405, 104.046, 100.000, 96.3342, 95.788,
        88.6856, 90.0062, 89.5991, 87.6987, 83.2886, 83.6992, 80.0268,
        80.2146, 82.2778, 78.2842, 69.7213, 71.6091, 74.349, 61.604,
        69.8856, 75.087, 63.5927, 46.4182, 66.8054, 63.3828,
    ],
    dtype=np.float32,
)
_D65_LAMBDAS = _D65_LAMBDA_START + _D65_STEP * np.arange(len(_D65_VALUES))


def illuminant_d65(lam):
    """Relative spectral power of CIE D65 (100 at 560 nm).

    Evaluated as an exact hat-basis sum over the uniform 10nm table —
    identical to linear interpolation but pure fused arithmetic, with no
    gathers.
    """
    lam = jnp.clip(lam, float(_D65_LAMBDAS[0]), float(_D65_LAMBDAS[-1]))
    acc = jnp.zeros_like(lam)
    for lk, vk in zip(_D65_LAMBDAS, _D65_VALUES):
        acc = acc + float(vk) * jnp.maximum(
            0.0, 1.0 - jnp.abs(lam - float(lk)) * 0.1
        )
    return acc


def blackbody(lam_nm, temperature_k):
    """Planck's law: spectral radiance (W / (m^2 sr m)) at lam_nm nanometres.

    Reference analogue: Blackbody() in src/pbrt/util/spectrum.h.
    """
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    lam = lam_nm * 1e-9
    lam5 = lam * lam * lam * lam * lam
    return (2.0 * h * c * c) / (
        lam5 * (jnp.exp((h * c) / (lam * kb * temperature_k)) - 1.0)
    )


def normalized_blackbody(lam_nm, temperature_k):
    """Blackbody scaled so its peak value (Wien's law) is 1."""
    lam_max_nm = 2.8977721e-3 / temperature_k * 1e9
    peak = blackbody(lam_max_nm, temperature_k)
    return blackbody(lam_nm, temperature_k) / peak


def illuminant_a(lam):
    """CIE standard illuminant A: blackbody at 2856 K, 100 at 560 nm."""
    return 100.0 * blackbody(lam, 2856.0) / blackbody(560.0, 2856.0)


def illuminant_e(lam):
    """Equal-energy illuminant."""
    return jnp.ones_like(lam) * 100.0


# Host-side numpy mirrors for build-time (scene compile) computations.
def cie_xyz_np(lam: np.ndarray) -> np.ndarray:
    from . import cheb

    cx, cy, cz = _cheb_xyz()
    return np.stack(
        [
            np.maximum(cheb.chebeval_np(lam, c, _CHEB_LO, _CHEB_HI), 0.0)
            for c in (cx, cy, cz)
        ],
        axis=-1,
    )


def illuminant_d65_np(lam: np.ndarray) -> np.ndarray:
    return np.interp(lam, _D65_LAMBDAS, _D65_VALUES)


def whitepoint_xy(illuminant=None) -> np.ndarray:
    """Chromaticity (x, y) of an illuminant under the CMF fits (host-side)."""
    lam = np.linspace(360.0, 830.0, 941)
    if illuminant is None or illuminant is illuminant_d65:
        spd = illuminant_d65_np(lam)
    else:
        spd = np.asarray(illuminant(jnp.asarray(lam, jnp.float32)))
    xyz = np.sum(cie_xyz_np(lam) * spd[:, None], axis=0)
    return xyz[:2] / xyz.sum()

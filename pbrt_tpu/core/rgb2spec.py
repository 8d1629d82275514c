"""RGB -> spectrum upsampling via sigmoid polynomials (Jakob & Hanika 2019).

Reference analogue: RGBSigmoidPolynomial / RGBToSpectrumTable
(/root/reference/src/pbrt/util/color.h:332-368) and the offline optimizer
cmd/rgb2spec_opt.cpp (915 LoC) that bakes 64^3 coefficient tables per gamut.

Design difference: instead of baking + trilinearly interpolating a
3D table, we *fit coefficients on the fly at scene-build time* with a damped
Newton solve vectorized over all texels/albedos (a handful of 3x3 solves —
microseconds for millions of RGBs). This removes the table entirely,
is exact for every RGB rather than interpolated, and keeps the fit itself
differentiable.

A fitted spectrum is s(lam) = sigmoid(c0*x^2 + c1*x + c2) with x the
wavelength normalized to the visible range and sigmoid(z) = 1/2 + z/(2*sqrt(1+z^2)).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import cie, colorspace

# Quadrature grid for the round-trip projection (2 nm over the render range).
_QUAD_N = 156


def _normalize_lambda(lam):
    return (lam - cie.LAMBDA_MIN) / (cie.LAMBDA_MAX - cie.LAMBDA_MIN)


def sigmoid(z):
    return 0.5 + 0.5 * z / jnp.sqrt(1.0 + z * z)


def eval_sigmoid(coeffs, lam):
    """Evaluate a fitted spectrum. coeffs: (..., 3); lam: (..., S) -> (..., S)."""
    x = _normalize_lambda(lam)
    z = (coeffs[..., 0:1] * x + coeffs[..., 1:2]) * x + coeffs[..., 2:3]
    return sigmoid(z)


@functools.lru_cache(maxsize=None)
def _projection(cs_name: str):
    """(3, K) matrix taking spectrum samples on the quad grid to linear RGB.

    Defined so that reflectance == 1 under the space's illuminant (D65 here)
    maps to RGB (1,1,1) — the albedo round-trip convention of
    RGBAlbedoSpectrum (src/pbrt/util/spectrum.h:520). Pure host numpy:
    returned as np.float32 arrays (constants under jit; zero eager device
    RPCs at scene-build time).
    """
    cs = colorspace.COLOR_SPACES[cs_name]
    lam = np.linspace(cie.LAMBDA_MIN, cie.LAMBDA_MAX, _QUAD_N)
    cmf = cie.cie_xyz_np(lam)  # (K, 3)
    illum = cie.illuminant_d65_np(lam)  # (K,)
    norm = float(np.sum(cmf[:, 1] * illum))
    xyz_from_s = (cmf * illum[:, None]).T / norm  # (3, K)
    white_xyz = colorspace._xyy_to_xyz(*cs.white_xy)
    # Re-normalize so constant-1 reflectance hits the white point exactly even
    # though our CMF fits/illuminant table are approximate.
    own_white = xyz_from_s @ np.ones(_QUAD_N) * 0 + xyz_from_s.sum(axis=1)
    xyz_from_s = xyz_from_s * (white_xyz / own_white)[:, None]
    rgb_from_s = cs.rgb_from_xyz @ xyz_from_s
    return (
        np.asarray(rgb_from_s, dtype=np.float32),
        np.asarray(lam, dtype=np.float32),
    )


def _project_rgb(coeffs, rgb_from_s, lam):
    return eval_sigmoid(coeffs, lam) @ rgb_from_s.T


def _solve3(a, b):
    """Closed-form (adjugate/Cramer) solve of batched 3x3 systems.

    a: (..., 3, 3), b: (..., 3). Far cheaper to compile and run than a
    general LAPACK-style solve for this tiny fixed size.
    """
    m = a
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    inv_det = jnp.where(jnp.abs(det) > 1e-20, 1.0 / det, 0.0)
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    adj = jnp.stack(
        [
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ],
        axis=-2,
    )
    return jnp.einsum(
        "...ij,...j->...i", adj, b, precision=jax.lax.Precision.HIGHEST
    ) * inv_det[..., None]


def fit_albedo(rgb, cs_name: str = "srgb", iters: int = 40):
    """Fit sigmoid-polynomial coefficients for reflectance RGBs in [0, 1].

    rgb: (..., 3) -> coeffs (..., 3). Jittable; vectorized over leading axes.
    Damped Newton with the analytic Jacobian
    d(rgb)/dc = M @ diag(sigmoid'(z)) @ [x^2 x 1].

    Concrete (scene-build-time) inputs take a pure-numpy host path: the
    eager-mode Newton loop would otherwise dispatch hundreds of small
    device calls per scene build.
    """
    if isinstance(rgb, jax.core.Tracer):
        return _fit_albedo_jnp(rgb, cs_name, iters)
    return _fit_albedo_np(rgb, cs_name, iters)


def _fit_albedo_jnp(rgb, cs_name: str, iters: int):
    rgb_from_s, lam = _projection(cs_name)
    x = _normalize_lambda(lam)  # (K,)
    basis = jnp.stack([x * x, x, jnp.ones_like(x)], axis=-1)  # (K, 3)
    rgb = jnp.asarray(rgb, dtype=jnp.float32)
    shape = rgb.shape
    target = jnp.clip(rgb, 1e-4, 0.9999).reshape(-1, 3)

    # Start from the constant spectrum matching the channel mean.
    m = jnp.clip(jnp.mean(target, axis=-1, keepdims=True), 1e-3, 0.999)
    z0 = (m - 0.5) / jnp.sqrt(jnp.maximum(m * (1.0 - m), 1e-6))
    c0 = jnp.concatenate([jnp.zeros_like(z0), jnp.zeros_like(z0), z0], axis=-1)

    damp = 1e-6 * jnp.eye(3, dtype=jnp.float32)

    def body(_, c):
        z = jnp.matmul(c, basis.T, precision=jax.lax.Precision.HIGHEST)  # (N, K)
        s = sigmoid(z)
        r = jnp.matmul(s, rgb_from_s.T, precision=jax.lax.Precision.HIGHEST) - target  # (N, 3)
        ds = 0.5 * jax.lax.rsqrt((1.0 + z * z) ** 3)  # sigmoid'(z), (N, K)
        J = jnp.einsum(
            "ik,nk,kj->nij", rgb_from_s, ds, basis, precision=jax.lax.Precision.HIGHEST
        )  # (N, 3, 3)
        JtJ = jnp.einsum("nij,nik->njk", J, J, precision=jax.lax.Precision.HIGHEST) + damp
        Jtr = jnp.einsum("nij,ni->nj", J, r, precision=jax.lax.Precision.HIGHEST)
        delta = _solve3(JtJ, Jtr)
        return c - jnp.clip(delta, -50.0, 50.0)

    coeffs = jax.lax.fori_loop(0, iters, body, c0)
    return coeffs.reshape(shape)


def _fit_albedo_np(rgb, cs_name: str, iters: int):
    """Host-side mirror of _fit_albedo_jnp (float32 numpy)."""
    rgb_from_s, lam = _projection(cs_name)
    x = np.asarray(_normalize_lambda(lam), np.float32)
    basis = np.stack([x * x, x, np.ones_like(x)], axis=-1)  # (K, 3)
    rgb = np.asarray(rgb, dtype=np.float32)
    shape = rgb.shape
    target = np.clip(rgb, 1e-4, 0.9999).reshape(-1, 3)

    m = np.clip(np.mean(target, axis=-1, keepdims=True), 1e-3, 0.999)
    z0 = (m - 0.5) / np.sqrt(np.maximum(m * (1.0 - m), 1e-6))
    c0 = np.concatenate([np.zeros_like(z0), np.zeros_like(z0), z0], axis=-1)

    damp = (1e-6 * np.eye(3)).astype(np.float32)
    c = c0.astype(np.float32)
    for _ in range(iters):
        z = c @ basis.T  # (N, K)
        s = 0.5 + 0.5 * z / np.sqrt(1.0 + z * z)
        r = s @ rgb_from_s.T - target  # (N, 3)
        ds = (0.5 / np.sqrt((1.0 + z * z) ** 3)).astype(np.float32)
        J = np.einsum("ik,nk,kj->nij", rgb_from_s, ds, basis)  # (N, 3, 3)
        JtJ = np.einsum("nij,nik->njk", J, J) + damp
        Jtr = np.einsum("nij,ni->nj", J, r)
        delta = _solve3_np(JtJ, Jtr)
        c = c - np.clip(delta, -50.0, 50.0)
    return jnp.asarray(c.reshape(shape))


def _solve3_np(m, b):
    """Numpy mirror of _solve3 (Cramer/adjugate, singular -> 0)."""
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    inv_det = np.where(np.abs(det) > 1e-20, 1.0 / np.where(det == 0, 1, det), 0.0)
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    adj = np.stack(
        [
            np.stack([c00, c10, c20], axis=-1),
            np.stack([c01, c11, c21], axis=-1),
            np.stack([c02, c12, c22], axis=-1),
        ],
        axis=-2,
    )
    return np.einsum("...ij,...j->...i", adj, b) * inv_det[..., None]


def fit_unbounded(rgb, cs_name: str = "srgb"):
    """Fit RGBs outside [0,1] (e.g. emission): returns (coeffs, scale).

    Spectrum value = scale * sigmoid_poly(lam). Reference analogue:
    RGBUnboundedSpectrum (src/pbrt/util/spectrum.h:569).
    """
    if isinstance(rgb, jax.core.Tracer):
        rgb = jnp.asarray(rgb, dtype=jnp.float32)
        m = jnp.max(rgb, axis=-1, keepdims=True)
        scale = 2.0 * m
        safe = jnp.where(
            scale > 0.0, rgb / jnp.where(scale == 0.0, 1.0, scale), 0.0
        )
        coeffs = fit_albedo(safe, cs_name)
        return coeffs, scale[..., 0]
    rgb = np.asarray(rgb, dtype=np.float32)
    m = np.max(rgb, axis=-1, keepdims=True)
    scale = 2.0 * m
    safe = np.where(scale > 0.0, rgb / np.where(scale == 0.0, 1.0, scale), 0.0)
    coeffs = fit_albedo(safe, cs_name)
    return coeffs, jnp.asarray(scale[..., 0])


def eval_unbounded(coeffs, scale, lam):
    return scale[..., None] * eval_sigmoid(coeffs, lam)


def eval_illuminant(coeffs, scale, lam):
    """Unbounded sigmoid modulated by the D65 illuminant spectrum, normalized
    so RGB (1,1,1) is a unit-luminance D65-shaped emitter.

    Reference analogue: RGBIlluminantSpectrum (src/pbrt/util/spectrum.h:595).
    """
    d65 = cie.illuminant_d65(lam) * (1.0 / 100.0)
    return scale[..., None] * eval_sigmoid(coeffs, lam) * d65

"""Chiang-style hair BSDF, vectorized over rays and spectral lanes.

Re-design of the reference HairBxDF (src/pbrt/
bxdfs.h:1054-1152, bxdfs.cpp:280-620): the per-lobe loop over scattering
orders p=0..pMax becomes a stacked p-axis so the longitudinal (Mp),
azimuthal (Np) and attenuation (Ap) factors evaluate as one batched
computation; all control flow is branchless `where` selects.

Hair frame convention (matches the reference): the curve tangent is the
local +x axis, so sin(theta) = w.x and the azimuth is atan2(w.z, w.y);
the shading normal is the z axis (f divides by |wi.z|).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

P_MAX = 3
_EPS = 1e-7
_SQRT_PI_OVER_8 = 0.626657069


def _sqr(x):
    return x * x


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def _safe_asin(x):
    return jnp.arcsin(jnp.clip(x, -1.0, 1.0))


def _i0(x):
    """Modified Bessel I0 by its power series (10 terms, as the reference)."""
    val = jnp.zeros_like(x)
    x2i = jnp.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


def _log_i0(x):
    big = x + 0.5 * (-math.log(2.0 * math.pi) + jnp.log(1.0 / jnp.maximum(x, _EPS))
                     + 1.0 / (8.0 * jnp.maximum(x, _EPS)))
    small = jnp.log(_i0(jnp.minimum(x, 12.0)))
    return jnp.where(x > 12.0, big, small)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering lobe (bxdfs.h:1092-1099), stable small-v path."""
    v = jnp.maximum(v, 1e-5)
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small_v = jnp.exp(_log_i0(a) - b - 1.0 / v + 0.6931 + jnp.log(1.0 / (2.0 * v)))
    # sinh(1/v) overflows for small v; clamp the argument in the unused branch.
    inv_v = jnp.minimum(1.0 / v, 30.0)
    big_v = jnp.exp(-b) * _i0(a) / (jnp.sinh(inv_v) * 2.0 * v)
    return jnp.where(v <= 0.1, small_v, big_v)


def _logistic(x, s):
    x = jnp.abs(x)
    e = jnp.exp(-x / s)
    return e / (s * _sqr(1.0 + e))


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + jnp.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * jnp.log(1.0 / jnp.clip(u * k + _logistic_cdf(a, s), _EPS, 1.0 - _EPS) - 1.0)
    return jnp.clip(x, a, b)


def _phi_p(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * math.pi


def _np(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_p(p, gamma_o, gamma_t)
    # Remap to [-pi, pi] without data-dependent loops.
    dphi = jnp.mod(dphi + math.pi, 2.0 * math.pi) - math.pi
    return _trimmed_logistic(dphi, s, -math.pi, math.pi)


def longitudinal_variance(beta_m):
    """v[p] for p = 0..P_MAX as a stacked (..., 4) axis (bxdfs.cpp:289-295)."""
    v0 = _sqr(0.726 * beta_m + 0.812 * _sqr(beta_m) + 3.7 * beta_m ** 20)
    return jnp.stack([v0, 0.25 * v0, 4.0 * v0, 4.0 * v0], axis=-1)


def azimuthal_s(beta_n):
    return _SQRT_PI_OVER_8 * (
        0.265 * beta_n + 1.194 * _sqr(beta_n) + 5.372 * beta_n ** 22
    )


def _tilt_tables(alpha):
    """sin/cos of 2^k * alpha for k = 0..2 via angle doubling."""
    s0 = jnp.sin(jnp.deg2rad(alpha))
    c0 = _safe_sqrt(1.0 - _sqr(s0))
    s1 = 2.0 * c0 * s0
    c1 = _sqr(c0) - _sqr(s0)
    s2 = 2.0 * c1 * s1
    c2 = _sqr(c1) - _sqr(s1)
    return (s0, s1, s2), (c0, c1, c2)


def _tilted_o(sin_to, cos_to, alpha):
    """(sin, cos) of the tilted theta_o for each p, stacked (..., 4).

    p=0 rotates by +2*alpha, p=1 by -alpha, p=2 by -4*alpha, p>=3 untilted
    (bxdfs.cpp:340-356)."""
    (s0, s1, s2), (c0, c1, c2) = _tilt_tables(alpha)
    sin_p = jnp.stack(
        [
            sin_to * c1 - cos_to * s1,
            sin_to * c0 + cos_to * s0,
            sin_to * c2 + cos_to * s2,
            sin_to,
        ],
        axis=-1,
    )
    cos_p = jnp.stack(
        [
            cos_to * c1 + sin_to * s1,
            cos_to * c0 - sin_to * s0,
            cos_to * c2 - sin_to * s2,
            cos_to,
        ],
        axis=-1,
    )
    return sin_p, jnp.abs(cos_p)


def _fr_dielectric(cos_i, eta):
    cos_i = jnp.clip(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - _sqr(cos_i)) / _sqr(eta)
    cos_t = _safe_sqrt(1.0 - sin2_t)
    r_par = (eta * cos_i - cos_t) / jnp.maximum(eta * cos_i + cos_t, _EPS)
    r_per = (cos_i - eta * cos_t) / jnp.maximum(cos_i + eta * cos_t, _EPS)
    fr = 0.5 * (_sqr(r_par) + _sqr(r_per))
    return jnp.where(sin2_t >= 1.0, 1.0, jnp.clip(fr, 0.0, 1.0))


def _geom_terms(h, eta, sin_to, cos_to):
    """gamma_o, gamma_t, cos_gamma_t, cos_theta_t shared by f/pdf/sample."""
    gamma_o = _safe_asin(h)
    etap = _safe_sqrt(_sqr(eta) - _sqr(sin_to)) / jnp.maximum(cos_to, _EPS)
    sin_gt = h / jnp.maximum(etap, _EPS)
    cos_gt = _safe_sqrt(1.0 - _sqr(sin_gt))
    gamma_t = _safe_asin(sin_gt)
    sin_tt = sin_to / eta
    cos_tt = _safe_sqrt(1.0 - _sqr(sin_tt))
    return gamma_o, gamma_t, cos_gt, cos_tt


def _ap(cos_to, eta, h, T):
    """Attenuation per lobe, (..., 4, S); T is (..., S) (bxdfs.h:1101-1122)."""
    cos_go = _safe_sqrt(1.0 - _sqr(h))
    f = _fr_dielectric(cos_to * cos_go, eta)[..., None]
    a0 = jnp.broadcast_to(f, T.shape)
    a1 = _sqr(1.0 - f) * T
    a2 = a1 * T * f
    a3 = a2 * f * T / jnp.maximum(1.0 - T * f, _EPS)
    return jnp.stack([a0, a1, a2, a3], axis=-2)


def _ap_pdf(cos_to, eta, h, sigma_a):
    """Lobe-selection PMF (..., 4): spectrally-averaged Ap, normalized."""
    sin_to = _safe_sqrt(1.0 - _sqr(cos_to))
    _, _, cos_gt, cos_tt = _geom_terms(h, eta, sin_to, cos_to)
    T = jnp.exp(-sigma_a * (2.0 * cos_gt / jnp.maximum(cos_tt, _EPS))[..., None])
    ap = _ap(cos_to, eta, h, T).mean(axis=-1)  # (..., 4)
    return ap / jnp.maximum(ap.sum(axis=-1, keepdims=True), _EPS)


def hair_f(h, eta, sigma_a, beta_m, beta_n, alpha, wo, wi):
    """f(wo, wi): (N, S). sigma_a (N, S); h/beta_m/beta_n/alpha scalar or (N,)."""
    sin_to = wo[..., 0]
    cos_to = _safe_sqrt(1.0 - _sqr(sin_to))
    phi_o = jnp.arctan2(wo[..., 2], wo[..., 1])
    sin_ti = wi[..., 0]
    cos_ti = _safe_sqrt(1.0 - _sqr(sin_ti))
    phi_i = jnp.arctan2(wi[..., 2], wi[..., 1])

    gamma_o, gamma_t, cos_gt, cos_tt = _geom_terms(h, eta, sin_to, cos_to)
    T = jnp.exp(-sigma_a * (2.0 * cos_gt / jnp.maximum(cos_tt, _EPS))[..., None])
    ap = _ap(cos_to, eta, h, T)  # (N, 4, S)

    v = longitudinal_variance(beta_m)  # (..., 4)
    s = azimuthal_s(beta_n)
    sin_top, cos_top = _tilted_o(sin_to, cos_to, alpha)  # (..., 4)

    phi = phi_i - phi_o
    mp = _mp(cos_ti[..., None], cos_top, sin_ti[..., None], sin_top, v)  # (N,4)
    p_idx = jnp.arange(P_MAX, dtype=wo.dtype)
    np_ = _np(
        phi[..., None], p_idx, s[..., None] if jnp.ndim(s) else s,
        gamma_o[..., None], gamma_t[..., None],
    )  # (N, 3)
    np_full = jnp.concatenate(
        [np_, jnp.full_like(np_[..., :1], 1.0 / (2.0 * math.pi))], axis=-1
    )  # (N, 4)
    fsum = (mp[..., None] * ap * np_full[..., None]).sum(axis=-2)  # (N, S)
    abs_cos = jnp.abs(wi[..., 2])
    return fsum / jnp.maximum(abs_cos, _EPS)[..., None]


def hair_pdf(h, eta, sigma_a, beta_m, beta_n, alpha, wo, wi):
    """Solid-angle PDF of hair_sample, (N,)."""
    sin_to = wo[..., 0]
    cos_to = _safe_sqrt(1.0 - _sqr(sin_to))
    phi_o = jnp.arctan2(wo[..., 2], wo[..., 1])
    sin_ti = wi[..., 0]
    cos_ti = _safe_sqrt(1.0 - _sqr(sin_ti))
    phi_i = jnp.arctan2(wi[..., 2], wi[..., 1])

    gamma_o, gamma_t, _, _ = _geom_terms(h, eta, sin_to, cos_to)
    ap_pdf = _ap_pdf(cos_to, eta, h, sigma_a)  # (N, 4)
    v = longitudinal_variance(beta_m)
    s = azimuthal_s(beta_n)
    sin_top, cos_top = _tilted_o(sin_to, cos_to, alpha)

    phi = phi_i - phi_o
    mp = _mp(cos_ti[..., None], cos_top, sin_ti[..., None], sin_top, v)
    p_idx = jnp.arange(P_MAX, dtype=wo.dtype)
    np_ = _np(
        phi[..., None], p_idx, s[..., None] if jnp.ndim(s) else s,
        gamma_o[..., None], gamma_t[..., None],
    )
    np_full = jnp.concatenate(
        [np_, jnp.full_like(np_[..., :1], 1.0 / (2.0 * math.pi))], axis=-1
    )
    return (mp * ap_pdf * np_full).sum(axis=-1)


def hair_sample(h, eta, sigma_a, beta_m, beta_n, alpha, wo, u2, uc):
    """Sample wi. Returns (wi (N,3), f (N,S), pdf (N,)).

    Lobe p drawn from the Ap PMF with uc (remainder reused for the azimuthal
    logistic), longitudinal angle from the Mp inverse with u2
    (bxdfs.cpp:430-520)."""
    sin_to = wo[..., 0]
    cos_to = _safe_sqrt(1.0 - _sqr(sin_to))
    phi_o = jnp.arctan2(wo[..., 2], wo[..., 1])

    gamma_o, gamma_t, _, _ = _geom_terms(h, eta, sin_to, cos_to)
    ap_pdf = _ap_pdf(cos_to, eta, h, sigma_a)  # (N, 4)
    cdf = jnp.cumsum(ap_pdf, axis=-1)
    ucb = uc[..., None]
    p = (ucb >= cdf[..., :-1]).sum(axis=-1)  # (N,) in 0..3
    lo = jnp.where(p > 0, jnp.take_along_axis(cdf, jnp.maximum(p - 1, 0)[..., None],
                                              axis=-1)[..., 0], 0.0)
    pmf_p = jnp.take_along_axis(ap_pdf, p[..., None], axis=-1)[..., 0]
    uc_rem = jnp.clip((uc - lo) / jnp.maximum(pmf_p, _EPS), 0.0, 1.0 - 1e-6)

    v_all = longitudinal_variance(beta_m)  # (..., 4)
    v_all = jnp.broadcast_to(v_all, p.shape + (P_MAX + 1,))
    vp = jnp.take_along_axis(v_all, p[..., None], axis=-1)[..., 0]
    s = azimuthal_s(beta_n)
    sin_top_all, cos_top_all = _tilted_o(sin_to, cos_to, alpha)
    sin_top = jnp.take_along_axis(
        jnp.broadcast_to(sin_top_all, p.shape + (P_MAX + 1,)), p[..., None], axis=-1
    )[..., 0]
    cos_top = jnp.take_along_axis(
        jnp.broadcast_to(cos_top_all, p.shape + (P_MAX + 1,)), p[..., None], axis=-1
    )[..., 0]

    # Longitudinal: invert Mp.
    u0 = jnp.maximum(u2[..., 0], 1e-5)
    cos_theta = 1.0 + vp * jnp.log(u0 + (1.0 - u2[..., 0]) * jnp.exp(-2.0 / jnp.maximum(vp, 1e-5)))
    sin_theta = _safe_sqrt(1.0 - _sqr(cos_theta))
    cos_phi_l = jnp.cos(2.0 * math.pi * u2[..., 1])
    sin_ti = -cos_theta * sin_top + sin_theta * cos_phi_l * cos_top
    cos_ti = _safe_sqrt(1.0 - _sqr(sin_ti))

    # Azimuthal: trimmed logistic around Phi(p) for p < pMax, uniform for p = pMax.
    dphi_log = _phi_p(p.astype(wo.dtype), gamma_o, gamma_t) + _sample_trimmed_logistic(
        uc_rem, s, -math.pi, math.pi
    )
    dphi = jnp.where(p == P_MAX, 2.0 * math.pi * uc_rem, dphi_log)

    phi_i = phi_o + dphi
    wi = jnp.stack(
        [sin_ti, cos_ti * jnp.cos(phi_i), cos_ti * jnp.sin(phi_i)], axis=-1
    )
    f = hair_f(h, eta, sigma_a, beta_m, beta_n, alpha, wo, wi)
    pdf = hair_pdf(h, eta, sigma_a, beta_m, beta_n, alpha, wo, wi)
    return wi, f, pdf


# --- Pigment helpers (bxdfs.cpp:600-620) ------------------------------------

# Published melanin absorption coefficients (Chiang et al. 2016).
_EUMELANIN_RGB = (0.419, 0.697, 1.37)
_PHEOMELANIN_RGB = (0.187, 0.4, 1.05)


def sigma_a_from_concentration(ce, cp):
    """RGB absorption from eumelanin/pheomelanin concentrations, (3,)."""
    eu = jnp.asarray(_EUMELANIN_RGB)
    ph = jnp.asarray(_PHEOMELANIN_RGB)
    return ce * eu + cp * ph


def sigma_a_from_reflectance(c, beta_n):
    """Spectral absorption that yields reflectance c at azimuthal roughness
    beta_n (bxdfs.cpp:612-618)."""
    denom = (
        5.969
        - 0.215 * beta_n
        + 2.532 * _sqr(beta_n)
        - 10.73 * beta_n ** 3
        + 5.574 * beta_n ** 4
        + 0.245 * beta_n ** 5
    )
    return _sqr(jnp.log(jnp.maximum(c, 1e-5)) / denom)

"""Separable BSSRDF with the Burley normalized-diffusion profile.

Reference analogue: TabulatedBSSRDF + the probe-ray machinery
(/root/reference/src/pbrt/bssrdf.h:23-220, wavefront/subsurface.cpp:18-46).
The reference tabulates a photon-beam-diffusion profile per (rho, radius)
and inverts it by table search; this implementation replaces the tables
with Christensen-Burley's closed-form normalized-diffusion profile
(public method: "Approximate Reflectance Profiles for Efficient Subsurface
Scattering", Pixar tech memo 15-04) — an analytic profile + analytic-ish
CDF inversion means NO table gathers, which is exactly the
rgb2spec-style on-the-fly-fit tradeoff this framework makes elsewhere.

Pieces:
  * burley_d: per-wavelength shaping from (albedo A, mean free path l).
  * profile Sp(r), its polar pdf, and a Newton-inverted radius sampler.
  * fresnel_moment1: the d'Eon/Irving polynomial for the Sw normalization
    (bssrdf.h FresnelMoment1 uses the same published fit).
  * subsurface_exit: the probe step — sample a disk offset in the tangent
    frame, probe along -n, relocate the path vertex to the found exit
    point with the spectral profile/pdf weight (single-axis probing; the
    reference MIS-combines three axes, documented simplification).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..accel import api as accel_api
from ..core.vecmath import coordinate_system, normalize

_EPS = 1e-9


def burley_d(albedo, mfp):
    """Shaping distance d per wavelength from albedo + mean free path.

    s is Burley's fit (eq. 8 of the memo) mapping albedo to the scaling
    that preserves the diffuse reflectance."""
    s = 1.85 - albedo + 7.0 * jnp.abs(albedo - 0.8) ** 3
    return jnp.maximum(mfp, 1e-6) / jnp.maximum(s, 1e-4)


def burley_profile(r, d):
    """Sp(r): radially-symmetric diffusion profile, integrates (over the
    plane, weighted by 2 pi r dr) to 1 — the ALBEDO multiplies outside."""
    r = jnp.maximum(r, 1e-6)
    return (
        (jnp.exp(-r / d) + jnp.exp(-r / (3.0 * d)))
        / (8.0 * jnp.pi * d * r)
    )


def burley_cdf(r, d):
    """CDF of the polar-measure profile: 1 - e^{-x}/4 - 3 e^{-x/3}/4."""
    x = r / d
    return 1.0 - 0.25 * jnp.exp(-x) - 0.75 * jnp.exp(-x / 3.0)


def burley_pdf_r(r, d):
    """Polar pdf p(r) = Sp(r) * 2 pi r (so p integrates to 1 over r)."""
    return burley_profile(r, d) * 2.0 * jnp.pi * jnp.maximum(r, 1e-6)


def burley_sample_r(u, d, iters: int = 10):
    """Invert the CDF by damped Newton (elementwise; no tables)."""
    u = jnp.clip(u, 1e-5, 1.0 - 1e-5)
    x = jnp.ones_like(u)  # initial guess in units of d

    for _ in range(iters):
        f = 1.0 - 0.25 * jnp.exp(-x) - 0.75 * jnp.exp(-x / 3.0) - u
        fp = 0.25 * jnp.exp(-x) + 0.25 * jnp.exp(-x / 3.0)
        x = jnp.clip(x - f / jnp.maximum(fp, 1e-6), 1e-4, 60.0)
    return x * d


def fresnel_moment1(eta):
    """First Fresnel reflectance moment (bssrdf.cpp FresnelMoment1; the
    published d'Eon & Irving polynomial fit)."""
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (
        0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
        + 2.49277 * e4 - 0.68441 * e5
    )
    hi = (
        -4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
        - 1.27198 * e4 + 0.12746 * e5
    )
    return jnp.where(eta < 1.0, lo, hi)


def subsurface_exit(scene, isect, ns, t1, t2, albedo, mfp_hero, u_r, u_phi,
                    r_max_factor: float = 8.0):
    """Relocate subsurface-entry vertices to sampled exit points.

    isect: the entry interaction (batched); ns/t1/t2: its shading frame;
    albedo: (N, S) spectral single-scattering albedo; mfp_hero: (N,) hero
    mean free path driving the radius sampling; u_r/u_phi: (N,) uniforms.

    Returns (p_exit, n_exit, weight (N, S), ok): weight includes the full
    spectral profile over the hero sampling pdf (the hero-wavelength
    reweighting pattern used across this renderer); ok marks probes that
    found the surface (failures fall back to the entry point with weight 1,
    the reference's behavior when the probe list is empty is to drop the
    sample — we keep the local approximation instead to stay unbiased-ish
    for thin geometry).
    """
    d_hero = burley_d(jnp.mean(albedo, axis=-1), mfp_hero)
    r = burley_sample_r(u_r, d_hero)
    r_cap = r_max_factor * d_hero
    r = jnp.minimum(r, r_cap)
    phi = 2.0 * jnp.pi * u_phi
    # Probe chord perpendicular to the surface (single axis = ns; the
    # reference probes 3 axes with MIS, bssrdf.h:176).
    h = jnp.sqrt(jnp.maximum(r_cap * r_cap - r * r, 1e-8))
    offset = (
        r[..., None] * (jnp.cos(phi)[..., None] * t1
                        + jnp.sin(phi)[..., None] * t2)
    )
    o_probe = isect.p + offset + ns * h[..., None]
    d_probe = -ns
    probe = accel_api.closest(scene, o_probe, d_probe,
                              tmax=jnp.full(r.shape, 2.0) * h)
    same_mat = probe.valid & (probe.mat == isect.mat)

    p_exit = jnp.where(same_mat[..., None], probe.p, isect.p)
    n_exit = jnp.where(same_mat[..., None], probe.n, isect.n)
    # Actual exit radius in the entry tangent plane.
    dp = p_exit - isect.p
    r_exit = jnp.sqrt(jnp.maximum(
        jnp.sum(dp * dp, -1) - jnp.sum(dp * ns, -1) ** 2, 1e-12
    ))
    r_exit = jnp.maximum(r_exit, 1e-4 * d_hero)

    # Spectral weight: albedo_l * Sp_l(r_exit) / (hero polar pdf converted
    # to the area measure at the exit point).
    d_spec = burley_d(albedo, mfp_hero[..., None])
    sp = albedo * burley_profile(r_exit[..., None], d_spec)
    cos_probe = jnp.abs(jnp.sum(normalize(
        jnp.where(same_mat[..., None], probe.n, ns)
    ) * ns, -1))
    pdf_area = (
        burley_pdf_r(r_exit, d_hero) / (2.0 * jnp.pi * r_exit)
        * jnp.maximum(cos_probe, 0.1)
    )
    w = jnp.where(
        same_mat[..., None],
        sp / jnp.maximum(pdf_area, 1e-12)[..., None],
        1.0,  # probe failed: stay at entry, treat locally (weight 1)
    )
    # Clamp the weight: grazing probes through thin geometry can spike the
    # estimator (the reference clamps via its MIS axes instead).
    w = jnp.minimum(w, 20.0)
    return p_exit, n_exit, w, same_mat

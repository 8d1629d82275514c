"""Branchless BxDF evaluation/sampling over ray batches.

Reference analogue: /root/reference/src/pbrt/bxdfs.h (DiffuseBxDF :30,
ConductorBxDF :413, DielectricBxDF :300, ThinDielectricBxDF :342) + BSDF
local-frame wrapper (bsdf.h:19). Directions are in the *shading-local* frame
(z = shading normal). Spectral throughputs have shape (N, S).

Dispatch model: every BxDF family evaluates for all rays and the material
`kind` tag selects per ray (jnp.where) — the replacement for
TaggedPointer::Dispatch (util/taggedptr.h:22-60). For this closed set of
families, evaluate-all-and-select keeps every lane busy; tag-sorted
queue partitioning is the planned optimization for wider material sets.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import rgb2spec
from ..core.sampling import (
    INV_PI,
    cosine_hemisphere_pdf,
    sample_cosine_hemisphere,
)
from ..core.vecmath import normalize
from . import hair
from . import scattering as sc
from .buffers import (
    MAT_COATEDCONDUCTOR,
    MAT_COATEDDIFFUSE,
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_DIFFUSE,
    MAT_DIFFUSETRANS,
    MAT_HAIR,
    MAT_THINDIELECTRIC,
)

_EPS = 1e-8


def _cos(w):
    return w[..., 2]


def _abscos(w):
    return jnp.abs(w[..., 2])


def _same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


# --- Diffuse (Lambertian) ---------------------------------------------------


def diffuse_f(albedo, wo, wi):
    same = _same_hemisphere(wo, wi)
    return jnp.where(same[..., None], albedo * INV_PI, 0.0)


def diffuse_sample(albedo, wo, u2):
    wi = sample_cosine_hemisphere(u2)
    flip = jnp.where(wo[..., 2] < 0.0, -1.0, 1.0)
    wi = wi.at[..., 2].multiply(flip)
    pdf = cosine_hemisphere_pdf(_abscos(wi))
    return wi, albedo * INV_PI, pdf


def diffuse_pdf(wo, wi):
    same = _same_hemisphere(wo, wi)
    return jnp.where(same, cosine_hemisphere_pdf(_abscos(wi)), 0.0)


# --- Normalized Fresnel (bxdfs.h:1206 NormalizedFresnelBxDF) ----------------
# The BSSRDF's Sw exit/entry lobe: cosine-distributed directions weighted by
# the normalized Fresnel transmittance (1 - Fr(cos_i, eta)) / (c pi) with
# c = 1 - 2 FresnelMoment1(1/eta), times eta^2 for radiance transport
# (non-symmetric scattering correction).


def normfresnel_f(eta, wo, wi, n_lam):
    from .bssrdf import fresnel_moment1

    same = _same_hemisphere(wo, wi)
    c = 1.0 - 2.0 * fresnel_moment1(1.0 / eta)
    fr = sc.fr_dielectric(_abscos(wi), eta)
    val = (1.0 - fr) / (c * jnp.pi) * (eta ** 2)
    val = jnp.where(same, val, 0.0)
    return jnp.broadcast_to(
        val[..., None], val.shape + (n_lam,)
    )


def normfresnel_sample(eta, wo, u2, n_lam):
    wi = sample_cosine_hemisphere(u2)
    flip = jnp.where(wo[..., 2] < 0.0, -1.0, 1.0)
    wi = wi.at[..., 2].multiply(flip)
    pdf = cosine_hemisphere_pdf(_abscos(wi))
    return wi, normfresnel_f(eta, wo, wi, n_lam), pdf


# --- Diffuse transmission (bxdfs.h DiffuseTransmissionBxDF) -----------------


def diffusetrans_f(refl, trans, wo, wi):
    same = _same_hemisphere(wo, wi)
    return jnp.where(same[..., None], refl, trans) * INV_PI


def diffusetrans_pdf(wo, wi):
    # Lobe chosen 50/50, cosine-distributed on each side.
    return 0.5 * cosine_hemisphere_pdf(_abscos(wi))


def diffusetrans_sample(refl, trans, wo, u2, uc):
    wi = sample_cosine_hemisphere(u2)
    side = jnp.where(wo[..., 2] < 0.0, -1.0, 1.0)
    transmit = uc < 0.5
    wi = wi.at[..., 2].multiply(jnp.where(transmit, -side, side))
    f = diffusetrans_f(refl, trans, wo, wi)
    return wi, f, diffusetrans_pdf(wo, wi)


# --- Conductor (bxdfs.h:413) ------------------------------------------------


def conductor_f(eta, k, alpha, wo, wi):
    """Rough-conductor BRDF; 0 where effectively smooth. eta, k: (N, S)."""
    same = _same_hemisphere(wo, wi)
    cos_o = _abscos(wo)
    cos_i = _abscos(wi)
    wm = wo + wi
    wm_ok = jnp.sum(wm * wm, axis=-1) > 1e-16
    wm = normalize(wm)
    f_spec = sc.fr_complex(
        jnp.abs(_dot(wo, wm))[..., None], eta, k
    )  # (N, S)
    d = sc.ggx_d(wm, alpha)
    g = sc.ggx_g(wo, wi, alpha)
    scale = d * g / jnp.maximum(4.0 * cos_o * cos_i, _EPS)
    rough = ~sc.effectively_smooth(alpha)
    ok = same & wm_ok & rough & (cos_o > 0) & (cos_i > 0)
    return jnp.where(ok[..., None], scale[..., None] * f_spec, 0.0)


def conductor_pdf(alpha, wo, wi):
    same = _same_hemisphere(wo, wi)
    wm = wo + wi
    wm_ok = jnp.sum(wm * wm, axis=-1) > 1e-16
    wm = normalize(wm)
    wm = jnp.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    pdf = sc.ggx_pdf_wm(wo, wm, alpha) / jnp.maximum(
        4.0 * jnp.abs(_dot(wo, wm)), _EPS
    )
    rough = ~sc.effectively_smooth(alpha)
    return jnp.where(same & wm_ok & rough, pdf, 0.0)


def conductor_sample(eta, k, alpha, wo, u2):
    """Returns (wi, f, pdf, specular). Smooth -> perfect mirror delta."""
    smooth = sc.effectively_smooth(alpha)
    # Smooth: mirror.
    wi_s = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    f_s = sc.fr_complex(_abscos(wi_s)[..., None], eta, k) / jnp.maximum(
        _abscos(wi_s), _EPS
    )[..., None]
    # Rough: sample visible normal.
    wm = sc.ggx_sample_wm(wo, u2, jnp.maximum(alpha, 1e-3))
    wi_r = -wo + 2.0 * _dot(wo, wm)[..., None] * wm
    pdf_r = sc.ggx_pdf_wm(wo, wm, alpha) / jnp.maximum(
        4.0 * jnp.abs(_dot(wo, wm)), _EPS
    )
    f_r = conductor_f(eta, k, alpha, wo, wi_r)
    same_r = _same_hemisphere(wo, wi_r)

    wi = jnp.where(smooth[..., None], wi_s, wi_r)
    f = jnp.where(smooth[..., None], f_s, f_r)
    pdf = jnp.where(smooth, 1.0, jnp.where(same_r, pdf_r, 0.0))
    return wi, f, pdf, smooth


# --- Dielectric (bxdfs.h:300) -----------------------------------------------


def _dielectric_eta_p(eta, wo_z, reflect):
    """Effective relative IOR for the generalized half-vector."""
    eta_side = jnp.where(wo_z > 0.0, eta, 1.0 / eta)
    return jnp.where(reflect, 1.0, eta_side)


def dielectric_f(eta, alpha, wo, wi):
    """Rough dielectric BSDF (radiance transport). eta: (N,) scalar IOR.

    Returns (N,) scalar density broadcast to (N, S) by the caller
    (no dispersion until spectral eta lands).
    """
    rough = ~sc.effectively_smooth(alpha)
    cos_o = _cos(wo)
    cos_i = _cos(wi)
    reflect = cos_o * cos_i > 0.0
    eta_p = _dielectric_eta_p(eta, cos_o, reflect)
    wm_raw = wi * eta_p[..., None] + wo
    wm_ok = (
        (jnp.abs(cos_o) > 1e-8)
        & (jnp.abs(cos_i) > 1e-8)
        & (jnp.sum(wm_raw * wm_raw, axis=-1) > 1e-16)
    )
    wm = normalize(wm_raw)
    wm = jnp.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    backface = (_dot(wm, wi) * cos_i < 0.0) | (_dot(wm, wo) * cos_o < 0.0)
    fr = sc.fr_dielectric(_dot(wo, wm), eta)
    d = sc.ggx_d(wm, alpha)
    g = sc.ggx_g(wo, wi, alpha)
    # Reflection term.
    f_refl = d * g * fr / jnp.maximum(jnp.abs(4.0 * cos_o * cos_i), _EPS)
    # Transmission term (radiance mode: extra 1/eta_p^2).
    denom = (_dot(wi, wm) + _dot(wo, wm) / jnp.maximum(eta_p, _EPS)) ** 2
    f_trans = (
        d
        * (1.0 - fr)
        * g
        * jnp.abs(
            _dot(wi, wm)
            * _dot(wo, wm)
            / jnp.maximum(jnp.abs(cos_i * cos_o) * denom, _EPS)
        )
        / jnp.maximum(eta_p * eta_p, _EPS)
    )
    f = jnp.where(reflect, f_refl, f_trans)
    ok = rough & wm_ok & ~backface
    return jnp.where(ok, f, 0.0)


def dielectric_pdf(eta, alpha, wo, wi):
    rough = ~sc.effectively_smooth(alpha)
    cos_o = _cos(wo)
    cos_i = _cos(wi)
    reflect = cos_o * cos_i > 0.0
    eta_p = _dielectric_eta_p(eta, cos_o, reflect)
    wm_raw = wi * eta_p[..., None] + wo
    wm_ok = (
        (jnp.abs(cos_o) > 1e-8)
        & (jnp.abs(cos_i) > 1e-8)
        & (jnp.sum(wm_raw * wm_raw, axis=-1) > 1e-16)
    )
    wm = normalize(wm_raw)
    wm = jnp.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    backface = (_dot(wm, wi) * cos_i < 0.0) | (_dot(wm, wo) * cos_o < 0.0)
    fr = sc.fr_dielectric(_dot(wo, wm), eta)
    pr = fr
    pt = 1.0 - fr
    pdf_wm = sc.ggx_pdf_wm(wo, wm, alpha)
    pdf_refl = pdf_wm / jnp.maximum(4.0 * jnp.abs(_dot(wo, wm)), _EPS) * pr
    denom = (_dot(wi, wm) + _dot(wo, wm) / jnp.maximum(eta_p, _EPS)) ** 2
    dwm_dwi = jnp.abs(_dot(wi, wm)) / jnp.maximum(denom, _EPS)
    pdf_trans = pdf_wm * dwm_dwi * pt
    pdf = jnp.where(reflect, pdf_refl, pdf_trans)
    return jnp.where(rough & wm_ok & ~backface, pdf, 0.0)


def dielectric_sample(eta, alpha, wo, u2, uc):
    """Returns (wi, f_scalar, pdf, specular). Chooses reflect/transmit by uc.
    Smooth case is a delta lobe (specular=True)."""
    smooth = sc.effectively_smooth(alpha)

    # --- Smooth: Fresnel-weighted reflect/refract deltas.
    fr_s = sc.fr_dielectric(_cos(wo), eta)
    refl_s = uc < fr_s
    wi_refl = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    n_local = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], wo.dtype), wo.shape)
    from ..core.vecmath import refract as _refract

    valid_t, wi_trans, eta_eff = _refract(wo, n_local, eta)
    f_refl_s = fr_s / jnp.maximum(_abscos(wi_refl), _EPS)
    f_trans_s = (
        (1.0 - fr_s)
        / jnp.maximum(_abscos(wi_trans), _EPS)
        / jnp.maximum(eta_eff * eta_eff, _EPS)
    )
    wi_sm = jnp.where(refl_s[..., None], wi_refl, wi_trans)
    f_sm = jnp.where(refl_s, f_refl_s, jnp.where(valid_t, f_trans_s, 0.0))
    pdf_sm = jnp.where(refl_s, fr_s, jnp.where(valid_t, 1.0 - fr_s, 0.0))

    # --- Rough: microfacet reflect/transmit.
    alpha_r = jnp.maximum(alpha, 1e-3)
    wm = sc.ggx_sample_wm(wo, u2, alpha_r)
    fr_r = sc.fr_dielectric(_dot(wo, wm), eta)
    refl_r = uc < fr_r
    wi_r_refl = -wo + 2.0 * _dot(wo, wm)[..., None] * wm
    valid_rt, wi_r_trans, _ = _refract(wo, wm, eta)
    wi_r = jnp.where(refl_r[..., None], wi_r_refl, wi_r_trans)
    f_r = dielectric_f(eta, alpha, wo, wi_r)
    pdf_r = dielectric_pdf(eta, alpha, wo, wi_r)
    ok_r = jnp.where(refl_r, _same_hemisphere(wo, wi_r_refl), valid_rt)

    wi = jnp.where(smooth[..., None], wi_sm, wi_r)
    f = jnp.where(smooth, f_sm, jnp.where(ok_r, f_r, 0.0))
    pdf = jnp.where(smooth, pdf_sm, jnp.where(ok_r, pdf_r, 0.0))
    return wi, f, pdf, smooth


# --- Thin dielectric (bxdfs.h:342) ------------------------------------------


def thin_dielectric_sample(eta, wo, uc):
    """Thin slab: inter-reflection-summed R' and straight-through T'."""
    r = sc.fr_dielectric(jnp.abs(_cos(wo)), eta)
    r = jnp.where(
        r < 1.0, r + (1.0 - r) ** 2 * r / jnp.maximum(1.0 - r * r, _EPS), r
    )
    t = 1.0 - r
    refl = uc < r
    wi_refl = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    wi_trans = -wo
    wi = jnp.where(refl[..., None], wi_refl, wi_trans)
    f = jnp.where(refl, r, t) / jnp.maximum(_abscos(wi), _EPS)
    pdf = jnp.where(refl, r, t)
    return wi, f, pdf




# --- Coated materials (Fresnel-coupled two-lobe model) ----------------------
# Approximation of the reference's stochastic LayeredBxDF random walk
# (bxdfs.h:565-1035): a GGX dielectric coat lobe plus a base lobe attenuated
# by both-direction Fresnel transmission (Ashikhmin-Shirley coupling). Energy
# conserving and reciprocal; omits inter-layer multiple scattering.

_COAT_ETA = 1.5


def _coat_spec_f(alpha_c, wo, wi):
    """GGX reflection lobe with dielectric Fresnel (scalar per ray)."""
    same = _same_hemisphere(wo, wi)
    wm = normalize(wo + wi)
    wm_ok = jnp.sum((wo + wi) ** 2, axis=-1) > 1e-16
    fr = sc.fr_dielectric(_dot(wo, wm), jnp.full_like(_cos(wo), _COAT_ETA))
    d = sc.ggx_d(wm, alpha_c)
    g = sc.ggx_g(wo, wi, alpha_c)
    f = d * g * fr / jnp.maximum(4.0 * _abscos(wo) * _abscos(wi), _EPS)
    rough = ~sc.effectively_smooth(alpha_c)
    return jnp.where(same & wm_ok & rough, f, 0.0), fr


def coated_f(base_f, alpha_c, wo, wi):
    """base_f: (N, S) base-lobe BSDF. Returns the coupled coated BSDF."""
    spec, _ = _coat_spec_f(alpha_c, wo, wi)
    t_o = 1.0 - sc.fr_dielectric(
        _abscos(wo), jnp.full_like(_cos(wo), _COAT_ETA)
    )
    t_i = 1.0 - sc.fr_dielectric(
        _abscos(wi), jnp.full_like(_cos(wi), _COAT_ETA)
    )
    return spec[..., None] + (t_o * t_i)[..., None] * base_f


def coated_pdf(base_pdf, alpha_c, wo, wi):
    fr_o = sc.fr_dielectric(_abscos(wo), jnp.full_like(_cos(wo), _COAT_ETA))
    p_spec = conductor_pdf(alpha_c, wo, wi)  # same visible-NDF reflection pdf
    return fr_o * p_spec + (1.0 - fr_o) * base_pdf


def coated_sample(base_sample_fn, base_f_fn, base_pdf_fn, alpha_c, wo, u2, uc):
    """Lobe selection by Fresnel(wo); returns (wi, f, pdf)."""
    fr_o = sc.fr_dielectric(_abscos(wo), jnp.full_like(_cos(wo), _COAT_ETA))
    pick_spec = uc < fr_o
    alpha_cr = jnp.maximum(alpha_c, 1e-3)
    wm = sc.ggx_sample_wm(wo, u2, alpha_cr)
    wi_spec = -wo + 2.0 * _dot(wo, wm)[..., None] * wm
    wi_base, _, _ = base_sample_fn(u2)
    wi = jnp.where(pick_spec[..., None], wi_spec, wi_base)
    f = coated_f(base_f_fn(wi), alpha_cr, wo, wi)
    pdf = coated_pdf(base_pdf_fn(wi), alpha_cr, wo, wi)
    ok = _same_hemisphere(wo, wi)
    return wi, jnp.where(ok[..., None], f, 0.0), jnp.where(ok, pdf, 0.0)


# --- Unified per-ray dispatch ----------------------------------------------


def surface_params(scene, isect, lam=None):
    """Per-ray material parameters at a surface interaction.

    Gathers the material row, overlays textured albedo, and attaches the
    interaction-dependent inputs (hair offset h from the curve v coordinate,
    reference hair.h: h = -1 + 2 * intr.uv[1]; the hero wavelengths, which
    hair's sampling PDF depends on through sigma_a).
    """
    mat_idx = isect.mat
    if scene.materials.any_mix:
        # MixMaterial (materials.h): stochastically resolve to one of the
        # two sub-materials BEFORE parameter gathering. The choice is a
        # hash of the hit position and outgoing direction — deterministic
        # per (point, direction) for replay, varying across samples via wo
        # (the reference draws from the sampler; documented divergence).
        from ..core import rng as _rng
        from .buffers import MAT_MIX

        mb = scene.materials
        kind0 = jnp.take(mb.kind, jnp.clip(mat_idx, 0, mb.kind.shape[0] - 1))
        bits_p = jax.lax.bitcast_convert_type(isect.p, jnp.uint32)
        bits_w = jax.lax.bitcast_convert_type(isect.wo, jnp.uint32)
        h, _, _, _ = _rng.pcg4d(
            bits_p[..., 0] ^ bits_p[..., 2], bits_w[..., 0],
            bits_w[..., 1] ^ bits_p[..., 1], jnp.uint32(0x4D495843),
        )
        u = _rng.u32_to_uniform(h)
        amt = jnp.take(mb.mix_amount, jnp.clip(mat_idx, 0, None))
        m0 = jnp.take(mb.mix_m0, jnp.clip(mat_idx, 0, None))
        m1 = jnp.take(mb.mix_m1, jnp.clip(mat_idx, 0, None))
        mat_idx = jnp.where(
            kind0 == MAT_MIX, jnp.where(u < amt, m0, m1), mat_idx
        )
    params = scene.materials.gather(mat_idx)
    if lam is not None:
        params["lam"] = lam
    if scene.textures is not None:
        from ..textures.buffers import evaluate_albedo_coeffs

        face = None
        if scene.textures.has_ptex:
            # Ptex faceIndex: triangle index within its source shape
            # (PtexTexture::Evaluate, textures.cpp — ctx.faceIndex).
            n_tri = scene.geom.num_triangles
            if n_tri > 0:
                from ..core.gather import gather_rows as _gr

                ti = jnp.clip(isect.prim, 0, n_tri - 1)
                face = jnp.where(
                    isect.prim < n_tri, _gr(scene.geom.tri_face, ti), 0
                )
        params["albedo_coeffs"] = evaluate_albedo_coeffs(
            scene.textures, params["albedo_tex"], isect.uv, isect.p,
            params["albedo_coeffs"], face=face,
        )
    if params["any_hair"]:
        params["hair_h"] = jnp.clip(
            2.0 * isect.uv[..., 1] - 1.0, -0.9995, 0.9995
        )
    # Dielectric orientation: integrators shade in a frame flipped toward
    # wo, which erases the inside/outside distinction DielectricBxDF needs
    # to pick eta vs 1/eta (the reference keeps wo.z signed instead,
    # bxdfs.h:300). isect.n is canonical (outward for quadrics, winding for
    # meshes), so recover the side here: exiting rays see the inverted IOR,
    # which in the flipped frame reproduces the true refraction geometry
    # (mirror symmetry), Fresnel, TIR, and the radiance 1/eta^2 scaling.
    if scene.materials.any_dielectric:
        from .buffers import MAT_DIELECTRIC

        entering = jnp.sum(isect.n * isect.wo, axis=-1) >= 0.0
        params["eta"] = jnp.where(
            (params["kind"] == MAT_DIELECTRIC) & ~entering,
            1.0 / jnp.maximum(params["eta"], 1e-6),
            params["eta"],
        )
    return params


def _hair_args(params):
    bm = jnp.clip(params["roughness"], 1e-2, 1.0)
    bn = jnp.clip(params["coat_roughness"], 1e-2, 1.0)
    h = params.get("hair_h", jnp.zeros_like(bm))
    return h, params["eta"], bm, bn, params["hair_alpha"]


def _hair_sigma_a(params, lam):
    return rgb2spec.eval_unbounded(
        params["hair_sigma_coeffs"], params["hair_sigma_scale"], lam
    )


def _gather_spectral_eta_k(params, lam):
    eta = rgb2spec.eval_unbounded(
        params["cond_eta_coeffs"], params["cond_eta_scale"], lam
    )
    k = rgb2spec.eval_unbounded(
        params["cond_k_coeffs"], params["cond_k_scale"], lam
    )
    return eta, k


def retro_f(eta, k, alpha, wo, wi):
    """RetroreflectiveBxDF::f (the ISET fork, bxdfs.h:104-180): a standard
    GGX conductor lobe PLUS a retro lobe whose microfacet normal is wo
    itself — peaked around wi == wo — both weighted by the fork's
    (1 - (R_i - R_o)) dielectric-coating factor."""
    same = _same_hemisphere(wo, wi)
    alpha_r = jnp.maximum(alpha, 1e-3)
    standard = conductor_f(eta, k, alpha_r, wo, wi)
    cos_o = jnp.maximum(_abscos(wo), 1e-6)
    cos_i = jnp.maximum(_abscos(wi), 1e-6)
    wm_retro = wo * jnp.sign(wo[..., 2:3])
    d_retro = sc.ggx_d(wm_retro, alpha_r)
    g = sc.ggx_g(wo, wi, alpha_r)
    f_retro_fres = sc.fr_complex(jnp.abs(_dot(wo, wi))[..., None], eta, k)
    retro = (
        f_retro_fres * (d_retro * g / (4.0 * cos_o * cos_i))[..., None]
    )
    r_i = sc.fr_dielectric(jnp.abs(_dot(wi, wm_retro)),
                           jnp.full_like(cos_i, 1.59))
    wm = normalize_half(wo, wi)
    r_o = sc.fr_dielectric(jnp.abs(_dot(wo, wm)),
                           jnp.full_like(cos_o, 1.59))
    w = jnp.clip(1.0 - (r_i - r_o), 0.0, 2.0)[..., None]
    return jnp.where(same[..., None], w * (retro + standard), 0.0)


def normalize_half(wo, wi):
    h = wo + wi
    return h / jnp.maximum(
        jnp.sqrt(jnp.sum(h * h, axis=-1, keepdims=True)), 1e-9
    )


def _measured_f(params, wo, wi, lam):
    """Tabulated measured-BRDF lookup for the per-ray table indices
    (MeasuredBxDF::f role; see materials/measured.py for the layout)."""
    from .measured import (
        N_PD, N_TD, N_TH, _half_diff_angles, trilinear_taps,
    )

    same = wo[..., 2] * wi[..., 2] > 0.0
    flip = wo[..., 2:3] < 0.0
    wo_u = jnp.where(flip, -wo, wo)
    wi_u = jnp.where(flip, -wi, wi)
    th, td, pd = _half_diff_angles(wo_u, wi_u)
    mi = jnp.clip(params["measured_idx"], 0, None)
    base = mi * (N_TH * N_TD * N_PD)
    flat_c = params["measured_coeffs"].reshape(-1, 3)
    flat_s = params["measured_scale"].reshape(-1)
    val = 0.0
    for idx, w in trilinear_taps(th, td, pd):
        val = val + w[..., None] * rgb2spec.eval_unbounded(
            jnp.take(flat_c, base + idx, axis=0),
            jnp.take(flat_s, base + idx),
            lam,
        )
    return jnp.where(
        (same & (params["measured_idx"] >= 0))[..., None], val, 0.0
    )


def evaluate(params, wo, wi, lam):
    """f(wo, wi) for each ray given gathered material params; (N, S).

    Delta lobes (smooth conductor/dielectric/thin) return 0 here — their
    contribution arrives only through sampling.
    """
    kind = params["kind"]
    if params.get("any_subsurface"):
        from .buffers import MAT_SUBSURFACE

        # Subsurface surfaces expose the NormalizedFresnelBxDF Sw lobe
        # (bxdfs.h:1206); the diffusion transport happens in the
        # integrator (bssrdf.py).
        from .buffers import MAT_NORMFRESNEL

        kind = jnp.where(kind == MAT_SUBSURFACE, MAT_NORMFRESNEL, kind)
    albedo = rgb2spec.eval_sigmoid(params["albedo_coeffs"], lam)
    alpha = sc.roughness_to_alpha(params["roughness"])

    f = jnp.where(
        (kind == MAT_DIFFUSE)[..., None], diffuse_f(albedo, wo, wi), 0.0
    )
    if params.get("any_subsurface"):
        from .buffers import MAT_NORMFRESNEL

        f = jnp.where(
            (kind == MAT_NORMFRESNEL)[..., None],
            normfresnel_f(params["eta"], wo, wi, lam.shape[-1]),
            f,
        )
    any_cond = params["any_conductor"]
    if any_cond:
        eta_c, k_c = _gather_spectral_eta_k(params, lam)
        f = jnp.where(
            (kind == MAT_CONDUCTOR)[..., None],
            conductor_f(eta_c, k_c, alpha, wo, wi),
            f,
        )
    if params["any_dielectric"]:
        f_d = dielectric_f(params["eta"], alpha, wo, wi)
        f = jnp.where((kind == MAT_DIELECTRIC)[..., None], f_d[..., None], f)
    if params["any_diffusetrans"]:
        trans = rgb2spec.eval_sigmoid(params["trans_coeffs"], lam)
        f = jnp.where(
            (kind == MAT_DIFFUSETRANS)[..., None],
            diffusetrans_f(albedo, trans, wo, wi),
            f,
        )
    if params["any_coated"]:
        from .layered import layered_walk

        alpha_c = sc.roughness_to_alpha(params["coat_roughness"])
        alpha_c = jnp.maximum(alpha_c, 1e-3)
        f_cd = layered_walk(
            wo, wi,
            lambda a, b: diffuse_f(albedo, a, b),
            lambda a, u2_, uc_: diffuse_sample(albedo, a, u2_),
            alpha_c, thickness=params["thickness"],
        )
        f = jnp.where((kind == MAT_COATEDDIFFUSE)[..., None], f_cd, f)
        if params["any_conductor"]:
            eta_c, k_c = _gather_spectral_eta_k(params, lam)
            alpha_b = jnp.maximum(alpha, 1e-3)
            f_cc = layered_walk(
                wo, wi,
                lambda a, b: conductor_f(eta_c, k_c, alpha_b, a, b),
                lambda a, u2_, uc_: conductor_sample(
                    eta_c, k_c, alpha_b, a, u2_
                )[:3],
                alpha_c, thickness=params["thickness"], salt=1,
            )
            f = jnp.where((kind == MAT_COATEDCONDUCTOR)[..., None], f_cc, f)
    if params["any_hair"]:
        h, eta_h, bm, bn, tilt = _hair_args(params)
        sig_a = _hair_sigma_a(params, lam)
        f_h = hair.hair_f(h, eta_h, sig_a, bm, bn, tilt, wo, wi)
        f = jnp.where((kind == MAT_HAIR)[..., None], f_h, f)
    if params["any_measured"]:
        f_m = _measured_f(params, wo, wi, lam)
        from .buffers import MAT_MEASURED

        f = jnp.where((kind == MAT_MEASURED)[..., None], f_m, f)
    if params.get("any_retro"):
        from .buffers import MAT_RETRO

        eta_c, k_c = _gather_spectral_eta_k(params, lam)
        f_r = retro_f(eta_c, k_c, alpha, wo, wi)
        f = jnp.where((kind == MAT_RETRO)[..., None], f_r, f)
    return f


def pdf(params, wo, wi):
    kind = params["kind"]
    if params.get("any_subsurface"):
        from .buffers import MAT_SUBSURFACE

        # Subsurface surfaces expose the NormalizedFresnelBxDF Sw lobe
        # (bxdfs.h:1206): cosine-distributed, same pdf as diffuse.
        from .buffers import MAT_NORMFRESNEL

        kind = jnp.where(kind == MAT_SUBSURFACE, MAT_NORMFRESNEL, kind)
        kind = jnp.where(kind == MAT_NORMFRESNEL, MAT_DIFFUSE, kind)
    alpha = sc.roughness_to_alpha(params["roughness"])
    p = jnp.where(kind == MAT_DIFFUSE, diffuse_pdf(wo, wi), 0.0)
    if params["any_conductor"]:
        p = jnp.where(kind == MAT_CONDUCTOR, conductor_pdf(alpha, wo, wi), p)
    if params["any_dielectric"]:
        p = jnp.where(
            kind == MAT_DIELECTRIC, dielectric_pdf(params["eta"], alpha, wo, wi), p
        )
    if params["any_diffusetrans"]:
        p = jnp.where(kind == MAT_DIFFUSETRANS, diffusetrans_pdf(wo, wi), p)
    if params["any_coated"]:
        alpha_c = jnp.maximum(
            sc.roughness_to_alpha(params["coat_roughness"]), 1e-3
        )
        p_cd = coated_pdf(diffuse_pdf(wo, wi), alpha_c, wo, wi)
        p = jnp.where(kind == MAT_COATEDDIFFUSE, p_cd, p)
        if params["any_conductor"]:
            p_cc = coated_pdf(
                conductor_pdf(jnp.maximum(alpha, 1e-3), wo, wi),
                alpha_c, wo, wi,
            )
            p = jnp.where(kind == MAT_COATEDCONDUCTOR, p_cc, p)
    if params["any_hair"]:
        h, eta_h, bm, bn, tilt = _hair_args(params)
        sig_a = _hair_sigma_a(params, params["lam"])
        p_h = hair.hair_pdf(h, eta_h, sig_a, bm, bn, tilt, wo, wi)
        p = jnp.where(kind == MAT_HAIR, p_h, p)
    if params["any_measured"]:
        from .buffers import MAT_MEASURED

        p = jnp.where(kind == MAT_MEASURED, diffuse_pdf(wo, wi), p)
    if params.get("any_retro"):
        from .buffers import MAT_RETRO

        p = jnp.where(
            kind == MAT_RETRO,
            conductor_pdf(jnp.maximum(alpha, 1e-3), wo, wi), p,
        )
    return p


def sample(params, wo, lam, u2, uc):
    """Sample wi for each ray. Returns dict(wi, f, pdf, specular)."""
    kind = params["kind"]
    if params.get("any_subsurface"):
        from .buffers import MAT_SUBSURFACE

        # Subsurface surfaces expose the NormalizedFresnelBxDF Sw lobe
        # (bxdfs.h:1206); same cosine sampling, Fresnel-shaped weight.
        from .buffers import MAT_NORMFRESNEL

        kind = jnp.where(kind == MAT_SUBSURFACE, MAT_NORMFRESNEL, kind)
    albedo = rgb2spec.eval_sigmoid(params["albedo_coeffs"], lam)
    alpha = sc.roughness_to_alpha(params["roughness"])

    wi, f, p = diffuse_sample(albedo, wo, u2)
    specular = jnp.zeros(wo.shape[:-1], bool)

    if params.get("any_subsurface"):
        from .buffers import MAT_NORMFRESNEL

        m = kind == MAT_NORMFRESNEL
        f = jnp.where(
            m[..., None],
            normfresnel_f(params["eta"], wo, wi, lam.shape[-1]),
            f,
        )

    if params["any_conductor"]:
        eta_c, k_c = _gather_spectral_eta_k(params, lam)
        wi_c, f_c, p_c, spec_c = conductor_sample(eta_c, k_c, alpha, wo, u2)
        m = kind == MAT_CONDUCTOR
        wi = jnp.where(m[..., None], wi_c, wi)
        f = jnp.where(m[..., None], f_c, f)
        p = jnp.where(m, p_c, p)
        specular = jnp.where(m, spec_c, specular)

    if params["any_dielectric"]:
        wi_d, f_d, p_d, spec_d = dielectric_sample(
            params["eta"], alpha, wo, u2, uc
        )
        m = kind == MAT_DIELECTRIC
        wi = jnp.where(m[..., None], wi_d, wi)
        f = jnp.where(m[..., None], f_d[..., None], f)
        p = jnp.where(m, p_d, p)
        specular = jnp.where(m, spec_d, specular)

    if params["any_diffusetrans"]:
        trans = rgb2spec.eval_sigmoid(params["trans_coeffs"], lam)
        wi_dt, f_dt, p_dt = diffusetrans_sample(albedo, trans, wo, u2, uc)
        m = kind == MAT_DIFFUSETRANS
        wi = jnp.where(m[..., None], wi_dt, wi)
        f = jnp.where(m[..., None], f_dt, f)
        p = jnp.where(m, p_dt, p)
        specular = jnp.where(m, False, specular)

    if params["any_coated"]:
        alpha_c = jnp.maximum(
            sc.roughness_to_alpha(params["coat_roughness"]), 1e-3
        )
        from .layered import layered_walk

        wi_cd, f_cd, p_cd = coated_sample(
            lambda u: diffuse_sample(albedo, wo, u),
            lambda wi_: diffuse_f(albedo, wo, wi_),
            lambda wi_: diffuse_pdf(wo, wi_),
            alpha_c, wo, u2, uc,
        )
        f_cd = layered_walk(
            wo, wi_cd,
            lambda a, b: diffuse_f(albedo, a, b),
            lambda a, u2_, uc_: diffuse_sample(albedo, a, u2_),
            alpha_c, thickness=params["thickness"],
        )
        f_cd = jnp.where(
            (_same_hemisphere(wo, wi_cd) & (p_cd > 0.0))[..., None],
            f_cd, 0.0,
        )
        m = kind == MAT_COATEDDIFFUSE
        wi = jnp.where(m[..., None], wi_cd, wi)
        f = jnp.where(m[..., None], f_cd, f)
        p = jnp.where(m, p_cd, p)
        specular = jnp.where(m, False, specular)
        if params["any_conductor"]:
            eta_c, k_c = _gather_spectral_eta_k(params, lam)
            alpha_b = jnp.maximum(alpha, 1e-3)
            wi_cc, f_cc, p_cc = coated_sample(
                lambda u: conductor_sample(eta_c, k_c, alpha_b, wo, u)[:3],
                lambda wi_: conductor_f(eta_c, k_c, alpha_b, wo, wi_),
                lambda wi_: conductor_pdf(alpha_b, wo, wi_),
                alpha_c, wo, u2, uc,
            )
            f_cc = layered_walk(
                wo, wi_cc,
                lambda a, b: conductor_f(eta_c, k_c, alpha_b, a, b),
                lambda a, u2_, uc_: conductor_sample(
                    eta_c, k_c, alpha_b, a, u2_
                )[:3],
                alpha_c, thickness=params["thickness"], salt=1,
            )
            f_cc = jnp.where(
                (_same_hemisphere(wo, wi_cc) & (p_cc > 0.0))[..., None],
                f_cc, 0.0,
            )
            m = kind == MAT_COATEDCONDUCTOR
            wi = jnp.where(m[..., None], wi_cc, wi)
            f = jnp.where(m[..., None], f_cc, f)
            p = jnp.where(m, p_cc, p)
            specular = jnp.where(m, False, specular)

    if params["any_measured"]:
        from .buffers import MAT_MEASURED

        wi_m, _, p_m = diffuse_sample(albedo, wo, u2)
        f_m = _measured_f(params, wo, wi_m, lam)
        m = kind == MAT_MEASURED
        wi = jnp.where(m[..., None], wi_m, wi)
        f = jnp.where(m[..., None], f_m, f)
        p = jnp.where(m, p_m, p)
        specular = jnp.where(m, False, specular)

    if params.get("any_retro"):
        from .buffers import MAT_RETRO

        eta_c, k_c = _gather_spectral_eta_k(params, lam)
        alpha_r = jnp.maximum(alpha, 1e-3)
        wi_r, _, p_r, _ = conductor_sample(eta_c, k_c, alpha_r, wo, u2)
        f_r = retro_f(eta_c, k_c, alpha_r, wo, wi_r)
        m = kind == MAT_RETRO
        wi = jnp.where(m[..., None], wi_r, wi)
        f = jnp.where(m[..., None], f_r, f)
        p = jnp.where(m, p_r, p)
        specular = jnp.where(m, False, specular)

    if params["any_hair"]:
        h, eta_h, bm, bn, tilt = _hair_args(params)
        sig_a = _hair_sigma_a(params, lam)
        wi_h, f_h, p_h = hair.hair_sample(
            h, eta_h, sig_a, bm, bn, tilt, wo, u2, uc
        )
        m = kind == MAT_HAIR
        wi = jnp.where(m[..., None], wi_h, wi)
        f = jnp.where(m[..., None], f_h, f)
        p = jnp.where(m, p_h, p)
        specular = jnp.where(m, False, specular)

    if params["any_thin"]:
        wi_t, f_t, p_t = thin_dielectric_sample(params["eta"], wo, uc)
        m = kind == MAT_THINDIELECTRIC
        wi = jnp.where(m[..., None], wi_t, wi)
        f = jnp.where(m[..., None], f_t[..., None], f)
        p = jnp.where(m, p_t, p)
        specular = specular | m

    if params.get("any_interface_mat"):
        # Material-less boundary (Material "none"): the ray continues
        # straight through with unit throughput — wi = -wo, f chosen so
        # f * |cos| / pdf == 1 (pbrt skips the intersection entirely;
        # here it is a delta "transmission" so media can switch).
        from .buffers import MAT_INTERFACE

        m = kind == MAT_INTERFACE
        wi_i = -wo
        f_i = 1.0 / jnp.maximum(jnp.abs(wo[..., 2:3]), 1e-4)
        wi = jnp.where(m[..., None], wi_i, wi)
        f = jnp.where(m[..., None], f_i, f)
        p = jnp.where(m, 1.0, p)
        specular = specular | m

    return {"wi": wi, "f": f, "pdf": p, "specular": specular}

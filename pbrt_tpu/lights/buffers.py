"""Flat light arrays + NEE sampling.

Light list layout: [area lights (one per emissive triangle)] ++ [point] ++
[distant]. An optional uniform infinite light handles escaped rays.

Emission RGBs are stored as sigmoid-polynomial coefficients + scale; each
light flags whether its spectrum is D65-illuminant-shaped (pbrt's
RGBIlluminantSpectrum, lights.cpp DiffuseAreaLight) or flat.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import cie, rgb2spec
from ..core.gather import gather_rows
from ..core.pytree import pytree, static_field
from ..core.sampling import sample_uniform_triangle
from ..core.vecmath import dot, normalize

_EPS = 1e-9


@pytree
class LightLiSample:
    """Result of SampleLi for a batch of reference points.

    Reference analogue: LightLiSample (base/light.h:62).
    """

    L: jnp.ndarray  # (N, S) incident radiance (1/d^2 folded in for delta lights)
    wi: jnp.ndarray  # (N, 3)
    pdf: jnp.ndarray  # (N,) solid-angle pdf incl. selection pmf (delta: pmf only)
    dist: jnp.ndarray  # (N,) distance to the light point (inf for distant)
    is_delta: jnp.ndarray  # (N,) bool


def eval_emission(coeffs, scale, illum, lam):
    """Emission spectrum: sigmoid poly x scale, optionally D65-shaped.

    illum: broadcastable bool — True follows pbrt's RGBIlluminantSpectrum
    (D65-modulated, spectrum.h:595); False is a flat-spectrum emitter (exact
    for analytic tests and constant-radiance sources).
    """
    base = rgb2spec.eval_unbounded(coeffs, scale, lam)
    d65 = cie.illuminant_d65(lam) * (1.0 / 100.0)
    return jnp.where(jnp.asarray(illum)[..., None], base * d65, base)


def _image_emission(coeffs, scale_tx, illum, light_idx, u, v, lam):
    """Per-ray nearest-texel emission from a (L, R, R) intensity-image
    stack (ProjectionLight::I / GoniometricLight::I image lookup)."""
    L_, R = coeffs.shape[0], coeffs.shape[1]
    xi = jnp.clip((jnp.clip(u, 0.0, 1.0) * R).astype(jnp.int32), 0, R - 1)
    yi = jnp.clip((jnp.clip(v, 0.0, 1.0) * R).astype(jnp.int32), 0, R - 1)
    fi = (light_idx * R + yi) * R + xi
    c = gather_rows(coeffs.reshape(L_ * R * R, 3), fi)
    s = gather_rows(scale_tx.reshape(L_ * R * R), fi)
    return eval_emission(c, s, gather_rows(illum, light_idx), lam)


@pytree
class LightBuffers:
    # Area lights: one emissive triangle each.
    area_verts: jnp.ndarray  # (La, 3, 3)
    area_coeffs: jnp.ndarray  # (La, 3)
    area_scale: jnp.ndarray  # (La,)
    area_illum: jnp.ndarray  # (La,) bool: D65-shaped vs flat spectrum
    area_two_sided: jnp.ndarray  # (La,) bool
    area_area: jnp.ndarray  # (La,) triangle area
    # Emissive analytic spheres (DiffuseAreaLight over a Sphere shape).
    # One-sided emitters radiating along the outward normal unless two
    # (reference: lights.h DiffuseAreaLight::L + shapes.cpp Sphere::Sample
    # cone solid-angle sampling). Light ids na..na+Lq-1.
    sphl_c: jnp.ndarray  # (Lq, 3) center
    sphl_r: jnp.ndarray  # (Lq,) radius
    sphl_coeffs: jnp.ndarray  # (Lq, 3)
    sphl_scale: jnp.ndarray  # (Lq,)
    sphl_illum: jnp.ndarray  # (Lq,) bool
    sphl_two: jnp.ndarray  # (Lq,) bool
    # Point lights.
    point_p: jnp.ndarray  # (Lp, 3)
    point_coeffs: jnp.ndarray  # (Lp, 3)
    point_scale: jnp.ndarray  # (Lp,)
    point_illum: jnp.ndarray  # (Lp,) bool
    # Spot lights (SpotLight, lights.h: cone falloff delta light).
    spot_p: jnp.ndarray  # (Ls, 3)
    spot_dir: jnp.ndarray  # (Ls, 3) unit cone axis
    spot_cos_start: jnp.ndarray  # (Ls,) cos(falloffStart)
    spot_cos_end: jnp.ndarray  # (Ls,) cos(totalWidth)
    spot_coeffs: jnp.ndarray  # (Ls, 3)
    spot_scale: jnp.ndarray  # (Ls,)
    spot_illum: jnp.ndarray  # (Ls,) bool
    # Projection lights (ProjectionLight, lights.h:482): delta position
    # projecting an image through a perspective window.
    proj_p: jnp.ndarray  # (Lj, 3)
    proj_rot: jnp.ndarray  # (Lj, 3, 3) world->light rotation (rows x,y,z)
    proj_tan: jnp.ndarray  # (Lj,) tan(fov/2)
    proj_coeffs: jnp.ndarray  # (Lj, R, R, 3) per-texel unbounded fits
    proj_scale_tx: jnp.ndarray  # (Lj, R, R)
    proj_illum: jnp.ndarray  # (Lj,) bool
    # Goniometric lights (GoniometricLight, lights.h:584): delta position
    # with an equal-area-octahedral intensity image over direction.
    gonio_p: jnp.ndarray  # (Lg, 3)
    gonio_rot: jnp.ndarray  # (Lg, 3, 3)
    gonio_coeffs: jnp.ndarray  # (Lg, R, R, 3)
    gonio_scale_tx: jnp.ndarray  # (Lg, R, R)
    gonio_illum: jnp.ndarray  # (Lg,) bool
    # Distant lights.
    distant_dir: jnp.ndarray  # (Ld, 3) direction the light travels (w_light)
    distant_coeffs: jnp.ndarray  # (Ld, 3)
    distant_scale: jnp.ndarray  # (Ld,)
    distant_illum: jnp.ndarray  # (Ld,) bool
    # Uniform infinite light (0 or 1).
    infinite_coeffs: jnp.ndarray  # (3,)
    infinite_scale: jnp.ndarray  # ()
    infinite_illum: jnp.ndarray  # () bool
    # Light-selection distribution (uniform or power-proportional).
    select_cdf: jnp.ndarray  # (n_lights,) inclusive cdf
    select_pmf: jnp.ndarray  # (n_lights,)
    # Image-based environment light (replaces the uniform infinite light).
    env: object = None  # Optional[EnvironmentMap]
    # Many-light BVH (lights/bvh.py); set when sampler == "bvh".
    bvh: object = None  # Optional[LightBVH]
    # ExhaustiveLightSampler (base/lightsampler.h:29): per-light packed
    # LightBounds records, importance evaluated for EVERY light at every
    # shading point; set when sampler == "exhaustive". The brute-force
    # oracle the BVH descent is gated against in tests/test_lightbvh.py.
    exh_recs: object = None  # Optional[(L, 16) f32]
    has_infinite: bool = static_field(default=False)
    sampler: str = static_field(default="uniform")

    @property
    def n_area(self) -> int:
        return self.area_verts.shape[0]

    @property
    def n_sphl(self) -> int:
        return self.sphl_c.shape[0]

    @property
    def n_point(self) -> int:
        return self.point_p.shape[0]

    @property
    def n_spot(self) -> int:
        return self.spot_p.shape[0]

    @property
    def n_proj(self) -> int:
        return self.proj_p.shape[0]

    @property
    def n_gonio(self) -> int:
        return self.gonio_p.shape[0]

    @property
    def n_distant(self) -> int:
        return self.distant_dir.shape[0]

    @property
    def has_env(self) -> bool:
        return self.env is not None

    @property
    def n_lights(self) -> int:
        return (
            self.n_area + self.n_sphl + self.n_point + self.n_spot
            + self.n_proj + self.n_gonio + self.n_distant
            + (1 if (self.has_infinite or self.has_env) else 0)
        )

    @staticmethod
    def build(
        area_tris=None,  # dicts: verts (3,3), rgb, scale, two_sided, illuminant
        sphere_lights=None,  # dicts: c (3,), r, rgb, scale, two_sided, illuminant
        points=None,  # dicts: p, rgb, scale, illuminant
        spots=None,  # dicts: p, to, rgb, scale, coneangle, conedelta, illuminant
        projections=None,  # dicts: p, to, fov, rgb|rgb_image, scale, illuminant
        gonios=None,  # dicts: p, to, rgb|rgb_image, scale, illuminant
        distants=None,  # dicts: dir (travel direction), rgb, scale, illuminant
        infinite=None,  # dict: rgb, scale, illuminant — or None
        envmap=None,  # EnvironmentMap — replaces `infinite` when given
        sampler: str = "uniform",  # "uniform" | "power" | "bvh" selection
    ) -> "LightBuffers":
        def _fit(rgbs):
            if not len(rgbs):
                return jnp.zeros((0, 3), jnp.float32), jnp.zeros((0,), jnp.float32)
            return rgb2spec.fit_unbounded(jnp.asarray(rgbs, jnp.float32))

        def _flags(specs, key, default):
            if not specs:
                return jnp.zeros((0,), bool)
            return jnp.asarray([bool(s.get(key, default)) for s in specs], bool)

        area_tris = area_tris or []
        sphere_lights = sphere_lights or []
        points = points or []
        spots = spots or []
        projections = projections or []
        gonios = gonios or []
        distants = distants or []

        def _frame(spec):
            z = np.asarray(spec.get("to", (0, 0, 1)), np.float64) - np.asarray(
                spec["p"], np.float64
            )
            nz = np.linalg.norm(z)
            z = z / nz if nz > 0 else np.array([0.0, 0.0, 1.0])
            up = np.asarray(spec.get("up", (0, 1, 0)), np.float64)
            x = np.cross(up, z)
            if np.linalg.norm(x) < 1e-8:
                x = np.cross(np.array([1.0, 0.0, 0.0]), z)
            x = x / np.linalg.norm(x)
            y = np.cross(z, x)
            return np.stack([x, y, z])  # world->light rows

        def _img_grid(specs, res=64):
            # Resample each light's rgb image (or constant rgb) onto a
            # shared (res, res) grid and fit unbounded spectra per texel.
            if not specs:
                zc = jnp.zeros((0, res, res, 3), jnp.float32)
                return zc, jnp.zeros((0, res, res), jnp.float32), []
            grids, means = [], []
            for s in specs:
                if "rgb_image" in s and s["rgb_image"] is not None:
                    im = np.asarray(s["rgb_image"], np.float32)
                    yy = np.clip(
                        (np.arange(res) * im.shape[0] // res), 0,
                        im.shape[0] - 1,
                    )
                    xx = np.clip(
                        (np.arange(res) * im.shape[1] // res), 0,
                        im.shape[1] - 1,
                    )
                    g = im[yy][:, xx]
                else:
                    g = np.broadcast_to(
                        np.asarray(s.get("rgb", (1.0, 1.0, 1.0)), np.float32),
                        (res, res, 3),
                    )
                g = g * float(s.get("scale", 1.0))
                grids.append(g)
                means.append(float(g.mean()))
            arr = jnp.asarray(np.stack(grids))
            c, sc = rgb2spec.fit_unbounded(arr)
            return c, sc, means

        pj_c, pj_s, pj_means = _img_grid(projections)
        gn_c, gn_s, gn_means = _img_grid(gonios)
        pj_rot = np.stack(
            [_frame(s) for s in projections]
        ) if projections else np.zeros((0, 3, 3))
        gn_rot = np.stack(
            [_frame(s) for s in gonios]
        ) if gonios else np.zeros((0, 3, 3))
        pj_tan = np.asarray(
            [np.tan(np.deg2rad(s.get("fov", 45.0)) / 2.0)
             for s in projections], np.float32,
        )

        av = np.asarray([a["verts"] for a in area_tris], np.float32).reshape(
            -1, 3, 3
        )
        ac, asc = _fit(
            [np.asarray(a["rgb"]) * a.get("scale", 1.0) for a in area_tris]
        )
        if len(av):
            e1 = av[:, 1] - av[:, 0]
            e2 = av[:, 2] - av[:, 0]
            areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        else:
            areas = np.zeros((0,), np.float32)

        qc_ = np.asarray(
            [q["c"] for q in sphere_lights], np.float32
        ).reshape(-1, 3)
        qr_ = np.asarray(
            [q["r"] for q in sphere_lights], np.float32
        ).reshape(-1)
        qcoef, qsc = _fit(
            [np.asarray(q["rgb"]) * q.get("scale", 1.0)
             for q in sphere_lights]
        )

        pp = np.asarray([p["p"] for p in points], np.float32).reshape(-1, 3)
        pc, psc = _fit(
            [np.asarray(p["rgb"]) * p.get("scale", 1.0) for p in points]
        )

        sp_p = np.asarray([s["p"] for s in spots], np.float32).reshape(-1, 3)
        sp_to = np.asarray(
            [s.get("to", (0, -1, 0)) for s in spots], np.float32
        ).reshape(-1, 3)
        sp_dir = sp_to - sp_p
        if len(sp_dir):
            sp_dir = sp_dir / np.linalg.norm(sp_dir, axis=-1, keepdims=True)
        sp_cone = np.asarray(
            [np.deg2rad(s.get("coneangle", 30.0)) for s in spots], np.float32
        )
        sp_delta = np.asarray(
            [np.deg2rad(s.get("conedelta", 5.0)) for s in spots], np.float32
        )
        spc, spsc = _fit([np.asarray(s["rgb"]) * s.get("scale", 1.0) for s in spots])

        dd = np.asarray([d["dir"] for d in distants], np.float32).reshape(-1, 3)
        if len(dd):
            dd = dd / np.linalg.norm(dd, axis=-1, keepdims=True)
        dc, dsc = _fit(
            [np.asarray(d["rgb"]) * d.get("scale", 1.0) for d in distants]
        )

        if infinite is not None:
            ic, isc = rgb2spec.fit_unbounded(
                jnp.asarray(infinite["rgb"], jnp.float32)
                * infinite.get("scale", 1.0)
            )
            iil = jnp.asarray(bool(infinite.get("illuminant", True)))
        else:
            ic = jnp.zeros((3,), jnp.float32)
            isc = jnp.zeros((), jnp.float32)
            iil = jnp.asarray(False)

        # --- Selection distribution (PowerLightSampler semantics,
        # lightsamplers.h:29 — luminance-proportional; uniform fallback).
        powers = []
        area_list = areas if len(av) else np.zeros((0,))
        for i, a in enumerate(area_tris):
            lum = float(np.mean(a["rgb"])) * a.get("scale", 1.0)
            two = 2.0 if a.get("two_sided", False) else 1.0
            powers.append(lum * float(area_list[i]) * np.pi * two)
        for q in sphere_lights:
            lum = float(np.mean(q["rgb"])) * q.get("scale", 1.0)
            two = 2.0 if q.get("two_sided", False) else 1.0
            powers.append(
                lum * 4.0 * np.pi * float(q["r"]) ** 2 * np.pi * two
            )
        for p in points:
            powers.append(float(np.mean(p["rgb"])) * p.get("scale", 1.0) * 4 * np.pi)
        for s in spots:
            solid = 2 * np.pi * (1 - np.cos(np.deg2rad(s.get("coneangle", 30.0))))
            powers.append(float(np.mean(s["rgb"])) * s.get("scale", 1.0) * solid)
        for i, s in enumerate(projections):
            half = np.deg2rad(s.get("fov", 45.0)) / 2.0
            solid = 2 * np.pi * (1 - np.cos(half * np.sqrt(2.0)))
            powers.append(pj_means[i] * solid)
        for i, s in enumerate(gonios):
            powers.append(gn_means[i] * 4 * np.pi)
        for dl in distants:
            powers.append(float(np.mean(dl["rgb"])) * dl.get("scale", 1.0) * np.pi)
        if envmap is not None:
            powers.append(
                float(jnp.mean(envmap.luminance) * envmap.strength) * 4 * np.pi
            )
        elif infinite is not None:
            powers.append(
                float(np.mean(infinite["rgb"])) * infinite.get("scale", 1.0)
                * 4 * np.pi
            )
        powers = np.asarray(powers, np.float64)
        nl = len(powers)
        if nl == 0:
            pmf = np.zeros((0,))
        elif sampler == "power" and powers.sum() > 0:
            pmf = powers / powers.sum()
        else:
            pmf = np.full(nl, 1.0 / nl)
        cdf = np.cumsum(pmf)

        lb = LightBuffers(
            select_cdf=jnp.asarray(cdf, jnp.float32),
            select_pmf=jnp.asarray(pmf, jnp.float32),
            env=envmap,
            sampler=sampler,
            area_verts=jnp.asarray(av),
            area_coeffs=ac,
            area_scale=asc,
            area_illum=_flags(area_tris, "illuminant", True),
            area_two_sided=_flags(area_tris, "two_sided", False),
            area_area=jnp.asarray(areas, jnp.float32),
            sphl_c=jnp.asarray(qc_),
            sphl_r=jnp.asarray(qr_),
            sphl_coeffs=qcoef,
            sphl_scale=qsc,
            sphl_illum=_flags(sphere_lights, "illuminant", True),
            sphl_two=_flags(sphere_lights, "two_sided", False),
            point_p=jnp.asarray(pp),
            point_coeffs=pc,
            point_scale=psc,
            point_illum=_flags(points, "illuminant", True),
            spot_p=jnp.asarray(sp_p),
            spot_dir=jnp.asarray(sp_dir.reshape(-1, 3), jnp.float32),
            spot_cos_start=jnp.asarray(
                np.cos(np.maximum(sp_cone - sp_delta, 0.0)), jnp.float32
            ),
            spot_cos_end=jnp.asarray(np.cos(sp_cone), jnp.float32),
            spot_coeffs=spc,
            spot_scale=spsc,
            spot_illum=_flags(spots, "illuminant", True),
            proj_p=jnp.asarray(
                np.asarray([s["p"] for s in projections],
                           np.float32).reshape(-1, 3)
            ),
            proj_rot=jnp.asarray(pj_rot, jnp.float32),
            proj_tan=jnp.asarray(pj_tan.reshape(-1), jnp.float32),
            proj_coeffs=pj_c,
            proj_scale_tx=pj_s,
            proj_illum=_flags(projections, "illuminant", True),
            gonio_p=jnp.asarray(
                np.asarray([s["p"] for s in gonios],
                           np.float32).reshape(-1, 3)
            ),
            gonio_rot=jnp.asarray(gn_rot, jnp.float32),
            gonio_coeffs=gn_c,
            gonio_scale_tx=gn_s,
            gonio_illum=_flags(gonios, "illuminant", True),
            distant_dir=jnp.asarray(dd, jnp.float32),
            distant_coeffs=dc,
            distant_scale=dsc,
            distant_illum=_flags(distants, "illuminant", True),
            infinite_coeffs=ic,
            infinite_scale=isc,
            infinite_illum=iil,
            has_infinite=infinite is not None,
        )
        if sampler == "bvh":
            from .bvh import LightBVH

            lb = lb.replace(bvh=LightBVH.build(lb))
        elif sampler == "exhaustive":
            from .bvh import light_bounds_arrays, pack_light_records

            lbs = light_bounds_arrays(lb)
            if len(lbs):
                lb = lb.replace(
                    exh_recs=jnp.asarray(pack_light_records(lbs))
                )
        return lb

    # -- selection ----------------------------------------------------------

    @property
    def n_bvh(self) -> int:
        """Positional lights held by the light BVH (area + sphere + point +
        spot + projection + goniometric)."""
        return (self.n_area + self.n_sphl + self.n_point + self.n_spot
                + self.n_proj + self.n_gonio)

    @property
    def n_inf_list(self) -> int:
        """Lights sampled outside the BVH (distant + infinite/env) —
        reference: lights without Bounds() go to BVHLightSampler's
        infiniteLights list (lightsamplers.h:260)."""
        return self.n_distant + (1 if (self.has_infinite or self.has_env)
                                 else 0)

    @property
    def _p_infinite(self) -> float:
        """Probability of sampling the non-BVH light list (reference
        BVHLightSampler::Sample: count-proportional split)."""
        ni = self.n_inf_list
        if (self.bvh is None and self.exh_recs is None) or ni == 0:
            return 0.0 if self.n_bvh > 0 else 1.0
        return ni / (ni + 1.0)

    def select(self, p_ref, n_ref, u_select):
        """Pick a light per shading point: (idx (N,) int32, pmf (N,)).

        BVH mode: shading-point-driven stochastic descent; exhaustive mode:
        importance over every light (the BVH's oracle); otherwise the
        tabulated power/uniform cdf."""
        n = self.n_lights
        if self.exh_recs is not None:
            from . import bvh as light_bvh

            imp = light_bvh.exhaustive_importance(
                self.exh_recs, p_ref, n_ref
            )  # (N, L)
            tot = jnp.sum(imp, axis=-1)
            alive = tot > 0.0
            pmf_l = imp / jnp.maximum(tot, 1e-30)[:, None]
            p_inf = self._p_infinite
            ni = self.n_inf_list
            if ni > 0:
                pick_inf = u_select < p_inf
                inf_off = jnp.minimum(
                    (u_select / max(p_inf, 1e-9) * ni).astype(jnp.int32),
                    ni - 1,
                )
                inf_idx = self.n_bvh + inf_off
            else:
                pick_inf = jnp.zeros(u_select.shape, bool)
                inf_idx = jnp.zeros(u_select.shape, jnp.int32)
            u_b = jnp.clip(
                (u_select - p_inf) / max(1.0 - p_inf, 1e-9), 0.0, 1.0 - 1e-7
            )
            cdf = jnp.cumsum(pmf_l, axis=-1)
            bl = jnp.minimum(
                jnp.sum((cdf <= u_b[:, None]).astype(jnp.int32), axis=-1),
                imp.shape[-1] - 1,
            )
            bpmf = jnp.take_along_axis(
                pmf_l, bl[:, None], axis=-1
            )[:, 0]
            idx = jnp.where(pick_inf, inf_idx, bl)
            pmf = jnp.where(
                pick_inf,
                p_inf / max(ni, 1),
                (1.0 - p_inf) * bpmf * alive,
            )
            idx = jnp.where(pick_inf | alive, idx, -1)
            return idx, pmf
        if self.bvh is not None:
            from . import bvh as light_bvh

            p_inf = self._p_infinite
            ni = self.n_inf_list
            if ni > 0:
                pick_inf = u_select < p_inf
                inf_off = jnp.minimum(
                    (u_select / max(p_inf, 1e-9) * ni).astype(jnp.int32),
                    ni - 1,
                )
                inf_idx = self.n_bvh + inf_off
            else:
                pick_inf = jnp.zeros(u_select.shape, bool)
                inf_idx = jnp.zeros(u_select.shape, jnp.int32)
            u_bvh = jnp.clip(
                (u_select - p_inf) / max(1.0 - p_inf, 1e-9), 0.0, 1.0 - 1e-7
            )
            bl, bpmf = light_bvh.sample(self.bvh, p_ref, n_ref, u_bvh)
            idx = jnp.where(pick_inf, inf_idx, jnp.maximum(bl, 0))
            pmf = jnp.where(
                pick_inf,
                p_inf / max(ni, 1),
                (1.0 - p_inf) * bpmf * (bl >= 0),
            )
            return idx, pmf
        idx = jnp.minimum(
            jnp.sum(
                (self.select_cdf[None, :] <= u_select[..., None]).astype(
                    jnp.int32
                ),
                axis=-1,
            ),
            n - 1,
        )
        return idx, gather_rows(self.select_pmf, idx)

    def selection_pmf(self, light_idx, p_ref=None, n_ref=None):
        """PMF that `select` picks light_idx (>=0) at p_ref. Used for MIS
        when a BSDF ray lands on a light (BVHLightSampler::PMF)."""
        if self.exh_recs is not None:
            from . import bvh as light_bvh

            imp = light_bvh.exhaustive_importance(
                self.exh_recs, p_ref, n_ref
            )
            tot = jnp.sum(imp, axis=-1)
            p_inf = self._p_infinite
            ni = self.n_inf_list
            in_pos = (light_idx >= 0) & (light_idx < self.n_bvh)
            li = jnp.clip(light_idx, 0, imp.shape[-1] - 1)
            pm_pos = (1.0 - p_inf) * jnp.take_along_axis(
                imp, li[:, None], axis=-1
            )[:, 0] / jnp.maximum(tot, 1e-30)
            pm_inf = p_inf / max(ni, 1)
            return jnp.where(
                in_pos, jnp.where(tot > 0.0, pm_pos, 0.0),
                jnp.where(light_idx >= 0, pm_inf, 0.0),
            )
        if self.bvh is not None:
            from . import bvh as light_bvh

            p_inf = self._p_infinite
            ni = self.n_inf_list
            in_bvh = (light_idx >= 0) & (light_idx < self.n_bvh)
            pm = (1.0 - p_inf) * light_bvh.pmf(
                self.bvh, p_ref, n_ref, jnp.where(in_bvh, light_idx, 0)
            )
            pm_inf = p_inf / max(ni, 1)
            return jnp.where(
                in_bvh, pm, jnp.where(light_idx >= 0, pm_inf, 0.0)
            )
        i = jnp.clip(light_idx, 0, self.n_lights - 1)
        return jnp.where(
            light_idx >= 0, gather_rows(self.select_pmf, i), 0.0
        )

    # -- emission queries ---------------------------------------------------

    def _area_packed(self):
        """(La, 16) packed area-light table: one gather serves the NEE branch
        (verts 0:9, coeffs 9:12, scale 12, illum 13, two_sided 14, area 15)."""
        f32 = jnp.float32
        return jnp.concatenate(
            [
                self.area_verts.reshape(-1, 9),
                self.area_coeffs,
                self.area_scale[:, None],
                self.area_illum.astype(f32)[:, None],
                self.area_two_sided.astype(f32)[:, None],
                self.area_area[:, None],
            ],
            axis=1,
        )


    def _sphl_packed(self):
        """(Lq, 10) packed sphere-light table: c 0:3, r 3, coeffs 4:7,
        scale 7, illum 8, two_sided 9."""
        f32 = jnp.float32
        return jnp.concatenate(
            [
                self.sphl_c,
                self.sphl_r[:, None],
                self.sphl_coeffs,
                self.sphl_scale[:, None],
                self.sphl_illum.astype(f32)[:, None],
                self.sphl_two.astype(f32)[:, None],
            ],
            axis=1,
        )

    def area_radiance(self, light_idx, lam):
        """Emitted radiance of emissive-geometry light `light_idx` (area
        triangle or analytic sphere) at wavelengths lam."""
        na, nq = self.n_area, self.n_sphl
        if na + nq == 0:
            return jnp.zeros_like(lam)
        out = jnp.zeros(light_idx.shape + (lam.shape[-1],), lam.dtype)
        if na > 0:
            i = jnp.clip(light_idx, 0, na - 1)
            L_a = eval_emission(
                gather_rows(self.area_coeffs, i),
                gather_rows(self.area_scale, i),
                gather_rows(self.area_illum, i),
                lam,
            )
            out = jnp.where((light_idx < na)[..., None], L_a, out)
        if nq > 0:
            qi = jnp.clip(light_idx - na, 0, nq - 1)
            L_q = eval_emission(
                gather_rows(self.sphl_coeffs, qi),
                gather_rows(self.sphl_scale, qi),
                gather_rows(self.sphl_illum, qi),
                lam,
            )
            out = jnp.where((light_idx >= na)[..., None], L_q, out)
        return out

    def emitted(self, light_idx, n_geo, wo, lam):
        """L_e toward wo for rays that hit emissive geometry light_idx
        (>=0): area triangles (ids < n_area) or analytic spheres.

        Reference: DiffuseAreaLight::L (lights.h).
        """
        na, nq = self.n_area, self.n_sphl
        if na + nq == 0:
            return jnp.zeros_like(lam)
        front = dot(n_geo, wo) > 0.0
        L = jnp.zeros(light_idx.shape + (lam.shape[-1],), lam.dtype)
        if na > 0:
            i = jnp.clip(light_idx, 0, na - 1)
            g = gather_rows(self._area_packed(), i)
            vis = front | (g[:, 14] > 0.5)
            L_a = eval_emission(g[:, 9:12], g[:, 12], g[:, 13] > 0.5, lam)
            use = (light_idx >= 0) & (light_idx < na) & vis
            L = jnp.where(use[..., None], L_a, L)
        if nq > 0:
            qi = jnp.clip(light_idx - na, 0, nq - 1)
            g = gather_rows(self._sphl_packed(), qi)
            vis = front | (g[:, 9] > 0.5)
            L_q = eval_emission(g[:, 4:7], g[:, 7], g[:, 8] > 0.5, lam)
            use = (light_idx >= na) & vis
            L = jnp.where(use[..., None], L_q, L)
        return L

    def escaped_radiance(self, d, lam, p_ref=None):
        """Radiance for rays escaping in direction d (infinite/env light).

        p_ref: escape-ray origins — required for the portal light, whose
        visible environment is windowed per origin (lights.cpp Portal Le)."""
        if self.has_env:
            from .portal import PortalLight

            if isinstance(self.env, PortalLight):
                return self.env.radiance(d, lam, p_ref)
            return self.env.radiance(d, lam)
        if not self.has_infinite:
            return jnp.zeros_like(lam)
        return eval_emission(
            self.infinite_coeffs[None, :],
            self.infinite_scale[None],
            self.infinite_illum[None],
            lam,
        )

    def pdf_escaped(self, d, p_ref=None):
        """Solid-angle pdf that NEE sampling produced direction d toward the
        infinite light, including its selection pmf (for MIS on escaped
        rays). Zero when there is no infinite light."""
        n_inf = (self.n_area + self.n_sphl + self.n_point + self.n_spot
                 + self.n_proj + self.n_gonio + self.n_distant)
        if self.bvh is not None:
            pmf = self._p_infinite / max(self.n_inf_list, 1)
        else:
            pmf = self.select_pmf[n_inf] if (
                self.has_env or self.has_infinite
            ) else 0.0
        if self.has_env:
            from .portal import PortalLight

            if isinstance(self.env, PortalLight):
                return self.env.pdf_dir(
                    d, p_ref if p_ref is not None else jnp.zeros_like(d)
                ) * pmf
            return self.env.pdf_dir(d) * pmf
        if self.has_infinite:
            return jnp.full(d.shape[:-1], 1.0 / (4.0 * jnp.pi)) * pmf
        return jnp.zeros(d.shape[:-1])

    # -- NEE sampling -------------------------------------------------------

    def sample_li(self, p_ref, lam, u_select, u_pos, n_ref=None) -> LightLiSample:
        """Select a light (cdf or BVH descent), sample a point/direction.

        p_ref: (N, 3) shading points; u_select: (N,); u_pos: (N, 2);
        n_ref: optional (N, 3) shading normals (drives the BVH importance;
        None for media scattering points). pdf is with respect to solid
        angle at p_ref and INCLUDES the selection pmf."""
        n = self.n_lights
        assert n > 0, "sample_li with no lights"
        N = p_ref.shape[0]
        S = lam.shape[-1]
        idx, sel_pmf = self.select(p_ref, n_ref, u_select)

        L = jnp.zeros((N, S), p_ref.dtype)
        wi = jnp.zeros((N, 3), p_ref.dtype)
        pdf = jnp.zeros((N,), p_ref.dtype)
        dist = jnp.full((N,), jnp.inf, p_ref.dtype)
        is_delta = jnp.zeros((N,), bool)

        na, nq, npt, nsp, nj, ng, nd = (
            self.n_area, self.n_sphl, self.n_point, self.n_spot,
            self.n_proj, self.n_gonio, self.n_distant,
        )

        if na > 0:
            ai = jnp.clip(idx, 0, na - 1)
            g = gather_rows(self._area_packed(), ai)  # (N, 16)
            verts = g[:, 0:9].reshape(-1, 3, 3)
            b = sample_uniform_triangle(u_pos)  # (N,3)
            p_l = jnp.einsum("nk,nkj->nj", b, verts, precision=jax.lax.Precision.HIGHEST)
            e1 = verts[:, 1] - verts[:, 0]
            e2 = verts[:, 2] - verts[:, 0]
            n_l = normalize(jnp.cross(e1, e2))
            to_l = p_l - p_ref
            d2 = jnp.maximum(jnp.sum(to_l * to_l, axis=-1), _EPS)
            d = jnp.sqrt(d2)
            wi_a = to_l / d[..., None]
            cos_l = dot(n_l, -wi_a)
            two = g[:, 14] > 0.5
            emit_ok = (cos_l > _EPS) | (two & (jnp.abs(cos_l) > _EPS))
            area = jnp.maximum(g[:, 15], _EPS)
            pdf_a = d2 / (jnp.abs(cos_l) * area + _EPS)
            L_a = eval_emission(g[:, 9:12], g[:, 12], g[:, 13] > 0.5, lam)
            L_a = jnp.where(emit_ok[..., None], L_a, 0.0)
            use = idx < na
            L = jnp.where(use[..., None], L_a, L)
            wi = jnp.where(use[..., None], wi_a, wi)
            pdf = jnp.where(use, pdf_a, pdf)
            dist = jnp.where(use, d, dist)

        if nq > 0:
            # Emissive analytic spheres: cone solid-angle sampling from
            # outside (Sphere::Sample(ctx,u), shapes.cpp — the uniform-cone
            # construction with the cosAlpha surface-point solve), uniform
            # area sampling from inside.
            qi = jnp.clip(idx - na, 0, nq - 1)
            g = gather_rows(self._sphl_packed(), qi)  # (N, 10)
            c_q = g[:, 0:3]
            r_q = g[:, 3]
            to_c = c_q - p_ref
            dc2 = jnp.sum(to_c * to_c, axis=-1)
            inside = dc2 <= r_q * r_q * (1.0 + 1e-6)
            dc = jnp.sqrt(jnp.maximum(dc2, _EPS))
            sin2max = jnp.clip(r_q * r_q / jnp.maximum(dc2, _EPS), 0.0, 1.0)
            cosmax = jnp.sqrt(jnp.maximum(1.0 - sin2max, 0.0))
            # Taylor-stable 1-cos(thetaMax) for tiny subtended angles
            # (sampling.h OneMinusCosThetaMax treatment).
            one_minus = jnp.where(
                sin2max < 6.85e-4, 0.5 * sin2max, 1.0 - cosmax
            )
            u0 = u_pos[..., 0]
            u1 = u_pos[..., 1]
            cos_t = 1.0 - u0 * one_minus
            sin2_t = jnp.maximum(1.0 - cos_t * cos_t, 0.0)
            sinmax = jnp.sqrt(jnp.maximum(sin2max, _EPS))
            cos_a = sin2_t / sinmax + cos_t * jnp.sqrt(
                jnp.maximum(1.0 - sin2_t / jnp.maximum(sin2max, _EPS), 0.0)
            )
            cos_a = jnp.clip(cos_a, -1.0, 1.0)
            sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
            phi_a = 2.0 * jnp.pi * u1
            from ..core.vecmath import coordinate_system as _coord

            zf = (p_ref - c_q) / dc[..., None]
            t1q, t2q = _coord(zf)
            n_out = (
                t1q * (sin_a * jnp.cos(phi_a))[..., None]
                + t2q * (sin_a * jnp.sin(phi_a))[..., None]
                + zf * cos_a[..., None]
            )
            from ..core.sampling import sample_uniform_sphere as _usph

            n_in = _usph(u_pos)
            n_l = jnp.where(inside[..., None], n_in, n_out)
            p_l = c_q + r_q[..., None] * n_l
            to_l = p_l - p_ref
            d2 = jnp.maximum(jnp.sum(to_l * to_l, axis=-1), _EPS)
            d = jnp.sqrt(d2)
            wi_q = to_l / d[..., None]
            cos_l = dot(n_l, -wi_q)
            area_q = 4.0 * jnp.pi * r_q * r_q
            pdf_in = d2 / (jnp.abs(cos_l) * area_q + _EPS)
            pdf_out = 1.0 / jnp.maximum(
                2.0 * jnp.pi * one_minus, _EPS
            )
            pdf_q = jnp.where(inside, pdf_in, pdf_out)
            two_q = g[:, 9] > 0.5
            emit_ok = (cos_l > _EPS) | (two_q & (jnp.abs(cos_l) > _EPS))
            L_q = eval_emission(g[:, 4:7], g[:, 7], g[:, 8] > 0.5, lam)
            L_q = jnp.where(emit_ok[..., None], L_q, 0.0)
            use = (idx >= na) & (idx < na + nq)
            L = jnp.where(use[..., None], L_q, L)
            wi = jnp.where(use[..., None], wi_q, wi)
            pdf = jnp.where(use, pdf_q, pdf)
            dist = jnp.where(use, d, dist)

        # Downstream branch windows shift past the sphere block.
        na = na + nq

        if npt > 0:
            pi = jnp.clip(idx - na, 0, npt - 1)
            p_l = gather_rows(self.point_p, pi)
            to_l = p_l - p_ref
            d2 = jnp.maximum(jnp.sum(to_l * to_l, axis=-1), _EPS)
            d = jnp.sqrt(d2)
            wi_p = to_l / d[..., None]
            # I / d^2 folded into L; pdf = 1 (delta light).
            I = eval_emission(
                gather_rows(self.point_coeffs, pi),
                gather_rows(self.point_scale, pi),
                gather_rows(self.point_illum, pi),
                lam,
            )
            L_p = I / d2[..., None]
            use = (idx >= na) & (idx < na + npt)
            L = jnp.where(use[..., None], L_p, L)
            wi = jnp.where(use[..., None], wi_p, wi)
            pdf = jnp.where(use, 1.0, pdf)
            dist = jnp.where(use, d, dist)
            is_delta = is_delta | use

        if nsp > 0:
            si = jnp.clip(idx - na - npt, 0, nsp - 1)
            p_l = gather_rows(self.spot_p, si)
            to_l = p_l - p_ref
            d2 = jnp.maximum(jnp.sum(to_l * to_l, axis=-1), _EPS)
            dd_ = jnp.sqrt(d2)
            wi_s = to_l / dd_[..., None]
            axis = gather_rows(self.spot_dir, si)
            cos_t = jnp.sum(-wi_s * axis, axis=-1)
            c0 = gather_rows(self.spot_cos_start, si)
            c1 = gather_rows(self.spot_cos_end, si)
            # Smoothstep falloff between totalWidth and falloffStart
            # (SpotLight::I, lights.h).
            t_ = jnp.clip((cos_t - c1) / jnp.maximum(c0 - c1, 1e-6), 0.0, 1.0)
            falloff = t_ * t_ * (3.0 - 2.0 * t_)
            I = eval_emission(
                gather_rows(self.spot_coeffs, si),
                gather_rows(self.spot_scale, si),
                gather_rows(self.spot_illum, si),
                lam,
            )
            L_s = I * (falloff / d2)[..., None]
            use = (idx >= na + npt) & (idx < na + npt + nsp)
            L = jnp.where(use[..., None], L_s, L)
            wi = jnp.where(use[..., None], wi_s, wi)
            pdf = jnp.where(use, 1.0, pdf)
            dist = jnp.where(use, dd_, dist)
            is_delta = is_delta | use

        if nj > 0:
            ji = jnp.clip(idx - na - npt - nsp, 0, nj - 1)
            p_l = gather_rows(self.proj_p, ji)
            to_l = p_l - p_ref
            d2 = jnp.maximum(jnp.sum(to_l * to_l, axis=-1), _EPS)
            dd_ = jnp.sqrt(d2)
            wi_j = to_l / dd_[..., None]
            rot = gather_rows(self.proj_rot.reshape(-1, 9), ji).reshape(
                -1, 3, 3
            )
            # Light-space direction from light toward the shading point.
            w_l = jnp.einsum("nij,nj->ni", rot, -wi_j, precision=jax.lax.Precision.HIGHEST)
            tanh = gather_rows(self.proj_tan, ji)
            z = jnp.maximum(w_l[:, 2], 1e-6)
            uu = 0.5 * (w_l[:, 0] / (z * tanh) + 1.0)
            vv = 0.5 * (w_l[:, 1] / (z * tanh) + 1.0)
            inside = (
                (w_l[:, 2] > 0.0)
                & (uu >= 0.0) & (uu < 1.0) & (vv >= 0.0) & (vv < 1.0)
            )
            I_j = _image_emission(
                self.proj_coeffs, self.proj_scale_tx, self.proj_illum,
                ji, uu, vv, lam,
            )
            L_j = jnp.where(
                inside[..., None], I_j / d2[..., None], 0.0
            )
            use = (idx >= na + npt + nsp) & (idx < na + npt + nsp + nj)
            L = jnp.where(use[..., None], L_j, L)
            wi = jnp.where(use[..., None], wi_j, wi)
            pdf = jnp.where(use, 1.0, pdf)
            dist = jnp.where(use, dd_, dist)
            is_delta = is_delta | use

        if ng > 0:
            gi = jnp.clip(idx - na - npt - nsp - nj, 0, ng - 1)
            p_l = gather_rows(self.gonio_p, gi)
            to_l = p_l - p_ref
            d2 = jnp.maximum(jnp.sum(to_l * to_l, axis=-1), _EPS)
            dd_ = jnp.sqrt(d2)
            wi_g = to_l / dd_[..., None]
            rot = gather_rows(self.gonio_rot.reshape(-1, 9), gi).reshape(
                -1, 3, 3
            )
            w_l = jnp.einsum("nij,nj->ni", rot, -wi_g, precision=jax.lax.Precision.HIGHEST)
            from ..core.vecmath import equal_area_sphere_to_square

            uv_g = equal_area_sphere_to_square(w_l)
            I_g = _image_emission(
                self.gonio_coeffs, self.gonio_scale_tx, self.gonio_illum,
                gi, uv_g[..., 0], uv_g[..., 1], lam,
            )
            L_g = I_g / d2[..., None]
            use = (idx >= na + npt + nsp + nj) & (
                idx < na + npt + nsp + nj + ng
            )
            L = jnp.where(use[..., None], L_g, L)
            wi = jnp.where(use[..., None], wi_g, wi)
            pdf = jnp.where(use, 1.0, pdf)
            dist = jnp.where(use, dd_, dist)
            is_delta = is_delta | use

        if nd > 0:
            di = jnp.clip(idx - na - npt - nsp - nj - ng, 0, nd - 1)
            wi_d = -gather_rows(self.distant_dir, di)
            L_d = eval_emission(
                gather_rows(self.distant_coeffs, di),
                gather_rows(self.distant_scale, di),
                gather_rows(self.distant_illum, di),
                lam,
            )
            use = (idx >= na + npt + nsp + nj + ng) & (
                idx < na + npt + nsp + nj + ng + nd
            )
            L = jnp.where(use[..., None], L_d, L)
            wi = jnp.where(use[..., None], wi_d, wi)
            pdf = jnp.where(use, 1.0, pdf)
            dist = jnp.where(use, jnp.inf, dist)
            is_delta = is_delta | use

        if self.has_env or self.has_infinite:
            use = idx == (na + npt + nsp + nj + ng + nd)
            if self.has_env:
                from .portal import PortalLight

                if isinstance(self.env, PortalLight):
                    wi_e, L_e, pdf_e = self.env.sample(u_pos, lam, p_ref)
                else:
                    wi_e, L_e, pdf_e = self.env.sample(u_pos, lam)
            else:
                from ..core.sampling import sample_uniform_sphere

                wi_e = sample_uniform_sphere(u_pos)
                L_e = eval_emission(
                    self.infinite_coeffs[None, :],
                    self.infinite_scale[None],
                    self.infinite_illum[None],
                    lam,
                )
                L_e = jnp.broadcast_to(L_e, (N, S))
                pdf_e = jnp.full((N,), 1.0 / (4.0 * jnp.pi))
            L = jnp.where(use[..., None], L_e, L)
            wi = jnp.where(use[..., None], wi_e, wi)
            pdf = jnp.where(use, pdf_e, pdf)
            dist = jnp.where(use, jnp.inf, dist)

        return LightLiSample(
            L=L, wi=wi, pdf=pdf * sel_pmf, dist=dist, is_delta=is_delta
        )

    def pdf_li_area(self, light_idx, dist, cos_l, p_ref=None, n_ref=None):
        """Solid-angle pdf that NEE would have produced the direction that hit
        area light `light_idx` (for MIS on BSDF-sampled rays).

        Includes the selection pmf — shading-point-dependent in BVH mode, so
        p_ref/n_ref must be the PREVIOUS path vertex (the point NEE would
        have sampled from). Reference: DiffuseAreaLight::PDF_Li +
        {Uniform,Power,BVH}LightSampler::PMF.
        """
        na, nq = self.n_area, self.n_sphl
        if na + nq == 0:
            return jnp.zeros_like(dist)
        ii = jnp.clip(light_idx, 0, max(na + nq - 1, 0))
        if self.bvh is not None and p_ref is not None:
            pmf = self.selection_pmf(light_idx, p_ref, n_ref)
        else:
            pmf = gather_rows(self.select_pmf[: max(na + nq, 1)], ii)
        pdf = jnp.zeros_like(dist)
        if na > 0:
            i = jnp.clip(light_idx, 0, na - 1)
            area = jnp.maximum(gather_rows(self.area_area, i), _EPS)
            pdf_a = dist * dist / (jnp.abs(cos_l) * area + _EPS)
            pdf = jnp.where(light_idx < na, pdf_a, pdf)
        if nq > 0:
            # Sphere::PDF(ctx, wi): uniform-cone pdf from outside the
            # sphere, area-measure conversion from inside (shapes.cpp).
            qi = jnp.clip(light_idx - na, 0, nq - 1)
            c_q = gather_rows(self.sphl_c, qi)
            r_q = gather_rows(self.sphl_r, qi)
            pv = p_ref if p_ref is not None else jnp.zeros_like(c_q)
            dc2 = jnp.sum((pv - c_q) ** 2, axis=-1)
            inside = dc2 <= r_q * r_q * (1.0 + 1e-6)
            sin2max = jnp.clip(
                r_q * r_q / jnp.maximum(dc2, _EPS), 0.0, 1.0
            )
            cosmax = jnp.sqrt(jnp.maximum(1.0 - sin2max, 0.0))
            one_minus = jnp.where(
                sin2max < 6.85e-4, 0.5 * sin2max, 1.0 - cosmax
            )
            pdf_cone = 1.0 / jnp.maximum(2.0 * jnp.pi * one_minus, _EPS)
            area_q = 4.0 * jnp.pi * r_q * r_q
            pdf_in = dist * dist / (jnp.abs(cos_l) * area_q + _EPS)
            pdf = jnp.where(
                light_idx >= na, jnp.where(inside, pdf_in, pdf_cone), pdf
            )
        return jnp.where(light_idx >= 0, pdf * pmf, 0.0)

    def sample_le_origin(self, u_sel, u_pos):
        """Sample an emission origin over ALL emissive geometry (area
        triangles + analytic spheres) with the selection pmf renormalized
        over those lights — the shared SampleLe front half for LightPath/
        BDPT/SPPM (DiffuseAreaLight::SampleLe position sampling,
        lights.cpp). Direction sampling (cosine about n) stays with the
        callers. Returns dict: p (N,3), n (N,3), area (N,), pmf (N,),
        coeffs (N,3), scale (N,), illum (N,) for eval_emission.
        """
        na, nq = self.n_area, self.n_sphl
        ne = na + nq
        assert ne > 0, "sample_le_origin with no emissive geometry"
        pmf_e = self.select_pmf[:ne]
        pmf_e = pmf_e / jnp.maximum(jnp.sum(pmf_e), 1e-12)
        cdf_e = jnp.cumsum(pmf_e)
        idx = jnp.minimum(
            jnp.sum(
                (cdf_e[None, :] <= u_sel[..., None]).astype(jnp.int32),
                axis=-1,
            ),
            ne - 1,
        )
        pmf = gather_rows(pmf_e, idx)
        N = u_sel.shape[0]
        p0 = jnp.zeros((N, 3), jnp.float32)
        n0 = jnp.zeros((N, 3), jnp.float32)
        area = jnp.ones((N,), jnp.float32)
        coeffs = jnp.zeros((N, 3), jnp.float32)
        scale = jnp.zeros((N,), jnp.float32)
        illum = jnp.zeros((N,), bool)
        if na > 0:
            ai = jnp.clip(idx, 0, na - 1)
            verts = gather_rows(
                self.area_verts.reshape(-1, 9), ai
            ).reshape(-1, 3, 3)
            b = sample_uniform_triangle(u_pos)
            p_a = jnp.einsum("nk,nkj->nj", b, verts, precision=jax.lax.Precision.HIGHEST)
            n_a = normalize(
                jnp.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
            )
            use = (idx < na)[..., None]
            p0 = jnp.where(use, p_a, p0)
            n0 = jnp.where(use, n_a, n0)
            area = jnp.where(
                use[..., 0], gather_rows(self.area_area, ai), area
            )
            coeffs = jnp.where(
                use, gather_rows(self.area_coeffs, ai), coeffs
            )
            scale = jnp.where(
                use[..., 0], gather_rows(self.area_scale, ai), scale
            )
            illum = jnp.where(
                use[..., 0], gather_rows(self.area_illum, ai), illum
            )
        if nq > 0:
            from ..core.sampling import sample_uniform_sphere as _usph

            qi = jnp.clip(idx - na, 0, nq - 1)
            c_q = gather_rows(self.sphl_c, qi)
            r_q = gather_rows(self.sphl_r, qi)
            n_q = _usph(u_pos)
            p_q = c_q + r_q[..., None] * n_q
            use = (idx >= na)[..., None]
            p0 = jnp.where(use, p_q, p0)
            n0 = jnp.where(use, n_q, n0)
            area = jnp.where(
                use[..., 0], 4.0 * jnp.pi * r_q * r_q, area
            )
            coeffs = jnp.where(
                use, gather_rows(self.sphl_coeffs, qi), coeffs
            )
            scale = jnp.where(
                use[..., 0], gather_rows(self.sphl_scale, qi), scale
            )
            illum = jnp.where(
                use[..., 0], gather_rows(self.sphl_illum, qi), illum
            )
        return {
            "p": p0, "n": n0, "area": area, "pmf": pmf,
            "coeffs": coeffs, "scale": scale, "illum": illum, "idx": idx,
        }

"""Path integrator: NEE + MIS + Russian roulette as a scan over bounces.

Reference analogue: PathIntegrator::Li
(/root/reference/src/pbrt/cpu/integrators.cpp:629-805). The recursive C++
bounce loop becomes a lax.scan whose carry is the wavefront RayWorkItem state
(workitems.soa:40-50): origin, direction, throughput beta, accumulated L,
previous-BSDF pdf for MIS, and liveness masks. All rays advance in lockstep;
terminated rays are masked, not compacted (sorted wavefront compaction is the
planned optimization for divergence-heavy scenes).

RNG dimension layout (per ray; stateless pcg4d streams, core.rng):
  dims 0-7            camera: pixel jitter (0,1), lens (2,3), wavelength (4)
  dims 8 + 8*depth +  0      light selection
                      1      light point (2D consumes one dim pair slot)
                      2      bsdf lobe selection
                      3      bsdf direction (2D)
                      4      russian roulette
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..accel import api as accel_api
from ..accel.dense import offset_ray_origin, shadow_segment
from ..core.pytree import pytree, static_field
from ..core.sampling import power_heuristic
from ..core.vecmath import coordinate_system, dot, from_local, shading_frame, to_local
from ..materials import bxdf
from ..scene import Scene
from ..shapes.geometry import Interaction

_CAM_DIMS = 8
_BOUNCE_DIMS = 8


def _zero_ct(x):
    """Zero cotangent matching JAX conventions (float0 for int/bool)."""

    def one(v):
        v = jnp.asarray(v)
        if jnp.issubdtype(v.dtype, jnp.inexact):
            return jnp.zeros_like(v)
        return np.zeros(v.shape, jax.dtypes.float0)

    return jax.tree_util.tree_map(one, x)


@pytree
class PathIntegrator:
    max_depth: int = static_field(default=5)
    rr_start_depth: int = static_field(default=2)
    use_nee: bool = static_field(default=True)
    use_mis: bool = static_field(default=True)
    # Tag-sorted shading dispatch (materials/sorted.py): the wavefront
    # per-material kernel-specialization tier (surfscatter.cpp:39-58).
    # Bit-identical results; pays an argsort + gather/scatter per bounce to
    # stop charging every lane for every material family present.
    # "auto" enables it exactly when the scene carries an expensive family
    # (coated/hair/measured/subsurface); scripts/measure_sorted_shading.py
    # measures the break-even on the card.
    sorted_shading: object = static_field(default="auto")
    sort_tile: int = static_field(default=8192)
    # Path-replay backprop (see trace_with_stats docstring): reverse-mode
    # differentiates a recorded shading-only replay instead of unrolling AD
    # through the traversal scan. Same detached-geometry gradients, ~one
    # traversal's cost for the whole backward pass.
    replay_grad: bool = static_field(default=True)
    # Rematerialize the replay scan body in its backward pass: keeps
    # backward memory O(carry). "full" | "dots" | "none".
    replay_remat: str = static_field(default="full")
    # "remat": single-pass variant of path replay — plain AD over the fused
    # trace with traversal outputs saved by name (save_only_these_names), so
    # scan-AD's backward rematerializes shading only and no separate replay
    # forward runs. "cvjp": two-pass record + replay custom VJP.
    grad_mode: str = static_field(default="remat")

    def trace(self, scene: Scene, o, d, wl, pixel, sample_idx, sampler):
        """Estimate radiance along N camera rays. Returns (N, S)."""
        return self.trace_with_stats(
            scene, o, d, wl, pixel, sample_idx, sampler
        )[0]

    def trace_with_stats(self, scene: Scene, o, d, wl, pixel, sample_idx, sampler):
        """Estimate radiance along N camera rays.

        o, d: (N, 3); wl: SampledWavelengths (N, S); pixel: (N,) int32 ids;
        sample_idx: scalar; sampler: a samplers.Sampler or an int seed.
        Returns ((N, S) radiance, stats dict with 'rays' = number of
        closest-hit + shadow queries actually alive — the quantity Mrays/s
        benchmarks count).

        Under reverse-mode AD the default path is **path-replay backprop**
        (replay_grad): the forward trace additionally records compact
        per-bounce hit records (t, n, uv, mat, light, prim, dpdu, shadow
        occlusion bit); the backward pass differentiates a shading-only
        replay of the transport from those records — traversal is never
        re-run or unrolled through AD, and the replay scan is rematerialized
        per bounce so residual memory is O(carry). Gradients equal the
        plain-AD detached-geometry gradients (geometry/discrete events are
        detached by design; gradients flow through BSDF values, emission,
        light radiance, and hit-point positions p = o + t·d with t fixed).
        No reference analogue: pbrt-v4 is not differentiable.
        """
        from ..samplers.samplers import as_sampler

        sampler = as_sampler(sampler)
        if scene.materials.any_subsurface or not self.replay_grad:
            L, stats, _ = self._run(scene, o, d, wl, pixel, sample_idx, sampler)
            return L, stats
        if self.grad_mode == "remat":
            L, stats, _ = self._run(
                scene, o, d, wl, pixel, sample_idx, sampler, remat_named=True
            )
            return L, stats
        return _trace_cvjp(self, scene, o, d, wl, pixel, sample_idx, sampler)

    def _run(self, scene: Scene, o, d, wl, pixel, sample_idx, sampler,
             replay_from=None, record=False, remat_named=False):
        """Core transport. Four modes:

        - primal (replay_from=None, record=False): trace with accel queries.
        - record (record=True): same, additionally returning per-bounce
          records for later replay.
        - replay (replay_from=(recs, rec_term)): recompute L from recorded
          intersections without any accel queries (differentiable shading
          replay; the backward path of path-replay backprop).
        - remat_named (remat_named=True): primal trace whose scan body is
          checkpointed with traversal outputs saved by name — reverse-mode
          AD then rematerializes shading only, with no separate replay pass.
        """
        n = o.shape[0]
        s = wl.lam.shape[-1]
        have_lights = scene.lights.n_lights > 0

        # Per-ray shutter time for animated instances: the SAME dim-5 draw
        # that drives camera motion blur (render.py camera_rays_full), so
        # camera and shape motion stay consistent along a path.
        ray_time = None
        if getattr(scene, "anim", None) is not None:
            u_t = sampler.get_1d(pixel, sample_idx, 5)
            ray_time = scene.anim.time0 + u_t * (
                scene.anim.time1 - scene.anim.time0
            )

        init = {
            "o": o,
            "d": d,
            "L": jnp.zeros((n, s), o.dtype),
            "beta": jnp.ones((n, s), o.dtype),
            "active": jnp.ones((n,), bool),
            "prev_pdf": jnp.ones((n,), o.dtype),
            "specular": jnp.ones((n,), bool),  # depth-0 emission counts fully
            # Previous path vertex (context for shading-point-dependent
            # light-selection pmf in MIS; BVHLightSampler::PMF needs it).
            "prev_p": o,
            "prev_ns": jnp.zeros((n, 3), o.dtype),
            "rays": jnp.zeros((), jnp.float32),
        }

        replaying = replay_from is not None
        # Detached-sampling estimator stance (both gradient paths): frames,
        # sampled directions and pdfs carry no gradients by design.
        detach = replaying or remat_named
        if remat_named:
            from jax.ad_checkpoint import checkpoint_name

            def _save(x):
                return jax.tree_util.tree_map(
                    lambda v: checkpoint_name(v, "trav"), x
                )
        else:
            def _save(x):
                return x

        def bounce(carry, xs):
            if replaying:
                depth, rec = xs
            else:
                depth = xs
                rec = None
            o, d = carry["o"], carry["d"]
            L, beta = carry["L"], carry["beta"]
            active = carry["active"]
            lam = wl.lam
            n_rays = carry["rays"] + jnp.sum(active.astype(jnp.float32))

            if replaying:
                isect = Interaction(
                    valid=rec["valid"], t=rec["t"],
                    p=jnp.where(
                        rec["valid"][:, None],
                        o + rec["t"][:, None] * d, 0.0,
                    ),
                    n=rec["n"], uv=rec["uv"], wo=-d, mat=rec["mat"],
                    light=rec["light"], prim=rec["prim"], dpdu=rec["dpdu"],
                )
            else:
                # Dead lanes get tmax=0: they sort into their own tiles and
                # fail every traversal gate instantly (accel/api
                # ray_sort_perm) instead of paying full traversal.
                isect = _save(accel_api.closest(
                    scene, o, d,
                    tmax=jnp.where(active, jnp.inf, 0.0),
                    time=ray_time,
                ))
            hit = active & isect.valid
            y = None
            if record:
                y = {
                    "valid": isect.valid, "t": isect.t, "n": isect.n,
                    "uv": isect.uv, "mat": isect.mat, "light": isect.light,
                    "prim": isect.prim, "dpdu": isect.dpdu,
                }

            # --- Emitted radiance at hits of area lights (with MIS weight
            # against the NEE strategy; integrators.cpp:664-726).
            if have_lights:
                cos_l = dot(isect.n, isect.wo)
                le = scene.lights.emitted(isect.light, isect.n, isect.wo, lam)
                if self.use_mis and self.use_nee:
                    # MIS pdfs are pure geometry: detached by design, so
                    # the replay reuses the recorded values instead of
                    # re-deriving them (light-BVH PMF + solid-angle math).
                    if replaying:
                        light_pdf = rec["light_pdf"]
                    else:
                        light_pdf = _save(scene.lights.pdf_li_area(
                            isect.light, isect.t, cos_l,
                            p_ref=carry["prev_p"], n_ref=carry["prev_ns"],
                        ))
                    if record:
                        y["light_pdf"] = light_pdf
                    w_l = power_heuristic(1, carry["prev_pdf"], 1, light_pdf)
                    w_l = jnp.where(carry["specular"], 1.0, w_l)
                elif self.use_nee:
                    w_l = jnp.where(carry["specular"], 1.0, 0.0)
                else:
                    w_l = jnp.ones_like(isect.t)
                emit_mask = hit & (isect.light >= 0)
                L = L + jnp.where(
                    emit_mask[..., None], beta * w_l[..., None] * le, 0.0
                )

                # --- Escaped rays: infinite-light radiance (MIS vs NEE).
                escaped = active & ~isect.valid
                if self.use_mis and self.use_nee:
                    if replaying:
                        esc_pdf = rec["esc_pdf"]
                    else:
                        esc_pdf = _save(scene.lights.pdf_escaped(d, o))
                    if record:
                        y["esc_pdf"] = esc_pdf
                    w_esc = jnp.where(
                        carry["specular"],
                        1.0,
                        power_heuristic(1, carry["prev_pdf"], 1, esc_pdf),
                    )
                elif self.use_nee:
                    w_esc = jnp.where(carry["specular"], 1.0, 0.0)
                else:
                    w_esc = jnp.ones_like(carry["prev_pdf"])
                L = L + jnp.where(
                    escaped[..., None],
                    beta * w_esc[..., None] * scene.lights.escaped_radiance(d, lam, o),
                    0.0,
                )

            active = hit

            # --- Shading frame (shading normal == geometric for now).
            ns = isect.n * jnp.sign(
                jnp.where(dot(isect.n, isect.wo, keepdims=True) == 0.0, 1.0,
                          dot(isect.n, isect.wo, keepdims=True))
            )
            t1, t2 = shading_frame(ns, isect.dpdu)
            wo_l = to_local(isect.wo, t1, t2, ns)
            if detach:
                # Detached-sampling estimator: frames and directions carry
                # no gradient by design; stop_gradient here prunes the
                # transpose graph of the backward scan (cotangents only
                # flow through BSDF values, emission, light radiance, and
                # the beta/L chains). Saving them by name additionally
                # removes their recompute from the rematerialized backward.
                ns, t1, t2, wo_l = (
                    _save(jax.lax.stop_gradient(v))
                    for v in (ns, t1, t2, wo_l)
                )
            params = bxdf.surface_params(scene, isect, lam)

            dim0 = _CAM_DIMS + depth * _BOUNCE_DIMS

            # --- Subsurface transport (SeparableBSSRDF::Sample_S,
            # bssrdf.h + wavefront/subsurface.cpp): entry Fresnel, Burley
            # diffusion to a probed exit vertex, then the Lambertian exit
            # lobe runs through the regular NEE/BSDF machinery below.
            if scene.materials.any_subsurface:
                from ..core import rgb2spec as _r2s
                from ..materials import scattering as _sc
                from ..materials.bssrdf import subsurface_exit
                from ..materials.buffers import MAT_SUBSURFACE

                is_ss = active & (params["kind"] == MAT_SUBSURFACE)
                alb_ss = _r2s.eval_sigmoid(params["albedo_coeffs"], lam)
                mfp = _r2s.eval_unbounded(
                    params["ss_mfp_coeffs"], params["ss_mfp_scale"], lam
                )
                u_r = sampler.get_1d(pixel, sample_idx, dim0 + 5)
                u_phi = sampler.get_1d(pixel, sample_idx, dim0 + 6)
                p_exit, n_exit, w_ss, _okp = subsurface_exit(
                    scene, isect, ns, t1, t2, alb_ss, mfp[..., 0],
                    u_r, u_phi,
                )
                fr_in = _sc.fr_dielectric(
                    jnp.abs(wo_l[..., 2]), params["eta"]
                )
                beta = jnp.where(
                    is_ss[..., None],
                    beta * w_ss * (1.0 - fr_in)[..., None],
                    beta,
                )
                n_rays = n_rays + jnp.sum(is_ss.astype(jnp.float32))
                new_n = jnp.where(is_ss[:, None], n_exit, isect.n)
                isect = isect.replace(
                    p=jnp.where(is_ss[:, None], p_exit, isect.p),
                    n=new_n,
                    wo=jnp.where(is_ss[:, None], new_n, isect.wo),
                    dpdu=jnp.where(
                        is_ss[:, None], jnp.zeros_like(isect.dpdu),
                        isect.dpdu,
                    ),
                )
                ns = isect.n * jnp.sign(
                    jnp.where(
                        dot(isect.n, isect.wo, keepdims=True) == 0.0, 1.0,
                        dot(isect.n, isect.wo, keepdims=True),
                    )
                )
                t1, t2 = shading_frame(ns, isect.dpdu)
                wo_l = to_local(isect.wo, t1, t2, ns)
                # Exit lobe: NormalizedFresnelBxDF (bxdfs.h:1206) — the
                # Sw term of the separable BSSRDF; bxdf.evaluate/sample
                # dispatch it for MAT_NORMFRESNEL lanes (eta rides in
                # params["eta"]).
                from ..materials.buffers import MAT_NORMFRESNEL

                params["kind"] = jnp.where(
                    is_ss, MAT_NORMFRESNEL, params["kind"]
                )

            # --- Sampler draws + light sample for NEE, then ONE shading
            # dispatch for {NEE f & pdf, BSDF sample}: lockstep masked
            # evaluate-all by default, or tag-sorted per-family tiles
            # (materials/sorted.py) when sorted_shading is set.
            do_nee = self.use_nee and have_lights
            if do_nee:
                u_sel = sampler.get_1d(pixel, sample_idx, dim0 + 0)
                up0, up1 = sampler.get_2d(pixel, sample_idx, dim0 + 1)
                u_pos = jnp.stack([up0, up1], axis=-1)
                with jax.named_scope("path/light_sample"):
                    ls = scene.lights.sample_li(
                        isect.p, lam, u_sel, u_pos, n_ref=ns
                    )
                if detach:
                    # Light-sample geometry/pdf detached (estimator stance);
                    # radiance ls.L stays differentiable.
                    ls = ls.replace(
                        wi=_save(jax.lax.stop_gradient(ls.wi)),
                        pdf=_save(jax.lax.stop_gradient(ls.pdf)),
                        dist=_save(jax.lax.stop_gradient(ls.dist)),
                    )
                wi_l = to_local(ls.wi, t1, t2, ns)
                if detach:
                    wi_l = _save(wi_l)
            uc = sampler.get_1d(pixel, sample_idx, dim0 + 2)
            ub0, ub1 = sampler.get_2d(pixel, sample_idx, dim0 + 3)
            u2 = jnp.stack([ub0, ub1], axis=-1)

            def _shade(pp, oo):
                out = {"bs": bxdf.sample(pp, oo["wo"], pp["lam"], oo["u2"], oo["uc"])}
                if do_nee:
                    out["f_nee"] = bxdf.evaluate(pp, oo["wo"], oo["wi"], pp["lam"])
                    if not replaying:
                        # BSDF pdf feeds only the (detached) MIS weight;
                        # the replay reuses the recorded value.
                        out["pdf_b"] = bxdf.pdf(pp, oo["wo"], oo["wi"])
                return out

            ops = {"wo": wo_l, "u2": u2, "uc": uc}
            if do_nee:
                ops["wi"] = wi_l
            sorted_on = self.sorted_shading
            if sorted_on == "auto":
                m = scene.materials
                sorted_on = bool(
                    m.any_coated or m.any_hair or m.any_measured
                    or m.any_subsurface
                )
            with jax.named_scope("path/shade"):
                if sorted_on:
                    from ..materials.sorted import shade_sorted

                    sh = shade_sorted(params, ops, _shade,
                                      tile=self.sort_tile)
                else:
                    sh = _shade(params, ops)
            bs = sh["bs"]
            if detach:
                # Sampled direction and pdf are detached (detached-sampling
                # estimator); bs["f"] keeps its parameter gradients.
                bs = dict(bs)
                bs["wi"] = _save(jax.lax.stop_gradient(bs["wi"]))
                bs["pdf"] = _save(jax.lax.stop_gradient(bs["pdf"]))
                bs["specular"] = _save(bs["specular"])

            # --- Next-event estimation (integrators.cpp SampleLd :727-805).
            if do_nee:
                f_nee = sh["f_nee"] * jnp.abs(wi_l[..., 2:3])
                pdf_b = rec["pdf_b"] if replaying else _save(sh["pdf_b"])
                if record:
                    y["pdf_b"] = pdf_b
                if self.use_mis:
                    w_nee = jnp.where(
                        ls.is_delta,
                        1.0,
                        power_heuristic(1, ls.pdf, 1, pdf_b),
                    )
                else:
                    w_nee = jnp.ones_like(ls.pdf)
                contrib = jnp.where(
                    (ls.pdf > 0.0)[..., None],
                    beta * f_nee * ls.L * (w_nee / jnp.maximum(ls.pdf, 1e-20))[..., None],
                    0.0,
                )
                need_shadow = active & (ls.pdf > 0.0) & jnp.any(
                    contrib != 0.0, axis=-1
                )
                if replaying:
                    occluded = rec["occ"]
                else:
                    so, wi_sh, smax = shadow_segment(
                        isect.p, isect.n, ls.wi, ls.dist
                    )
                    occluded = _save(accel_api.any_hit(
                        scene,
                        jnp.where(need_shadow[..., None], so, jnp.zeros_like(so) + 1e8),
                        wi_sh,
                        jnp.where(need_shadow, smax, 0.0),
                        time=ray_time,
                    ))
                if record:
                    y["occ"] = occluded
                L = L + jnp.where(
                    (need_shadow & ~occluded)[..., None], contrib, 0.0
                )
                n_rays = n_rays + jnp.sum(need_shadow.astype(jnp.float32))

            # --- BSDF sampling -> next ray (integrators.cpp:736-758;
            # bs was drawn in the shading dispatch above).
            wi_w = from_local(bs["wi"], t1, t2, ns)
            cos_wi = jnp.abs(bs["wi"][..., 2])
            ok = active & (bs["pdf"] > 0.0)
            beta = jnp.where(
                ok[..., None],
                beta * bs["f"] * (cos_wi / jnp.maximum(bs["pdf"], 1e-20))[..., None],
                beta,
            )
            o_new = offset_ray_origin(isect.p, isect.n, wi_w)
            carry_out = {
                "o": jnp.where(ok[..., None], o_new, o),
                "d": jnp.where(ok[..., None], wi_w, d),
                "L": L,
                "beta": beta,
                "active": ok,
                "prev_pdf": jnp.where(ok, bs["pdf"], carry["prev_pdf"]),
                "specular": jnp.where(ok, bs["specular"], carry["specular"]),
                "prev_p": jnp.where(ok[..., None], isect.p, carry["prev_p"]),
                "prev_ns": jnp.where(ok[..., None], ns, carry["prev_ns"]),
                "rays": n_rays,
            }

            # --- Russian roulette on spectral max throughput
            # (integrators.cpp:750-758).
            u_rr = sampler.get_1d(pixel, sample_idx, dim0 + 4)
            # stop_gradient: RR is a discrete decision; only the continuous
            # throughput factors carry gradients (SURVEY.md section 7 "hard
            # parts" item 4).
            beta_max = jax.lax.stop_gradient(jnp.max(carry_out["beta"], axis=-1))
            q = jnp.clip(1.0 - beta_max, 0.0, 0.95)
            do_rr = depth >= self.rr_start_depth
            kill = do_rr & (u_rr < q) & carry_out["active"]
            scale = jnp.where(do_rr & carry_out["active"], 1.0 / jnp.maximum(1.0 - q, 0.05), 1.0)
            carry_out["beta"] = jnp.where(
                kill[..., None], 0.0, carry_out["beta"] * scale[..., None]
            )
            carry_out["active"] = carry_out["active"] & ~kill

            return carry_out, y

        if replaying:
            recs, rec_term = replay_from
            # Rematerialize the shading replay per bounce: backward residual
            # memory stays O(carry) and the recompute is shading-only (no
            # traversal). replay_remat picks the saveable-set policy.
            if self.replay_remat == "full":
                body = jax.checkpoint(bounce)
            elif self.replay_remat == "dots":
                body = jax.checkpoint(
                    bounce, policy=jax.checkpoint_policies.dots_saveable
                )
            else:
                body = bounce
            xs = (jnp.arange(self.max_depth), recs)
        else:
            body = bounce
            if remat_named:
                body = jax.checkpoint(
                    bounce,
                    policy=jax.checkpoint_policies.save_only_these_names(
                        "trav"
                    ),
                )
            xs = jnp.arange(self.max_depth)
        final, ys = jax.lax.scan(body, init, xs, length=self.max_depth)

        # --- Terminal emission tier: the reference's depth loop breaks
        # AFTER adding Le at the (maxDepth+1)-th vertex (integrators.cpp:
        # "if (depth++ == maxDepth) break;" follows the emission add), so
        # BSDF-sampled light hits one segment past the last NEE still
        # contribute their MIS complement. One emission-only intersection
        # for rays that survived all bounces restores that tier.
        L = final["L"]
        active = final["active"]
        rec_term_out = None
        if have_lights:
            beta, d_f = final["beta"], final["d"]
            lam = wl.lam
            if replaying:
                isect = Interaction(
                    valid=rec_term["valid"], t=rec_term["t"],
                    p=jnp.zeros_like(final["o"]), n=rec_term["n"],
                    uv=jnp.zeros((n, 2), o.dtype), wo=-d_f,
                    mat=jnp.zeros((n,), jnp.int32), light=rec_term["light"],
                    prim=jnp.zeros((n,), jnp.int32),
                    dpdu=jnp.zeros_like(final["o"]),
                )
            else:
                isect = accel_api.closest(
                    scene, final["o"], d_f,
                    tmax=jnp.where(active, jnp.inf, 0.0),
                    time=ray_time,
                )
            if record:
                rec_term_out = {
                    "valid": isect.valid, "t": isect.t, "n": isect.n,
                    "light": isect.light,
                }
            hit = active & isect.valid
            le = scene.lights.emitted(isect.light, isect.n, isect.wo, lam)
            if self.use_mis and self.use_nee:
                if replaying:
                    light_pdf = rec_term["light_pdf"]
                    esc_pdf = rec_term["esc_pdf"]
                else:
                    cos_l = dot(isect.n, isect.wo)
                    light_pdf = scene.lights.pdf_li_area(
                        isect.light, isect.t, cos_l,
                        p_ref=final["prev_p"], n_ref=final["prev_ns"],
                    )
                    esc_pdf = scene.lights.pdf_escaped(d_f, final["o"])
                if record:
                    rec_term_out["light_pdf"] = light_pdf
                    rec_term_out["esc_pdf"] = esc_pdf
                w_l = jnp.where(
                    final["specular"], 1.0,
                    power_heuristic(1, final["prev_pdf"], 1, light_pdf),
                )
                w_esc = jnp.where(
                    final["specular"], 1.0,
                    power_heuristic(1, final["prev_pdf"], 1, esc_pdf),
                )
            elif self.use_nee:
                w_l = jnp.where(final["specular"], 1.0, 0.0)
                w_esc = w_l
            else:
                w_l = jnp.ones_like(isect.t)
                w_esc = w_l
            emit_mask = hit & (isect.light >= 0)
            L = L + jnp.where(
                emit_mask[..., None], beta * w_l[..., None] * le, 0.0
            )
            escaped = active & ~isect.valid
            L = L + jnp.where(
                escaped[..., None],
                beta * w_esc[..., None]
                * scene.lights.escaped_radiance(d_f, lam, final["o"]),
                0.0,
            )
            rays = final["rays"] + jnp.sum(active.astype(jnp.float32))
        else:
            rays = final["rays"]
        return L, {"rays": rays}, (ys, rec_term_out) if record else None


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _trace_cvjp(integ, scene, o, d, wl, pixel, sample_idx, sampler):
    L, stats, _ = integ._run(scene, o, d, wl, pixel, sample_idx, sampler)
    return L, stats


def _trace_cvjp_fwd(integ, scene, o, d, wl, pixel, sample_idx, sampler):
    L, stats, records = integ._run(
        scene, o, d, wl, pixel, sample_idx, sampler, record=True
    )
    return (L, stats), (scene, o, d, wl, pixel, sample_idx, sampler, records)


def _trace_cvjp_bwd(integ, res, g):
    scene, o, d, wl, pixel, sample_idx, sampler, records = res
    g_L = g[0]

    def replay(scene, o, d):
        L, _, _ = integ._run(
            scene, o, d, wl, pixel, sample_idx, sampler,
            replay_from=records,
        )
        return L

    _, vjp_fn = jax.vjp(replay, scene, o, d)
    g_scene, g_o, g_d = vjp_fn(g_L)
    return (g_scene, g_o, g_d, _zero_ct(wl), _zero_ct(pixel),
            _zero_ct(sample_idx), _zero_ct(sampler))


_trace_cvjp.defvjp(_trace_cvjp_fwd, _trace_cvjp_bwd)

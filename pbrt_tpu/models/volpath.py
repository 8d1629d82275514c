"""Volumetric path integrator: null-scattering delta tracking + NEE.

Reference analogue: VolPathIntegrator
(/root/reference/src/pbrt/cpu/integrators.cpp:953-1250) and the SampleT_maj
majorant walk (media.h:734-800). Design: the per-ray recursive majorant
walk becomes a masked lax.while_loop over the whole ray batch with a static
step cap; tentative collisions classify into {absorb, real-scatter, null} by
hero-wavelength probabilities, with per-wavelength reweighting keeping all
spectral lanes unbiased (the hero-pdf form of pbrt's rescaled path
probabilities r_u). The majorant is wavelength-independent
(max over the ray's sampled lambdas x max density), so free-flight sampling
needs no per-lambda pdf bookkeeping and segment-escape carries weight 1.

Shadow-ray transmittance uses ratio tracking with the same majorant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..accel import api as accel_api
from ..accel.dense import offset_ray_origin, shadow_segment
from ..core.pytree import pytree, static_field
from ..core.sampling import power_heuristic
from ..core.vecmath import coordinate_system, dot, from_local, shading_frame, to_local
from ..materials import bxdf
from ..media import phase as ph
from ..scene import Scene

_CAM_DIMS = 8
_BOUNCE_DIMS = 512  # wide stride: walk iterations consume many dims
_BIG = 1e30


@pytree
class VolPathIntegrator:
    max_depth: int = static_field(default=8)
    rr_start_depth: int = static_field(default=3)
    use_nee: bool = static_field(default=True)
    use_mis: bool = static_field(default=True)
    max_null_steps: int = static_field(default=64)
    max_tr_steps: int = static_field(default=64)
    # Track against per-cell DDA majorants for grid media (media.h:136-214)
    # instead of the single global majorant; False forces the global walk.
    use_dda: bool = static_field(default=True)
    # Reverse-mode AD cannot differentiate while_loop; the differentiable
    # variant runs the majorant walks as fixed-length scans (bodies are
    # already fully masked, so the semantics are identical).
    differentiable: bool = static_field(default=False)

    def _loop(self, cond, body, init, max_steps):
        if not self.differentiable:
            return jax.lax.while_loop(cond, body, init)

        def sbody(c, _):
            return body(c), None

        out, _ = jax.lax.scan(sbody, init, None, length=max_steps)
        return out

    def _walk(self, body, inputs, state, mask_of, max_steps):
        """Majorant-walk driver: staged wavefront compaction in the forward
        path (ops/compact.py — the live set decays ~8x faster than the
        step cap); a fixed-length masked scan when differentiating
        (while_loop and gather/scatter are not reverse-differentiable)."""
        if not self.differentiable:
            from ..ops.compact import staged_masked_loop

            return staged_masked_loop(body, inputs, state, mask_of, max_steps)

        def sbody(st, it):
            return body(inputs, it, st), None

        out, _ = jax.lax.scan(
            sbody, state, jnp.arange(max_steps), length=max_steps
        )
        return out

    # -- transmittance (ratio tracking; integrators.cpp SampleLd Tr loop) ----

    def _transmittance(self, scene, o, wi, dist, lam, pixel, sample_idx,
                       sampler, dim_base, check_occlusion=True):
        smax = jnp.where(jnp.isfinite(dist), dist * (1.0 - 1e-3), _BIG)
        if check_occlusion:
            occ = accel_api.any_hit(scene, o, wi, smax)
        else:
            # Occlusion (incl. interface crossings) handled by _shadow_tr;
            # only the scene-level medium factor is wanted here.
            occ = jnp.zeros(o.shape[:-1], bool)
        med = scene.medium
        tr = jnp.ones(lam.shape, lam.dtype)
        if med is None or med.is_none:
            return jnp.where(occ[..., None], 0.0, tr)

        t0, t1 = med.bounds_segment(o, wi, smax)
        sigma_maj = med.sigma_majorant(lam)  # (N,)
        if self.differentiable:
            # The majorant is a sampling control, not a physical quantity:
            # detaching it routes all parameter dependence through the
            # continuous weights instead of the (pathwise-invisible)
            # collision count. Inflate it so no wavelength lane sits AT the
            # majorant (a lane with sigma_t == sigma_maj gets null weight 0
            # and would lose its entire pathwise gradient).
            sigma_maj = jax.lax.stop_gradient(1.5 * sigma_maj)
        sa_u, ss_u = med.sigma_base(lam)  # (N, S) unit-density
        # DDA local majorants (DDAMajorantIterator, media.h:136-214): track
        # against the coarse-cell majorant; empty cells are crossed in ONE
        # step instead of ~sigma_maj_global * cell_len null collisions.
        use_dda = self.use_dda and med.kind in ("grid", "rgbgrid")
        if med.kind == "rgbgrid":
            # rgbgrid majorant cells are already in sigma units.
            lam_base = jnp.ones(lam.shape[:-1], jnp.float32)
        else:
            lam_base = jnp.max(sa_u + ss_u, axis=-1)  # (N,) unit-density maj
        if self.differentiable:
            lam_base = jax.lax.stop_gradient(1.5 * lam_base)
        # Density corner table: one row gather per step instead of 8
        # separate gathers (hoisted out of the walk loop).
        ctab = med.corner_table() if med.kind == "grid" else None

        def body(inp, it, st):
            t, tr, active = st["t"], st["tr"], st["active"]
            o_i, wi_i, t1_i = inp["o"], inp["wi"], inp["t1"]
            u = sampler.get_1d(inp["pixel"], inp["sidx"], dim_base + it)
            if use_dda:
                maj = med.majorant_local(
                    o_i + t[..., None] * wi_i, inp["lam_base"]
                )
                t_exit = jnp.minimum(med.cell_exit_t(o_i, wi_i, t), t1_i)
                t_new = t - jnp.log(
                    jnp.maximum(1.0 - u, 1e-20)
                ) / jnp.maximum(maj, 1e-20)
                crossed = (t_new >= t_exit) | (maj <= 0.0)
                t_new = jnp.where(crossed, t_exit, t_new)
                maj_here = maj
            else:
                t_new = t - jnp.log(
                    jnp.maximum(1.0 - u, 1e-20)
                ) / jnp.maximum(inp["sigma_maj"], 1e-20)
                crossed = jnp.zeros_like(t_new, bool)
                maj_here = inp["sigma_maj"]
            escaped = t_new >= t1_i
            p = o_i + t_new[..., None] * wi_i
            if ctab is not None:
                dens = med.density_at_fast(p, ctab)
                sa_p = inp["sa_u"] * dens[..., None]
                ss_p = inp["ss_u"] * dens[..., None]
            else:
                sa_p, ss_p = med.sigma_at(p, inp["lam"])
            sigma_n = jnp.maximum(maj_here[..., None] - sa_p - ss_p, 0.0)
            ratio = sigma_n / jnp.maximum(maj_here[..., None], 1e-20)
            step = active & ~escaped & ~crossed
            tr = jnp.where(step[..., None], tr * ratio, tr)
            active = active & ~escaped
            return {
                "t": jnp.where(active, t_new, t), "tr": tr, "active": active
            }

        active0 = (t1 > t0) & ~occ
        if not use_dda:
            active0 = active0 & (sigma_maj > 0.0)
        inputs = {
            "o": o, "wi": wi, "t1": t1, "pixel": pixel, "lam": lam,
            "lam_base": lam_base, "sigma_maj": sigma_maj,
            "sidx": jnp.broadcast_to(
                jnp.asarray(sample_idx), jnp.shape(pixel)
            ),
        }
        if ctab is not None:
            inputs["sa_u"], inputs["ss_u"] = sa_u, ss_u
        state = {"t": t0, "tr": tr, "active": active0}
        state = self._walk(body, inputs, state, lambda st: st["active"],
                           self.max_tr_steps)
        tr = state["tr"]
        return jnp.where(occ[..., None], 0.0, tr)

    # -- main loop -----------------------------------------------------------

    def _shadow_tr(self, scene, o, wi, dist, med0, lam):
        """Shadow transmittance through material-less interface boundaries.

        Reference analogue: the Tr loop of VolPathIntegrator::SampleLd
        (cpu/integrators.cpp, "si->intr.material blocks, otherwise
        SkipIntersection and keep going") and the wavefront shadow_Tr
        pipeline (gpu/optix.cu:268). A shadow ray crosses MAT_INTERFACE
        surfaces, switching its interior medium per the crossed side and
        attenuating each segment closed-form (stack media are homogeneous);
        any real material blocks. Bounded at 4 crossings — rays still
        mid-walk after that are conservatively treated as blocked.
        Returns (N, S) transmittance, zero where blocked.
        """
        from ..core.gather import gather_rows
        from ..materials.buffers import MAT_INTERFACE
        from ..media.medium import MED_KEEP

        stack = scene.media_stack
        n = o.shape[0]
        dist_f = jnp.where(jnp.isfinite(dist), dist * (1.0 - 1e-3), _BIG)

        def body(carry, _):
            o_c, remaining, med, tr, blocked, done = carry
            active = ~done
            isect = accel_api.closest(
                scene, o_c, wi, jnp.where(active, remaining, 0.0)
            )
            hit = active & isect.valid
            seg = jnp.where(hit, isect.t, remaining)
            sa, ss = stack.sigma_at_idx(med, lam)
            att = jnp.exp(
                -(sa + ss) * jnp.where(active, seg, 0.0)[..., None]
            )
            tr = tr * jnp.where(active[..., None], att, 1.0)
            kind = gather_rows(scene.materials.kind, isect.mat)
            is_iface = kind == MAT_INTERFACE
            blocked = blocked | (hit & ~is_iface)
            gi = gather_rows(scene.materials.med_inside, isect.mat)
            go = gather_rows(scene.materials.med_outside, isect.mat)
            entering = jnp.sum(wi * isect.n, axis=-1) < 0.0
            tgt = jnp.where(entering, gi, go)
            crossed = hit & is_iface & ~blocked
            med = jnp.where(crossed & (tgt != MED_KEEP), tgt, med)
            o_c = jnp.where(
                hit[..., None], offset_ray_origin(isect.p, isect.n, wi), o_c
            )
            remaining = jnp.where(hit, jnp.maximum(remaining - seg, 0.0), 0.0)
            done = done | blocked | ~hit
            return (o_c, remaining, med, tr, blocked, done), None

        init = (
            o, dist_f, med0, jnp.ones(lam.shape, lam.dtype),
            jnp.zeros((n,), bool), jnp.zeros((n,), bool),
        )
        (_, _, _, tr, blocked, done), _ = jax.lax.scan(
            body, init, None, length=4
        )
        return jnp.where((blocked | ~done)[..., None], 0.0, tr)

    def trace(self, scene: Scene, o, d, wl, pixel, sample_idx, sampler):
        return self.trace_with_stats(
            scene, o, d, wl, pixel, sample_idx, sampler
        )[0]

    def trace_with_stats(self, scene: Scene, o, d, wl, pixel, sample_idx,
                         sampler):
        from ..samplers.samplers import as_sampler

        sampler = as_sampler(sampler)
        n = o.shape[0]
        s = wl.lam.shape[-1]
        lam = wl.lam
        med = scene.medium
        stack = getattr(scene, "media_stack", None)
        have_medium = med is not None and not med.is_none
        have_stack = stack is not None
        have_any_medium = have_medium or have_stack
        have_lights = scene.lights.n_lights > 0

        init = {
            "o": o,
            "d": d,
            "L": jnp.zeros((n, s), o.dtype),
            "beta": jnp.ones((n, s), o.dtype),
            "active": jnp.ones((n,), bool),
            "prev_pdf": jnp.ones((n,), o.dtype),
            "specular": jnp.ones((n,), bool),
            "prev_p": o,
            "prev_ns": jnp.zeros((n, 3), o.dtype),
            # Per-ray interior-medium index (MediumStack; -1 = vacuum).
            # Rays switch on transmission through interfaced surfaces —
            # the ray.medium threading of VolPathIntegrator.
            "med": jnp.full((n,), -1, jnp.int32),
            "rays": jnp.zeros((), jnp.float32),
        }

        def bounce(carry, depth):
            o, d = carry["o"], carry["d"]
            L, beta = carry["L"], carry["beta"]
            active = carry["active"]
            dim0 = _CAM_DIMS + depth * _BOUNCE_DIMS
            n_rays = carry["rays"] + jnp.sum(active.astype(jnp.float32))

            isect = accel_api.closest(
                scene, o, d, tmax=jnp.where(active, jnp.inf, 0.0)
            )
            t_surf = jnp.where(isect.valid, isect.t, _BIG)

            # ---- Medium interaction sampling (delta tracking). status:
            # 0 = passed through (reach surface/escape), 1 = real scatter,
            # 2 = absorbed.
            if have_medium:
                t0, t1 = med.bounds_segment(o, d, t_surf)
                sigma_maj = med.sigma_majorant(lam)
                if self.differentiable:
                    # Inflated + detached: see _transmittance.
                    sigma_maj = jax.lax.stop_gradient(1.5 * sigma_maj)
                sa_u, ss_u = med.sigma_base(lam)
                use_dda = self.use_dda and med.kind in ("grid", "rgbgrid")
                if med.kind == "rgbgrid":
                    lam_base = jnp.ones(lam.shape[:-1], jnp.float32)
                else:
                    lam_base = jnp.max(sa_u + ss_u, axis=-1)
                if self.differentiable:
                    lam_base = jax.lax.stop_gradient(1.5 * lam_base)
                ctab = med.corner_table() if med.kind == "grid" else None

                def wbody(inp, it, st):
                    t, beta_w = st["t"], st["beta"]
                    status, walking = st["status"], st["walking"]
                    o_i, d_i, t1_i = inp["o"], inp["d"], inp["t1"]
                    u_d = sampler.get_1d(
                        inp["pixel"], inp["sidx"], dim0 + 32 + 2 * it
                    )
                    u_e = sampler.get_1d(
                        inp["pixel"], inp["sidx"], dim0 + 33 + 2 * it
                    )
                    if use_dda:
                        maj_here = med.majorant_local(
                            o_i + t[..., None] * d_i, inp["lam_base"]
                        )
                        t_exit = jnp.minimum(
                            med.cell_exit_t(o_i, d_i, t), t1_i
                        )
                        t_new = t - jnp.log(
                            jnp.maximum(1.0 - u_d, 1e-20)
                        ) / jnp.maximum(maj_here, 1e-20)
                        crossed = (t_new >= t_exit) | (maj_here <= 0.0)
                        t_new = jnp.where(crossed, t_exit, t_new)
                    else:
                        maj_here = inp["sigma_maj"]
                        t_new = t - jnp.log(
                            jnp.maximum(1.0 - u_d, 1e-20)
                        ) / jnp.maximum(maj_here, 1e-20)
                        crossed = jnp.zeros_like(t_new, bool)
                    escaped = t_new >= t1_i
                    p = o_i + t_new[..., None] * d_i
                    if ctab is not None:
                        dens = med.density_at_fast(p, ctab)
                        sa = inp["sa_u"] * dens[..., None]
                        ss = inp["ss_u"] * dens[..., None]
                    else:
                        sa, ss = med.sigma_at(p, inp["lam"])
                    pa = sa[..., 0] / jnp.maximum(maj_here, 1e-20)
                    ps = ss[..., 0] / jnp.maximum(maj_here, 1e-20)
                    if self.differentiable:
                        # Absorption folded continuously into the null weight
                        # (ratio-tracking style): binary absorb events have a
                        # zero pathwise derivative in sigma_a, this form is
                        # smooth (the "differentiable ray-march" of
                        # BASELINE.json). Discrete choice probabilities are
                        # detached so only the weights carry gradients.
                        pa = jnp.zeros_like(pa)
                        ps = jax.lax.stop_gradient(ps)
                    absorb = u_e < pa
                    scatter = (u_e >= pa) & (u_e < pa + ps)
                    null = ~absorb & ~scatter
                    # Double-where: denominators are only "real" in taken
                    # lanes; masked lanes get 1.0 so reverse-mode AD never
                    # sees the 1e-20 division (0 * inf = NaN cotangents).
                    pn = jnp.maximum(1.0 - pa - ps, 1e-20)
                    sigma_n = jnp.maximum(
                        maj_here[..., None] - sa - ss, 0.0
                    )
                    pn_s = jnp.where(null, pn, 1.0)
                    ps_s = jnp.where(scatter, jnp.maximum(ps, 1e-20), 1.0)
                    pa_s = jnp.where(absorb, jnp.maximum(pa, 1e-20), 1.0)
                    w_null = sigma_n / (
                        maj_here[..., None] * pn_s[..., None]
                    )
                    w_scat = ss / (maj_here[..., None] * ps_s[..., None])
                    w_abs = sa / (maj_here[..., None] * pa_s[..., None])
                    step = walking & ~escaped & ~crossed
                    beta_w = jnp.where(
                        (step & null)[..., None], beta_w * w_null, beta_w
                    )
                    beta_w = jnp.where(
                        (step & scatter)[..., None], beta_w * w_scat, beta_w
                    )
                    beta_w = jnp.where(
                        (step & absorb)[..., None], beta_w * w_abs, beta_w
                    )
                    status = jnp.where(step & scatter, 1, status)
                    status = jnp.where(step & absorb, 2, status)
                    walking = walking & ~escaped & (null | crossed)
                    t = jnp.where(walking | step, t_new, t)
                    return {
                        "t": t, "beta": beta_w, "status": status,
                        "walking": walking,
                    }

                walking0 = active & (t1 > t0)
                if have_stack:
                    # Rays inside a named interior medium take the
                    # closed-form step below, not the global AABB walk.
                    walking0 = walking0 & (carry["med"] < 0)
                if not use_dda:
                    walking0 = walking0 & (sigma_maj > 0.0)
                winputs = {
                    "o": o, "d": d, "t1": t1, "pixel": pixel, "lam": lam,
                    "lam_base": lam_base, "sigma_maj": sigma_maj,
                    "sidx": jnp.broadcast_to(
                        jnp.asarray(sample_idx), jnp.shape(pixel)
                    ),
                }
                if ctab is not None:
                    winputs["sa_u"], winputs["ss_u"] = sa_u, ss_u
                wstate = {
                    "t": t0, "beta": beta,
                    "status": jnp.zeros((n,), jnp.int32),
                    "walking": walking0,
                }
                wstate = self._walk(
                    wbody, winputs, wstate, lambda st: st["walking"],
                    self.max_null_steps,
                )
                t_event, beta = wstate["t"], wstate["beta"]
                status = wstate["status"]
                scattered = active & (status == 1)
                absorbed = active & (status == 2)
                p_med = o + t_event[..., None] * d
                # Volumetric emission on absorption (GridMedium Le).
                if med.emissive:
                    L = L + jnp.where(
                        absorbed[..., None], beta * med.le_at(p_med, lam), 0.0
                    )
            else:
                scattered = jnp.zeros((n,), bool)
                absorbed = jnp.zeros((n,), bool)
                p_med = o

            # ---- Interior-media interaction (MediumStack): homogeneous
            # shape-bounded media admit exact closed-form free-flight
            # sampling on the hero wavelength — no majorant walk. The
            # segment always ends at the next surface (the boundary shape).
            med_idx = carry["med"]
            if have_stack:
                in_named = active & (med_idx >= 0)
                sa_nm, ss_nm = stack.sigma_at_idx(med_idx, lam)  # (N, S)
                st_nm = sa_nm + ss_nm
                st_hero = st_nm[..., 0]
                u_t = sampler.get_1d(pixel, sample_idx, dim0 + 30)
                u_e = sampler.get_1d(pixel, sample_idx, dim0 + 31)
                dist_seg = jnp.where(isect.valid, isect.t, _BIG)
                t_s = -jnp.log(jnp.maximum(1.0 - u_t, 1e-20)) / jnp.maximum(
                    st_hero, 1e-20
                )
                interact_n = in_named & (st_hero > 0.0) & (t_s < dist_seg)
                # Event split by the hero single-scattering albedo.
                p_sc = ss_nm[..., 0] / jnp.maximum(st_hero, 1e-20)
                scatter_n = interact_n & (u_e < p_sc)
                absorb_n = interact_n & ~scatter_n
                # Spectral lane reweighting against the hero pdf:
                #   interact: pdf = sigma_t_h exp(-sigma_t_h t)
                #   pass:     P   = exp(-sigma_t_h dist)
                t_used = jnp.minimum(t_s, dist_seg)
                atten = jnp.exp(
                    -(st_nm - st_hero[..., None]) * t_used[..., None]
                )  # exp(-sigma_l t)/exp(-sigma_h t); hero lane == 1
                w_scat_n = atten * ss_nm / jnp.maximum(ss_nm[..., 0:1], 1e-20)
                beta = jnp.where(scatter_n[..., None], beta * w_scat_n, beta)
                passed_n = in_named & ~interact_n
                beta = jnp.where(passed_n[..., None], beta * atten, beta)
                scattered = scattered | scatter_n
                absorbed = absorbed | absorb_n
                p_med = jnp.where(
                    scatter_n[..., None], o + t_s[..., None] * d, p_med
                )
            else:
                in_named = jnp.zeros((n,), bool)

            reach_surface = active & ~scattered & ~absorbed

            # ---- Surface-path emission / escape (as PathIntegrator).
            hit = reach_surface & isect.valid
            if have_lights:
                cos_l = dot(isect.n, isect.wo)
                le = scene.lights.emitted(isect.light, isect.n, isect.wo, lam)
                if self.use_mis and self.use_nee:
                    light_pdf = scene.lights.pdf_li_area(
                        isect.light, isect.t, cos_l,
                        p_ref=carry["prev_p"], n_ref=carry["prev_ns"],
                    )
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
                escaped_rays = reach_surface & ~isect.valid
                if self.use_mis and self.use_nee:
                    w_esc = jnp.where(
                        carry["specular"],
                        1.0,
                        power_heuristic(
                            1, carry["prev_pdf"], 1, scene.lights.pdf_escaped(d, o)
                        ),
                    )
                elif self.use_nee:
                    w_esc = jnp.where(carry["specular"], 1.0, 0.0)
                else:
                    w_esc = jnp.ones_like(carry["prev_pdf"])
                L = L + jnp.where(
                    escaped_rays[..., None],
                    beta * w_esc[..., None] * scene.lights.escaped_radiance(d, lam, o),
                    0.0,
                )

            # Per-ray phase asymmetry: interior media override the global
            # medium's g where the ray is inside one.
            if have_any_medium:
                g_eff = (med.g if have_medium
                         else jnp.zeros((), jnp.float32))
                g_eff = jnp.broadcast_to(g_eff, (n,))
                if have_stack:
                    g_eff = jnp.where(in_named, stack.g_at(med_idx), g_eff)

            # ---- NEE from medium scatter points.
            if self.use_nee and have_lights and have_any_medium:
                u_sel = sampler.get_1d(pixel, sample_idx, dim0 + 0)
                up = sampler.get_2d(pixel, sample_idx, dim0 + 1)
                ls = scene.lights.sample_li(
                    p_med, lam, u_sel, jnp.stack(up, axis=-1)
                )
                wo_med = -d
                p_phase = ph.hg_pdf(wo_med, ls.wi, g_eff)
                if have_stack:
                    # Interface-aware shadow walk: crossings switch media
                    # and attenuate per segment (pbrt's shadow_Tr).
                    tr = self._shadow_tr(
                        scene, p_med, ls.wi, ls.dist, med_idx, lam
                    )
                    if have_medium:
                        tr = tr * self._transmittance(
                            scene, p_med, ls.wi, ls.dist, lam, pixel,
                            sample_idx, sampler, dim0 + 200,
                            check_occlusion=False,
                        )
                else:
                    tr = self._transmittance(
                        scene, p_med, ls.wi, ls.dist, lam, pixel, sample_idx,
                        sampler, dim0 + 200,
                    )
                w_nee = jnp.where(
                    ls.is_delta,
                    1.0,
                    power_heuristic(1, ls.pdf, 1, p_phase)
                    if self.use_mis
                    else 1.0,
                )
                contrib = (
                    beta
                    * p_phase[..., None]
                    * tr
                    * ls.L
                    * (w_nee / jnp.maximum(ls.pdf, 1e-20))[..., None]
                )
                ok = scattered & (ls.pdf > 0.0)
                L = L + jnp.where(ok[..., None], contrib, 0.0)
                n_rays = n_rays + jnp.sum(ok.astype(jnp.float32))

            # ---- Phase-function sampling for scattered rays.
            if have_any_medium:
                u_ph = sampler.get_2d(pixel, sample_idx, dim0 + 5)
                wi_med, pdf_ph = ph.hg_sample(-d, jnp.stack(u_ph, -1), g_eff)
                # f/pdf == 1 for a sampled phase function.
            else:
                wi_med = d
                pdf_ph = jnp.ones(n, o.dtype)

            # ---- Surface shading (diffuse/conductor/dielectric path logic).
            ns = isect.n * jnp.sign(
                jnp.where(
                    dot(isect.n, isect.wo, keepdims=True) == 0.0,
                    1.0,
                    dot(isect.n, isect.wo, keepdims=True),
                )
            )
            t1f, t2f = shading_frame(ns, isect.dpdu)
            wo_l = to_local(isect.wo, t1f, t2f, ns)
            params = bxdf.surface_params(scene, isect, lam)
            if have_stack:
                from ..core.gather import gather_rows
                from ..media.medium import MED_KEEP

                gi_mat = gather_rows(scene.materials.med_inside, isect.mat)
                go_mat = gather_rows(scene.materials.med_outside, isect.mat)

            if self.use_nee and have_lights:
                u_sel = sampler.get_1d(pixel, sample_idx, dim0 + 6)
                up = sampler.get_2d(pixel, sample_idx, dim0 + 7)
                ls = scene.lights.sample_li(
                    isect.p, lam, u_sel, jnp.stack(up, axis=-1), n_ref=ns
                )
                wi_l = to_local(ls.wi, t1f, t2f, ns)
                f_nee = bxdf.evaluate(params, wo_l, wi_l, lam) * jnp.abs(
                    wi_l[..., 2:3]
                )
                pdf_b = bxdf.pdf(params, wo_l, wi_l)
                w_nee = jnp.where(
                    ls.is_delta,
                    1.0,
                    power_heuristic(1, ls.pdf, 1, pdf_b)
                    if self.use_mis
                    else 1.0,
                )
                so, wi_sh, smax_sh = shadow_segment(
                    isect.p, isect.n, ls.wi, ls.dist
                )
                if not have_stack:
                    tr = self._transmittance(
                        scene, so, wi_sh, smax_sh, lam, pixel, sample_idx,
                        sampler, dim0 + 300,
                    )
                if have_stack:
                    # The shadow ray starts in the medium on its own side
                    # of the surface (pbrt's si.SkipIntersection medium
                    # selection): inside-medium toward the interior,
                    # outside otherwise; MED_KEEP inherits the ray medium.
                    # _shadow_tr then crosses any interface boundaries,
                    # switching media per segment.
                    side = jnp.where(
                        dot(ls.wi, isect.n) < 0.0, gi_mat, go_mat
                    )
                    side = jnp.where(side == MED_KEEP, med_idx, side)
                    tr = self._shadow_tr(scene, so, wi_sh, smax_sh, side, lam)
                    if have_medium:
                        tr = tr * self._transmittance(
                            scene, so, wi_sh, smax_sh, lam, pixel,
                            sample_idx, sampler, dim0 + 300,
                            check_occlusion=False,
                        )
                contrib = (
                    beta
                    * f_nee
                    * tr
                    * ls.L
                    * (w_nee / jnp.maximum(ls.pdf, 1e-20))[..., None]
                )
                ok = hit & (ls.pdf > 0.0)
                L = L + jnp.where(ok[..., None], contrib, 0.0)
                n_rays = n_rays + jnp.sum(ok.astype(jnp.float32))

            uc = sampler.get_1d(pixel, sample_idx, dim0 + 2)
            ub = sampler.get_2d(pixel, sample_idx, dim0 + 3)
            bs = bxdf.sample(params, wo_l, lam, jnp.stack(ub, axis=-1), uc)
            wi_w = from_local(bs["wi"], t1f, t2f, ns)
            cos_wi = jnp.abs(bs["wi"][..., 2])
            surf_ok = hit & (bs["pdf"] > 0.0)
            beta = jnp.where(
                surf_ok[..., None],
                beta
                * bs["f"]
                * (cos_wi / jnp.maximum(bs["pdf"], 1e-20))[..., None],
                beta,
            )

            # ---- Select next ray per status.
            o_surf = offset_ray_origin(isect.p, isect.n, wi_w)
            o_new = jnp.where(scattered[..., None], p_med, o_surf)
            d_new = jnp.where(scattered[..., None], wi_med, wi_w)
            next_active = (surf_ok | scattered) & ~absorbed
            prev_pdf = jnp.where(
                scattered,
                pdf_ph,
                jnp.where(surf_ok, bs["pdf"], carry["prev_pdf"]),
            )
            specular = jnp.where(
                scattered,
                False,
                jnp.where(surf_ok, bs["specular"], carry["specular"]),
            )

            # ---- Medium switch on transmission (ray.medium threading):
            # crossing to the far side of an interfaced surface adopts that
            # side's medium; the shape's outward orientation (winding /
            # outward quadric normal) defines inside vs outside, as in the
            # reference's MediumInterface convention.
            if have_stack:
                transmitted = surf_ok & (bs["wi"][..., 2] < 0.0)
                entering = dot(wi_w, isect.n) < 0.0
                tgt_med = jnp.where(entering, gi_mat, go_mat)
                med_next = jnp.where(
                    transmitted & (tgt_med != MED_KEEP), tgt_med, med_idx
                )
            else:
                med_next = med_idx

            carry_out = {
                "o": jnp.where(next_active[..., None], o_new, o),
                "d": jnp.where(next_active[..., None], d_new, d),
                "L": L,
                "beta": beta,
                "active": next_active,
                "prev_pdf": prev_pdf,
                "specular": specular,
                "prev_p": jnp.where(
                    next_active[..., None],
                    jnp.where(scattered[..., None], p_med, isect.p),
                    carry["prev_p"],
                ),
                "prev_ns": jnp.where(
                    (next_active & ~scattered)[..., None], ns,
                    jnp.where(next_active[..., None], 0.0, carry["prev_ns"]),
                ),
                "med": med_next,
                "rays": n_rays,
            }

            # ---- Russian roulette.
            u_rr = sampler.get_1d(pixel, sample_idx, dim0 + 4)
            beta_max = jax.lax.stop_gradient(
                jnp.max(carry_out["beta"], axis=-1)
            )
            q = jnp.clip(1.0 - beta_max, 0.0, 0.95)
            do_rr = depth >= self.rr_start_depth
            kill = do_rr & (u_rr < q) & carry_out["active"]
            scale = jnp.where(
                do_rr & carry_out["active"],
                1.0 / jnp.maximum(1.0 - q, 0.05),
                1.0,
            )
            carry_out["beta"] = jnp.where(
                kill[..., None], 0.0, carry_out["beta"] * scale[..., None]
            )
            carry_out["active"] = carry_out["active"] & ~kill
            return carry_out, None

        final, _ = jax.lax.scan(
            bounce, init, jnp.arange(self.max_depth), length=self.max_depth
        )

        # --- Terminal emission tier (matches PathIntegrator and the
        # reference's "Le then break" depth semantics): rays alive after
        # the last bounce still contribute the MIS-weighted emission of
        # whatever they hit (or escape to), attenuated by ratio-tracked
        # medium transmittance along the final segment in place of the
        # in-loop null-collision walk (equal in expectation).
        L = final["L"]
        active = final["active"]
        rays = final["rays"]
        if have_lights:
            o_f, d_f, beta = final["o"], final["d"], final["beta"]
            isect = accel_api.closest(scene, o_f, d_f)
            hit = active & isect.valid
            le = scene.lights.emitted(isect.light, isect.n, isect.wo, lam)
            if self.use_mis and self.use_nee:
                cos_l = dot(isect.n, isect.wo)
                light_pdf = scene.lights.pdf_li_area(
                    isect.light, isect.t, cos_l,
                    p_ref=final["prev_p"], n_ref=final["prev_ns"],
                )
                w_l = jnp.where(
                    final["specular"], 1.0,
                    power_heuristic(1, final["prev_pdf"], 1, light_pdf),
                )
                w_esc = jnp.where(
                    final["specular"], 1.0,
                    power_heuristic(
                        1, final["prev_pdf"], 1,
                        scene.lights.pdf_escaped(d_f, o_f),
                    ),
                )
            elif self.use_nee:
                w_l = jnp.where(final["specular"], 1.0, 0.0)
                w_esc = w_l
            else:
                w_l = jnp.ones_like(isect.t)
                w_esc = w_l
            if have_medium:
                dim_t = _CAM_DIMS + self.max_depth * _BOUNCE_DIMS
                seg = jnp.where(isect.valid, isect.t, jnp.inf)
                tr = self._transmittance(
                    scene, o_f, d_f, seg, lam, pixel, sample_idx, sampler,
                    dim_t,
                )
                # _transmittance zeroes occluded segments; the closest-hit
                # surface itself sits just beyond the shortened span, so
                # only the medium factor remains.
            else:
                tr = jnp.ones_like(beta)
            emit_mask = hit & (isect.light >= 0)
            L = L + jnp.where(
                emit_mask[..., None], beta * tr * w_l[..., None] * le, 0.0
            )
            escaped_rays = active & ~isect.valid
            L = L + jnp.where(
                escaped_rays[..., None],
                beta * tr * w_esc[..., None]
                * scene.lights.escaped_radiance(d_f, lam, o_f),
                0.0,
            )
            rays = rays + jnp.sum(active.astype(jnp.float32))
        return L, {"rays": rays}

"""Light-path (adjoint / particle) integrator: trace from lights, splat to
the camera.

Reference analogue: LightPathIntegrator
(/root/reference/src/pbrt/cpu/integrators.h:322): paths start at light
emission samples and every vertex connects to the camera with a film splat —
the adjoint half of BDPT (splat machinery here is the BDPT prerequisite).

Design: all N light paths advance in lockstep through a lax.scan; camera
connections project vertices with PerspectiveCamera.project and accumulate
into a flat (npix+1, 3) splat buffer with one masked scatter-add per bounce
(invalid connections land in the trash slot npix). Measure bookkeeping:

  pixel_value = (1/Omega_j) * int_{A visible in pixel j} L(p->cam)
                * cos(theta_p) / r^2 dA
  Omega_j = pixel_area(z=1 plane) * cos^3(theta_cam)

so each connection splats beta * f * V * cos_p / (r^2 * Omega_j * N).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..accel import api as accel_api
from ..accel.dense import offset_ray_origin
from ..core.gather import gather_rows
from ..core.pytree import pytree, static_field
from ..core.sampling import sample_cosine_hemisphere, sample_uniform_triangle
from ..core.vecmath import (
    coordinate_system,
    dot,
    from_local,
    normalize,
    shading_frame,
    to_local,
)
from ..lights.buffers import eval_emission
from ..materials import bxdf
from ..scene import Scene


@pytree
class LightPathIntegrator:
    max_depth: int = static_field(default=5)

    def render_splats(self, scene: Scene, camera, n_paths: int, wl,
                      sample_idx, sampler):
        """Trace n_paths light paths; returns a (ny, nx, 3) splat image whose
        expectation equals the forward-rendered image."""
        from ..films.rgb import spectrum_to_rgb
        from ..samplers.samplers import as_sampler

        sampler = as_sampler(sampler)
        lights = scene.lights
        assert lights.n_area + lights.n_sphl > 0, (
            "LightPath needs emissive geometry"
        )
        nx, ny = camera.resolution
        npix = nx * ny
        n = n_paths
        path_id = jnp.arange(n, dtype=jnp.int32)
        lam = wl.lam
        cam_p = camera.position
        a_base = camera.pixel_solid_angle_base()

        splat = jnp.zeros((npix + 1, 3), jnp.float32)

        # ---- Emission sampling (DiffuseAreaLight::SampleLe analogue;
        # shared area-triangle + analytic-sphere origin sampling).
        u_sel = sampler.get_1d(path_id, sample_idx, 1000)
        up0, up1 = sampler.get_2d(path_id, sample_idx, 1001)
        org = lights.sample_le_origin(u_sel, jnp.stack([up0, up1], -1))
        pmf, p0, n_l, area = org["pmf"], org["p"], org["n"], org["area"]
        le = eval_emission(org["coeffs"], org["scale"], org["illum"], lam)

        def connect(splat, p, n_geo, radiance_toward_cam_fn, active):
            """Splat the radiance leaving p toward the camera."""
            to_c = cam_p[None, :] - p
            r2 = jnp.maximum(jnp.sum(to_c * to_c, axis=-1), 1e-12)
            wi_c = to_c / jnp.sqrt(r2)[..., None]
            praster, cos_c, inside = camera.project(p)
            omega = a_base * jnp.maximum(cos_c, 1e-4) ** 3
            cos_p = jnp.abs(dot(n_geo, wi_c))
            l_cam = radiance_toward_cam_fn(wi_c)  # (n, S)
            so = offset_ray_origin(p, n_geo, wi_c)
            occ = accel_api.any_hit(
                scene, so, wi_c, jnp.sqrt(r2) * (1.0 - 1e-3)
            )
            ok = active & inside & ~occ
            rgb = spectrum_to_rgb(l_cam, wl)
            w = cos_p / (r2 * omega * n)
            contrib = jnp.where(ok[..., None], rgb * w[..., None], 0.0)
            pix = (
                jnp.clip(praster[..., 1].astype(jnp.int32), 0, ny - 1) * nx
                + jnp.clip(praster[..., 0].astype(jnp.int32), 0, nx - 1)
            )
            pix = jnp.where(ok, pix, npix)
            return splat.at[pix].add(contrib)

        # Depth 0: the light surface seen directly by the camera.
        front = lambda wi: jnp.where(
            (dot(n_l, wi) > 0.0)[..., None], le, 0.0
        )
        # beta for a surface point sampled with pdf pmf/area.
        beta0 = (area / jnp.maximum(pmf, 1e-12))[:, None]
        splat = connect(
            splat, p0, n_l,
            lambda wi: front(wi) * beta0,
            jnp.ones((n,), bool),
        )

        # Emission direction: cosine about the light normal.
        ud0, ud1 = sampler.get_2d(path_id, sample_idx, 1002)
        t1, t2 = coordinate_system(n_l)
        d_local = sample_cosine_hemisphere(jnp.stack([ud0, ud1], -1))
        d = from_local(d_local, t1, t2, n_l)
        # beta = Le * cos / (pdf_pos * pdf_dir) = Le * pi * area / pmf.
        beta = le * (jnp.pi * area / jnp.maximum(pmf, 1e-12))[:, None]
        o = offset_ray_origin(p0, n_l, d)
        active = jnp.ones((n,), bool)

        def bounce(carry, depth):
            splat, o, d, beta, active = carry
            isect = accel_api.closest(scene, o, d)
            hit = active & isect.valid & (isect.light < 0)
            ns = isect.n * jnp.sign(
                jnp.where(
                    dot(isect.n, isect.wo, keepdims=True) == 0.0, 1.0,
                    dot(isect.n, isect.wo, keepdims=True),
                )
            )
            t1b, t2b = shading_frame(ns, isect.dpdu)
            wo_l = to_local(isect.wo, t1b, t2b, ns)
            params = bxdf.surface_params(scene, isect, lam)

            def radiance_fn(wi_c):
                wi_l = to_local(wi_c, t1b, t2b, ns)
                return beta * bxdf.evaluate(params, wo_l, wi_l, lam)

            splat = connect(splat, isect.p, isect.n, radiance_fn, hit)

            dim0 = 1004 + depth * 4
            uc = sampler.get_1d(path_id, sample_idx, dim0)
            ub0, ub1 = sampler.get_2d(path_id, sample_idx, dim0 + 1)
            bs = bxdf.sample(
                params, wo_l, lam, jnp.stack([ub0, ub1], -1), uc
            )
            wi_w = from_local(bs["wi"], t1b, t2b, ns)
            ok = hit & (bs["pdf"] > 0.0)
            beta = jnp.where(
                ok[..., None],
                beta * bs["f"]
                * (jnp.abs(bs["wi"][..., 2]) / jnp.maximum(bs["pdf"], 1e-20))[
                    ..., None
                ],
                beta,
            )
            o_new = offset_ray_origin(isect.p, isect.n, wi_w)
            return (
                splat,
                jnp.where(ok[..., None], o_new, o),
                jnp.where(ok[..., None], wi_w, d),
                beta,
                ok,
            ), None

        (splat, *_), _ = jax.lax.scan(
            bounce, (splat, o, d, beta, active),
            jnp.arange(self.max_depth), length=self.max_depth,
        )
        return splat[:npix].reshape(ny, nx, 3)


def render_lightpath(scene, camera, n_paths_total: int = 1 << 20,
                     max_depth: int = 5, seed: int = 0,
                     paths_per_pass: int = 1 << 16):
    """Convenience renderer: averages splat passes into an image."""
    from ..core import spectrum
    from ..samplers.samplers import Sampler

    integ = LightPathIntegrator(max_depth=max_depth)
    sampler = Sampler.create("independent", spp=1, seed=seed)
    n_pass = max(1, n_paths_total // paths_per_pass)

    @jax.jit
    def one(scene, s):
        path_id = jnp.arange(paths_per_pass, dtype=jnp.int32)
        u = sampler.get_1d(path_id, s, 5)
        wl = spectrum.sample_visible(u)
        return integ.render_splats(
            scene, camera, paths_per_pass, wl, s, sampler
        )

    acc = None
    for s in range(n_pass):
        img = one(scene, jnp.int32(s))
        acc = img if acc is None else acc + img
    return acc / n_pass

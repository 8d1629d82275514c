#!/usr/bin/env python
"""Per-stage timing of one path-tracing bounce on the GPU.

Times each stage of PathIntegrator.bounce in isolation (own jit, realistic
shapes) to locate the Mrays/s bottleneck. Not part of the test suite.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from pbrt_tpu.utils import compile_cache

compile_cache.enable()


def timeit(name, fn, *args, reps=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:28s} {dt*1e3:8.3f} ms")
    return dt


def main():
    from pbrt_tpu.accel import api as accel_api
    from pbrt_tpu.core import spectrum
    from pbrt_tpu.core.vecmath import coordinate_system, to_local
    from pbrt_tpu.materials import bxdf
    from pbrt_tpu.render import camera_rays
    from pbrt_tpu.samplers.samplers import Sampler
    from pbrt_tpu.scenes.cornell import cornell_box

    n = 1 << 20
    scene, camera = cornell_box(resolution=(512, 512))
    pixel = jnp.arange(n, dtype=jnp.int32) % (512 * 512)
    sample = jnp.zeros((n,), jnp.int32)
    sampler = Sampler.create("independent", spp=16, seed=0)

    o, d, wl = camera_rays(camera, pixel, sample, jnp.int32(0))
    lam = wl.lam
    print(f"rays: {n}, spectral lanes: {lam.shape[-1]}, "
          f"tris: {scene.geom.num_triangles}, backend: {jax.default_backend()}")

    f_rays = jax.jit(lambda p, s: camera_rays(camera, p, s, jnp.int32(0)))
    timeit("camera_rays", f_rays, pixel, sample)

    f_isect = jax.jit(lambda o, d: accel_api.closest(scene, o, d))
    isect = f_isect(o, d)
    timeit("closest_hit", f_isect, o, d)

    f_any = jax.jit(
        lambda o, d: accel_api.any_hit(scene, o, d, jnp.full((n,), 10.0))
    )
    timeit("any_hit", f_any, o, d)

    # Shading frame + material fetch + NEE evals.
    ns = isect.n
    t1, t2 = coordinate_system(ns)
    wo_l = to_local(isect.wo, t1, t2, ns)

    def f_gather(mat):
        return scene.materials.gather(mat)

    f_gather = jax.jit(f_gather)
    params = f_gather(isect.mat)
    timeit("material_gather", f_gather, isect.mat)

    u = jnp.stack([jnp.full((n,), 0.3), jnp.full((n,), 0.7)], -1)

    f_light = jax.jit(
        lambda p, lam: scene.lights.sample_li(
            p, lam, jnp.full((n,), 0.5), u
        )
    )
    timeit("light_sample_li", f_light, isect.p, lam)

    ls = f_light(isect.p, lam)
    wi_l = to_local(ls.wi, t1, t2, ns)

    f_beval = jax.jit(lambda wo, wi, lam: bxdf.evaluate(params, wo, wi, lam))
    timeit("bxdf_evaluate", f_beval, wo_l, wi_l, lam)

    f_bpdf = jax.jit(lambda wo, wi: bxdf.pdf(params, wo, wi))
    timeit("bxdf_pdf", f_bpdf, wo_l, wi_l)

    f_bsample = jax.jit(
        lambda wo, lam: bxdf.sample(params, wo, lam, u, jnp.full((n,), 0.5))
    )
    timeit("bxdf_sample", f_bsample, wo_l, lam)

    f_emit = jax.jit(
        lambda light, ns_, wo, lam: scene.lights.emitted(light, ns_, wo, lam)
    )
    timeit("lights_emitted", f_emit, isect.light, ns, isect.wo, lam)

    # Sampler draw cost (5 1d + 2 2d per bounce).
    def f_sampler(p, s):
        acc = 0.0
        for k in range(5):
            acc = acc + sampler.get_1d(p, s, jnp.int32(8 + k))
        for k in range(2):
            a, b = sampler.get_2d(p, s, jnp.int32(16 + k))
            acc = acc + a + b
        return acc

    f_sampler = jax.jit(f_sampler)
    timeit("sampler_draws(5x1d+2x2d)", f_sampler, pixel, sample)


if __name__ == "__main__":
    main()

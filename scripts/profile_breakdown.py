#!/usr/bin/env python
"""Per-phase wall-time breakdown on the mesh bench scene (BASELINE cfg 2).

Times each traversal phase separately on real rays of each coherence class
(camera rays, diffuse bounce rays, shadow rays) so the killeroo traversal
time can be attributed: ray sort, sweep kernel, attribute resolution,
full closest(), any_hit(), and one full integrator pass.

Usage:  python scripts/profile_breakdown.py [--scene killeroo|cornell]
        [--rays 1048576] [--trace DIR]
With --trace, additionally captures an XLA profiler trace of one render
pass (view via tensorboard_plugin_profile).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("PBRT_TPU_NSPECTRUM", "8")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="killeroo")
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--no-cache", action="store_true")
    args = ap.parse_args()

    import jax

    if not args.no_cache:
        from pbrt_tpu.utils import compile_cache

        compile_cache.enable()

    import jax.numpy as jnp

    from pbrt_tpu.accel import api as accel_api
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import camera_rays
    from pbrt_tpu.utils.profile import capture, sync, timed_breakdown

    if args.scene == "cornell":
        from pbrt_tpu.scenes.cornell import cornell_box

        scene, camera = cornell_box(resolution=(256, 256))
    else:
        from pbrt_tpu.scenes.meshes import killeroo_class_scene

        scene, camera = killeroo_class_scene(resolution=(512, 512))
    t0 = time.perf_counter()
    scene = scene.with_accel()
    if scene.sweep is not None:
        sync(scene.sweep.boxes)
        print(f"accel: sweep clusters={scene.sweep.n_clusters} "
              f"build={time.perf_counter() - t0:.2f}s")

    n = args.rays
    nx, ny = camera.resolution
    npix = nx * ny
    k = max(1, n // npix)
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (k,))
    sample = jnp.repeat(jnp.arange(k, dtype=jnp.int32), npix)

    @jax.jit
    def gen_camera(pixel, sample):
        return camera_rays(camera, pixel, sample, jnp.int32(0))

    o_c, d_c, wl = gen_camera(pixel, sample)
    sync(o_c)
    nr = o_c.shape[0]
    print(f"rays: {nr}")

    # Diffuse bounce rays: intersect camera rays, cosine-sample at hits.
    @jax.jit
    def gen_bounce(o, d):
        isect = accel_api.closest(scene, o, d)
        key = jax.random.PRNGKey(7)
        u = jax.random.uniform(key, (o.shape[0], 2))
        nrm = jnp.where(isect.valid[:, None], isect.n, jnp.array([0.0, 1.0, 0.0]))
        r = jnp.sqrt(u[:, 0:1])
        phi = 2 * jnp.pi * u[:, 1:2]
        x = r * jnp.cos(phi)
        y = r * jnp.sin(phi)
        z = jnp.sqrt(jnp.maximum(1 - u[:, 0:1], 0.0))
        up = jnp.where(
            jnp.abs(nrm[:, 2:3]) < 0.9,
            jnp.array([0.0, 0.0, 1.0]), jnp.array([1.0, 0.0, 0.0]),
        )
        t1 = jnp.cross(up, nrm)
        t1 = t1 / jnp.maximum(
            jnp.linalg.norm(t1, axis=-1, keepdims=True), 1e-9)
        t2 = jnp.cross(nrm, t1)
        d_new = x * t1 + y * t2 + z * nrm
        o_new = jnp.where(
            isect.valid[:, None], isect.p + 1e-3 * nrm, o + 1e3 * d)
        tmax = jnp.where(isect.valid, jnp.inf, 0.0)
        return o_new, d_new, tmax

    o_b, d_b, tm_b = gen_bounce(o_c, d_c)
    sync(o_b)
    live = float(jnp.sum(tm_b > 0))
    print(f"bounce rays live: {live:.0f} ({100*live/nr:.0f}%)")

    inf = jnp.full((nr,), jnp.inf)

    def cam_rays_case(o, d, tm, tag):
        from pbrt_tpu.ops.sweep import sweep_intersect as _isect

        acc = scene.sweep
        kw = {}

        perm, invp = jax.jit(accel_api.ray_sort_perm)(o, d, tm)
        sync(perm)
        os_, ds_, ts_ = o[perm], d[perm], tm[perm]
        sync(os_)

        sort_fn = jax.jit(lambda o, d, tm: accel_api.ray_sort_perm(o, d, tm)[0])
        trav = jax.jit(
            lambda o, d, tm: _isect(acc, o, d, tm, any_hit=False, **kw)["t"]
        )
        trav_any = jax.jit(
            lambda o, d, tm: _isect(acc, o, d, tm, any_hit=True)["prim"]
        )
        prim = jax.jit(
            lambda o, d, tm: _isect(
                acc, o, d, tm, any_hit=False, **kw
            )["prim"]
        )(os_, ds_, ts_)
        sync(prim)
        attrs = jax.jit(
            lambda o, d, p: accel_api.resolve_tri_attrs(scene.geom, o, d, p)[2]
        )
        full = jax.jit(lambda o, d, tm: accel_api.closest(scene, o, d, tm).t)

        stages = {
            f"{tag}/sort": lambda: sort_fn(o, d, tm),
            f"{tag}/traverse_sorted": lambda: trav(os_, ds_, ts_),
            f"{tag}/traverse_unsorted": lambda: trav(o, d, tm),
            f"{tag}/any_hit_sorted": lambda: trav_any(os_, ds_, ts_),
            f"{tag}/resolve_attrs": lambda: attrs(os_, ds_, prim),
            f"{tag}/closest_full": lambda: full(o, d, tm),
        }
        res = timed_breakdown(stages, warmup=1, iters=3)
        for k_, v in res.items():
            print(f"  {k_:32s} {v*1e3:9.2f} ms   {nr/v/1e6:8.2f} Mrays/s")
        return res

    if scene.sweep is not None:
        print("== camera rays ==")
        cam_rays_case(o_c, d_c, inf, "camera")
        print("== bounce rays ==")
        cam_rays_case(o_b, d_b, tm_b, "bounce")

    integ = PathIntegrator(max_depth=5, rr_start_depth=5)

    @jax.jit
    def render_pass(o, d):
        L, stats = integ.trace_with_stats(
            scene, o, d, wl, pixel, sample, jnp.int32(0))
        return L.sum(), stats["rays"]

    t0 = time.perf_counter()
    s_, r_ = render_pass(o_c, d_c)
    sync(s_)
    print(f"render_pass compile+run: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    s_, r_ = render_pass(o_c, d_c)
    rays = float(sync(r_))
    dt = time.perf_counter() - t0
    print(f"render_pass: {dt*1e3:.1f} ms  rays={rays:.0f}  "
          f"{rays/dt/1e6:.2f} Mrays/s")

    if args.trace:
        with capture(args.trace):
            s_, r_ = render_pass(o_c, d_c)
            sync(s_)
        print(f"trace written to {args.trace}")


if __name__ == "__main__":
    main()

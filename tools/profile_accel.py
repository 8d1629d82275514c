#!/usr/bin/env python
"""Time each Pallas traversal kernel against its plain XLA alternative.

    python tools/profile_accel.py [--reps N] [--part e2e|crossover|tune]

e2e: one forward render pass end to end, on the scene that uses each kernel:
  * Cornell box (256^2 x 16 samples, depth 5): brute-force kernel
    (ops/smallscene.py) vs the dense XLA tester (accel/dense.py) vs the
    sweep kernel given the one-cluster scene;
  * killeroo-class mesh (512^2 x 4 samples, depth 5): sweep kernel
    (ops/sweep.py) vs the jnp BVH traversal (accel/bvh.py).
crossover: Scene.with_accel's threshold. Render passes (256^2 x 16 samples,
  depth 5: camera, bounce and shadow rays) of the Cornell box filled with a
  seeded cloud of small triangles up to 512, 768 and 1024 in all,
  brute-force kernel vs sweep kernel, timed in alternation.
tune: block and warp counts of both kernels on one query.

Needs a GPU; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(name, fn, *args, reps=5):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    t_first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    print(f"{name:48s} best {best * 1e3:10.3f} ms  "
          f"(first call incl. compile {t_first:.1f}s)", flush=True)
    return best


def render_pass(scene, camera, integrator, k):
    """One jitted pass of k samples per pixel (the render() inner loop)."""
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.films.rgb import spectrum_to_rgb
    from pbrt_tpu.render import camera_rays

    nx, ny = camera.resolution
    npix = nx * ny
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (k,))
    sample = jnp.repeat(jnp.arange(k, dtype=jnp.int32), npix)

    @jax.jit
    def run(scene):
        o, d, wl = camera_rays(camera, pixel, sample, jnp.int32(0))
        rgb = spectrum_to_rgb(
            integrator.trace(scene, o, d, wl, pixel, sample, jnp.int32(0)),
            wl)
        return jnp.mean(rgb.reshape(k, ny, nx, 3), axis=0)

    return run


def part_e2e(reps):
    import numpy as np

    from pbrt_tpu.accel.bvh import build_bvh
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.scenes.cornell import cornell_box
    from pbrt_tpu.scenes.meshes import killeroo_class_scene

    integ = PathIntegrator(max_depth=5, rr_start_depth=5)
    scene, camera = cornell_box(resolution=(256, 256))
    variants = {
        "cornell pass: brute-force kernel": scene.with_accel(),
        "cornell pass: dense XLA": scene,
        "cornell pass: sweep kernel": scene.with_accel(threshold=0),
    }
    for name, sc in variants.items():
        timeit(name, render_pass(sc, camera, integ, 16), sc, reps=reps)

    scene, camera = killeroo_class_scene(resolution=(512, 512))
    bvh = scene.replace(
        sweep=None, bvh=build_bvh(np.asarray(scene.geom.tri_verts)))
    for name, sc in (("killeroo pass: sweep kernel", scene),
                     ("killeroo pass: jnp BVH", bvh)):
        timeit(name, render_pass(sc, camera, integ, 4), sc, reps=reps)


def cloud_cornell(n_tris, seed=0):
    """The Cornell box plus seeded small diffuse triangles inside it, up to
    n_tris triangles in all (the box's own light triangles kept)."""
    import numpy as np

    from pbrt_tpu.scenes.cornell import cornell_box
    from pbrt_tpu.shapes.geometry import GeometryBuffers

    scene, camera = cornell_box(resolution=(256, 256))
    g = scene.geom
    n = n_tris - g.num_triangles
    r = np.random.default_rng(seed)
    c = r.uniform(0.1, 0.9, (n, 1, 3))
    tris = (c + r.normal(scale=0.04, size=(n, 3, 3))).astype(np.float32)
    geom = GeometryBuffers.build(
        tri_verts=np.concatenate([np.asarray(g.tri_verts), tris]),
        tri_mat=np.concatenate([np.asarray(g.tri_mat),
                                r.integers(0, 3, n).astype(np.int32)]),
        tri_light=np.concatenate([np.asarray(g.tri_light),
                                  np.full(n, -1, np.int32)]),
    )
    return scene.replace(geom=geom), camera


def part_crossover(reps):
    import jax
    import numpy as np

    from pbrt_tpu.models.path import PathIntegrator

    integ = PathIntegrator(max_depth=5, rr_start_depth=5)
    for n_tris in (512, 768, 1024):
        scene, camera = cloud_cornell(n_tris)
        variants = {"brute force": scene.with_accel(threshold=n_tris),
                    "sweep": scene.with_accel(threshold=0)}
        runs = {k: render_pass(s, camera, integ, 16)
                for k, s in variants.items()}
        for k, f in runs.items():
            jax.block_until_ready(f(variants[k]))
        times = {k: [] for k in runs}
        for _ in range(reps):
            for k, f in runs.items():
                t0 = time.perf_counter()
                jax.block_until_ready(f(variants[k]))
                times[k].append(time.perf_counter() - t0)
        for k, ts in times.items():
            ts = np.asarray(ts) * 1e3
            print(f"pass 256^2 x 16, {n_tris} tris: {k:12s} median "
                  f"{np.median(ts):9.3f} ms  min {ts.min():9.3f}  "
                  f"max {ts.max():9.3f}  (n={len(ts)})", flush=True)


def part_tune(reps):
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.accel import api
    from pbrt_tpu.ops.smallscene import _smallscene_intersect_impl
    from pbrt_tpu.ops.sweep import _sweep_intersect_impl
    from pbrt_tpu.render import camera_rays
    from pbrt_tpu.scenes.cornell import cornell_box
    from pbrt_tpu.scenes.meshes import killeroo_class_scene

    def cam(camera):
        nx, ny = camera.resolution
        pixel = jnp.arange(nx * ny, dtype=jnp.int32)
        o, d, _ = camera_rays(camera, pixel, jnp.zeros_like(pixel),
                              jnp.int32(0))
        return o, d, jnp.full((nx * ny,), jnp.inf)

    scene, camera = cornell_box(resolution=(1024, 1024))
    acc = scene.with_accel().small
    o, d, t = cam(camera)
    for block in (128, 256, 512):
        for warps in (4, 8):
            f = jax.jit(lambda o, d, t, b=block, w=warps:
                        _smallscene_intersect_impl(acc, o, d, t, block=b,
                                                   num_warps=w)["t"])
            timeit(f"cornell 2^20 brute force block={block} warps={warps}",
                   f, o, d, t, reps=reps)

    scene, camera = killeroo_class_scene(resolution=(512, 512))
    o, d, t = cam(camera)
    perm, _ = jax.jit(api.ray_sort_perm)(o, d, t)
    o, d, t = o[perm], d[perm], t[perm]
    for tile, chunk, warps in ((128, 32, 4), (128, 16, 4), (64, 32, 4),
                               (128, 32, 8), (256, 32, 8), (64, 16, 2)):
        f = jax.jit(lambda o, d, t, a=tile, c=chunk, w=warps:
                    _sweep_intersect_impl(scene.sweep, o, d, t, tile=a,
                                          tri_chunk=c, num_warps=w)["t"])
        timeit(f"killeroo 2^18 sweep tile={tile} chunk={chunk} "
               f"warps={warps}", f, o, d, t, reps=reps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--part", action="append",
                    choices=("e2e", "crossover", "tune"))
    args = ap.parse_args()

    import jax

    from pbrt_tpu.utils import compile_cache

    compile_cache.enable()
    if jax.default_backend() != "gpu":
        sys.exit(f"profile_accel: needs a GPU, backend is "
                 f"{jax.default_backend()!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"device: {jax.devices()[0].device_kind}; card: {card}",
          flush=True)
    for part in args.part or ["e2e", "crossover", "tune"]:
        {"e2e": part_e2e, "crossover": part_crossover,
         "tune": part_tune}[part](args.reps)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Decide sorted_shading: measure the tag-sorted material
dispatch against masked evaluate-all on scenes of increasing material-mix
cost, print the break-even verdict.

sorted_shading pays an argsort + gather/scatter per bounce to stop
charging every lane for every material family present; it can only win
when the per-lane cost of evaluating ALL families exceeds the sort tax.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("PBRT_TPU_NSPECTRUM", "8")


def build_mixed_scene(expensive: bool):
    """Gallery scene: diffuse/conductor/dielectric (+ coated/hair-class
    families when expensive=True)."""
    import numpy as np

    from pbrt_tpu.cameras.perspective import PerspectiveCamera
    from pbrt_tpu.core import transform
    from pbrt_tpu.lights.buffers import LightBuffers
    from pbrt_tpu.materials.buffers import (
        MAT_COATEDCONDUCTOR, MAT_COATEDDIFFUSE, MAT_CONDUCTOR,
        MAT_DIELECTRIC, MAT_DIFFUSE, MaterialBuffers,
    )
    from pbrt_tpu.scene import Scene
    from pbrt_tpu.scenes.meshes import icosphere
    from pbrt_tpu.shapes.geometry import GeometryBuffers, make_quad

    parts, mats = [], []
    kinds = (
        [MAT_DIFFUSE, MAT_CONDUCTOR, MAT_DIELECTRIC,
         MAT_COATEDDIFFUSE, MAT_COATEDCONDUCTOR]
        if expensive else
        [MAT_DIFFUSE, MAT_CONDUCTOR, MAT_DIELECTRIC]
    )
    for i, _ in enumerate(kinds):
        s = icosphere(3, 0.5, ((i % 3) * 1.4 - 1.4, 0.5, (i // 3) * 1.4))
        parts.append(s)
        mats.append(np.full(len(s), i, np.int32))
    floor = make_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4))
    parts.append(floor)
    mats.append(np.zeros(2, np.int32))
    light_quad = make_quad(
        (-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1)
    )[:, ::-1]
    tri = np.concatenate(parts + [light_quad])
    tm = np.concatenate(mats + [np.zeros(2, np.int32)])
    tl = np.full(len(tri), -1, np.int32)
    tl[-2:] = [0, 1]
    specs = []
    for k in kinds:
        specs.append({"kind": k, "albedo": (0.6, 0.5, 0.4),
                      "roughness": 0.2})
    materials = MaterialBuffers.build(specs)
    lights = LightBuffers.build(area_tris=[
        {"verts": light_quad[0], "rgb": (1, 1, 1), "scale": 10.0},
        {"verts": light_quad[1], "rgb": (1, 1, 1), "scale": 10.0},
    ])
    geom = GeometryBuffers.build(tri_verts=tri, tri_mat=tm, tri_light=tl)
    scene = Scene(geom=geom, materials=materials, lights=lights).with_accel()
    cam = PerspectiveCamera(
        camera_to_world=transform.look_at(
            (0, 2.2, -5), (0, 0.6, 0), (0, 1, 0)),
        resolution=(256, 256), fov_deg=45,
    )
    return scene, cam


def measure(scene, camera, sorted_shading: bool, spp=32):
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import camera_rays

    integ = PathIntegrator(max_depth=4, rr_start_depth=4,
                           sorted_shading=sorted_shading)
    nx, ny = camera.resolution
    npix = nx * ny
    k = 4
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (k,))

    @jax.jit
    def rp(scene, p):
        sample = jnp.repeat(p * k + jnp.arange(k, dtype=jnp.int32), npix)
        o, d, wl = camera_rays(camera, pixel, sample, jnp.int32(0))
        L, stats = integ.trace_with_stats(
            scene, o, d, wl, pixel, sample, jnp.int32(0))
        return L.sum(), stats["rays"]

    s, r = rp(scene, jnp.int32(0))
    jax.block_until_ready(s)
    n_passes = spp // k
    t0 = time.perf_counter()
    rd = None
    for p in range(n_passes):
        s, r = rp(scene, jnp.int32(p))
        rd = r if rd is None else rd + r
    rays = float(jax.block_until_ready(rd))
    dt = time.perf_counter() - t0
    return rays / dt / 1e6


def main():
    import jax

    from pbrt_tpu.utils import compile_cache

    compile_cache.enable()
    for tag, expensive in (("cheap-mix", False), ("expensive-mix", True)):
        scene, cam = build_mixed_scene(expensive)
        off = measure(scene, cam, False)
        on = measure(scene, cam, True)
        print(f"{tag}: masked={off:.2f} Mrays/s sorted={on:.2f} Mrays/s "
              f"ratio={on / off:.2f}", flush=True)


if __name__ == "__main__":
    main()

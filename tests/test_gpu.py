"""Compiled traversal kernels on the GPU against the dense reference.

Marked `gpu`: they skip unless JAX's backend is a GPU. Run them on the card
with `JAX_PLATFORMS=cuda python -m pytest -o addopts="" -m gpu tests/`.
The same comparisons run at full width in chip_smoke.py's kernel phase.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrt_tpu.utils import hitcheck

pytestmark = pytest.mark.gpu


def _cam(camera):
    from pbrt_tpu.render import camera_rays

    nx, ny = camera.resolution
    pixel = jnp.arange(nx * ny, dtype=jnp.int32)
    o, d, _ = camera_rays(camera, pixel, jnp.zeros_like(pixel), jnp.int32(0))
    return o, d


def test_gpu_backend_runs_compiled_kernels():
    from pbrt_tpu.accel import api

    assert jax.default_backend() == "gpu"
    assert api.kernels_compiled() is True


def test_gpu_brute_force_cornell():
    from pbrt_tpu.scenes.cornell import cornell_box

    scene, camera = cornell_box(resolution=(256, 256))
    scene = scene.with_accel()
    assert scene.small is not None
    hitcheck.check_accel("cornell", scene, scene.geom, _cam(camera), 1 << 16)


@pytest.mark.parametrize("n_tris", [100, 1024])
def test_gpu_brute_force_soup(n_tris):
    from pbrt_tpu.scenes.cornell import cornell_box
    from pbrt_tpu.shapes.geometry import GeometryBuffers

    tris, mat, light = hitcheck.soup(n_tris, seed=n_tris)
    geom = GeometryBuffers.build(tri_verts=tris, tri_mat=mat, tri_light=light)
    base, _ = cornell_box(resolution=(8, 8))
    scene = base.replace(geom=geom).with_accel(threshold=n_tris)
    assert scene.small is not None
    rays = hitcheck.look_rays(1 << 16, (0, 0, -6), (-1.5,) * 3, (1.5,) * 3)
    hitcheck.check_accel("soup", scene, geom, rays, 1 << 16)


def test_gpu_sweep_killeroo():
    from pbrt_tpu.scenes.meshes import killeroo_class_scene

    scene, camera = killeroo_class_scene(resolution=(256, 256))
    assert scene.sweep is not None
    hitcheck.check_accel("killeroo", scene, scene.geom, _cam(camera), 1 << 15)


def test_gpu_sweep_instanced():
    from pbrt_tpu.io.parser import load_pbrt_string

    si, _, _ = load_pbrt_string(hitcheck.instanced_pbrt(216, seed=4))
    sf, _, _ = load_pbrt_string(
        hitcheck.instanced_pbrt(216, seed=4, flatten=True))
    assert si.sweep is not None and si.sweep.instanced
    n_proto = si.geom.num_triangles
    rays = hitcheck.look_rays(1 << 16, (0, 0, -60), (-10,) * 3, (10,) * 3,
                              seed=5)
    hitcheck.check_accel(
        "instanced", si, sf.geom, rays, 1 << 15,
        ref_prim=lambda p, v: np.where(v, p % n_proto, -1),
    )

"""BVH build + traversal tests: exact agreement with the dense tester.

Ref model: aggregates' correctness is checked against brute force
(shapes_test.cpp style), plus an end-to-end mesh render.
"""

import numpy as np
import jax.numpy as jnp

from pbrt_tpu.accel import api as accel_api
from pbrt_tpu.accel.bvh import build_bvh, bvh_intersect
from pbrt_tpu.accel.dense import intersect_closest, intersect_any
from pbrt_tpu.scenes.meshes import icosphere, torus
from pbrt_tpu.shapes.geometry import GeometryBuffers


def _random_rays(n, seed, spread=2.5):
    r = np.random.default_rng(seed)
    o = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_bvh_matches_dense_closest():
    tris = np.concatenate(
        [icosphere(2, 0.8, (0, 0, 0)), torus(1.4, 0.3, 48, 24)]
    )
    geom = GeometryBuffers.build(tri_verts=tris)
    bvh = build_bvh(tris)
    o, d = _random_rays(4096, 0)
    ref = intersect_closest(geom, o, d)
    t, prim, u, v = bvh_intersect(
        bvh, o, d, jnp.full((4096,), jnp.inf, jnp.float32)
    )
    np.testing.assert_array_equal(np.asarray(prim >= 0), np.asarray(ref.valid))
    hit = np.asarray(ref.valid)
    np.testing.assert_allclose(
        np.asarray(t)[hit], np.asarray(ref.t)[hit], rtol=1e-4
    )
    # Same primitive except for exact-tie duplicates.
    agree = (np.asarray(prim) == np.asarray(ref.prim))[hit]
    assert agree.mean() > 0.995


def test_bvh_matches_dense_any():
    tris = icosphere(2, 0.8)
    geom = GeometryBuffers.build(tri_verts=tris)
    bvh = build_bvh(tris)
    o, d = _random_rays(2048, 1)
    tmax = jnp.full((2048,), 1.5, jnp.float32)
    ref = intersect_any(geom, o, d, tmax)
    _, prim, _, _ = bvh_intersect(bvh, o, d, tmax, any_hit=True)
    np.testing.assert_array_equal(np.asarray(prim >= 0), np.asarray(ref))


def test_bvh_interaction_assembly():
    """scene.with_accel routing produces the same Interaction fields."""
    from pbrt_tpu.lights.buffers import LightBuffers
    from pbrt_tpu.materials.buffers import MaterialBuffers, MAT_DIFFUSE
    from pbrt_tpu.scene import Scene

    tris = icosphere(2, 1.0)
    geom = GeometryBuffers.build(
        tri_verts=tris, tri_mat=np.full(len(tris), 0, np.int32)
    )
    mats = MaterialBuffers.build([{"kind": MAT_DIFFUSE, "albedo": (0.5,) * 3}])
    lights = LightBuffers.build(
        points=[{"p": (0, 0, 0), "rgb": (1, 1, 1), "scale": 1.0}]
    )
    scene = Scene(geom=geom, materials=mats, lights=lights)
    scene_bvh = scene.with_accel(threshold=1)
    assert scene_bvh.sweep is not None
    o, d = _random_rays(1024, 2, spread=1.8)
    a = accel_api.closest(scene, o, d)
    b = accel_api.closest(scene_bvh, o, d)
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    hit = np.asarray(a.valid)
    np.testing.assert_allclose(
        np.asarray(a.p)[hit], np.asarray(b.p)[hit], atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(a.n)[hit], np.asarray(b.n)[hit], atol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(a.light)[hit], np.asarray(b.light)[hit]
    )


def test_sweep_many_clusters_matches_dense():
    """Sweep accelerator at scale: hundreds of clusters, so the per-tile
    candidate cull and front-to-back termination really choose among
    entries. Closest + any-hit, camera-style and shuffled rays, against
    the dense oracle — including the deferred-attribute resolution
    (accel/api.resolve_tri_attrs)."""
    from pbrt_tpu.lights.buffers import LightBuffers
    from pbrt_tpu.materials.buffers import MaterialBuffers, MAT_DIFFUSE
    from pbrt_tpu.scene import Scene

    # ~37k triangles -> ~290 clusters of 128.
    tris = np.concatenate(
        [torus(1.4, 0.35, 225, 80), icosphere(3, 0.6, (0, 0, 0.8))]
    )
    geom = GeometryBuffers.build(
        tri_verts=tris,
        tri_mat=(np.arange(len(tris)) % 3).astype(np.int32),
        tri_light=np.where(
            np.arange(len(tris)) % 97 == 0, 0, -1
        ).astype(np.int32),
    )
    mats = MaterialBuffers.build(
        [{"kind": MAT_DIFFUSE, "albedo": (0.5,) * 3}] * 3
    )
    lights = LightBuffers.build(
        points=[{"p": (0, 0, 3), "rgb": (1, 1, 1), "scale": 1.0}]
    )
    scene = Scene(geom=geom, materials=mats, lights=lights)
    sc = scene.with_accel(threshold=1)
    assert sc.sweep is not None and sc.sweep.n_clusters >= 256

    n = 2048
    # Camera-style: common origin, coherent directions at the geometry.
    r = np.random.default_rng(7)
    tgt = r.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    o_cam = np.tile(np.array([[0.0, -4.0, 0.0]], np.float32), (n, 1))
    d_cam = tgt - o_cam
    d_cam /= np.linalg.norm(d_cam, axis=1, keepdims=True)
    o_shuf, d_shuf = _random_rays(n, 11, spread=2.0)

    for o, d in ((jnp.asarray(o_cam), jnp.asarray(d_cam)),
                 (o_shuf, d_shuf)):
        a = accel_api.closest(scene, o, d)
        b = accel_api.closest(sc, o, d)
        np.testing.assert_array_equal(
            np.asarray(a.valid), np.asarray(b.valid)
        )
        hit = np.asarray(a.valid)
        assert hit.mean() > 0.2  # the rays genuinely exercise the mesh
        np.testing.assert_allclose(
            np.asarray(a.t)[hit], np.asarray(b.t)[hit], rtol=1e-4
        )
        agree = (np.asarray(a.prim) == np.asarray(b.prim))[hit]
        assert agree.mean() > 0.995  # exact-tie duplicates only
        same = agree & hit[hit]
        np.testing.assert_allclose(
            np.asarray(a.n)[hit][same], np.asarray(b.n)[hit][same],
            atol=1e-4,
        )
        np.testing.assert_allclose(
            np.asarray(a.uv)[hit][same], np.asarray(b.uv)[hit][same],
            atol=1e-3,
        )
        np.testing.assert_array_equal(
            np.asarray(a.mat)[hit][same], np.asarray(b.mat)[hit][same]
        )
        np.testing.assert_array_equal(
            np.asarray(a.light)[hit][same], np.asarray(b.light)[hit][same]
        )

        # Any-hit with finite tmax.
        tmax = jnp.full((n,), 2.5, jnp.float32)
        occ_a = accel_api.any_hit(scene, o, d, tmax)
        occ_b = accel_api.any_hit(sc, o, d, tmax)
        np.testing.assert_array_equal(
            np.asarray(occ_a), np.asarray(occ_b)
        )


def test_mesh_scene_renders():
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import render
    from pbrt_tpu.scenes.meshes import mesh_gallery_scene

    scene, camera = mesh_gallery_scene(resolution=(24, 24), subdiv=2)
    assert scene.sweep is not None
    img = np.asarray(
        render(scene, camera, PathIntegrator(max_depth=4), spp=4,
               samples_per_pass=2)
    )
    assert np.isfinite(img).all()
    assert img.mean() > 0.01

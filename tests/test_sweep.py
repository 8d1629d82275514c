"""Candidate-sweep accelerator tests: exact agreement with the dense
tester, instanced == flattened equivalence, memory O(unique geometry).

Ref model: aggregate correctness vs brute force (shapes_test.cpp style);
instancing semantics per TransformedPrimitive (cpu/primitive.h:86-119,
scene.cpp:1352-1557).
"""

import numpy as np
import jax.numpy as jnp

from pbrt_tpu.accel import api as accel_api
from pbrt_tpu.accel.dense import intersect_any, intersect_closest
from pbrt_tpu.ops.sweep import build_sweep, sweep_intersect
from pbrt_tpu.scenes.meshes import icosphere, torus
from pbrt_tpu.shapes.geometry import GeometryBuffers


def _random_rays(n, seed, spread=2.5):
    r = np.random.default_rng(seed)
    o = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_sweep_matches_dense_closest():
    tris = np.concatenate(
        [icosphere(2, 0.8, (0, 0, 0)), torus(1.4, 0.3, 48, 24)]
    )
    geom = GeometryBuffers.build(tri_verts=tris)
    acc = build_sweep(tris)
    n = 4096
    o, d = _random_rays(n, 0)
    tmax = jnp.full((n,), jnp.inf, jnp.float32)
    ref = intersect_closest(geom, o, d)
    res = sweep_intersect(acc, o, d, tmax, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(res["prim"] >= 0), np.asarray(ref.valid)
    )
    hit = np.asarray(ref.valid)
    np.testing.assert_allclose(
        np.asarray(res["t"])[hit], np.asarray(ref.t)[hit], rtol=1e-4
    )
    agree = (np.asarray(res["prim"]) == np.asarray(ref.prim))[hit]
    assert agree.mean() > 0.995


def test_sweep_matches_dense_any_and_dead_lanes():
    tris = icosphere(2, 0.8)
    geom = GeometryBuffers.build(tri_verts=tris)
    acc = build_sweep(tris)
    n = 2048
    o, d = _random_rays(n, 1)
    tmax = np.full((n,), 1.5, np.float32)
    tmax[:200] = 0.0  # dead lanes must stay misses
    tmax = jnp.asarray(tmax)
    ref = intersect_any(geom, o, d, tmax)
    res = sweep_intersect(acc, o, d, tmax, any_hit=True, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(res["prim"] >= 0), np.asarray(ref)
    )


def _instance_set(proto, n_inst, seed=3):
    rng = np.random.default_rng(seed)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n_inst, 1, 1))
    flat = []
    for i in range(n_inst):
        ang = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(ang), np.sin(ang)
        sc = rng.uniform(0.5, 1.5, 3)  # non-uniform scale
        r = (np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
             * sc[None, :]).astype(np.float32)
        t = rng.uniform(-5, 5, 3).astype(np.float32)
        o2w[i, :3, :3] = r
        o2w[i, :3, 3] = t
        flat.append((proto @ r.T + t).astype(np.float32))
    return o2w, np.concatenate(flat)


def test_sweep_instanced_matches_flattened():
    proto = icosphere(2, 1.0)
    n_inst = 9
    o2w, flat = _instance_set(proto, n_inst)
    acc_i = build_sweep(
        proto, proto_ranges=[(0, len(proto))],
        instances=(np.zeros(n_inst, np.int32), o2w),
    )
    acc_f = build_sweep(flat)
    n = 4096
    o, d = _random_rays(n, 4, spread=7.0)
    tmax = jnp.full((n,), jnp.inf, jnp.float32)
    ri = sweep_intersect(acc_i, o, d, tmax, interpret=True)
    rf = sweep_intersect(acc_f, o, d, tmax, interpret=True)
    hi = np.asarray(ri["prim"] >= 0)
    hf = np.asarray(rf["prim"] >= 0)
    np.testing.assert_array_equal(hi, hf)
    ok = hi & hf
    np.testing.assert_allclose(
        np.asarray(ri["t"])[ok], np.asarray(rf["t"])[ok],
        rtol=1e-3, atol=1e-4,
    )
    # Flattened prim = inst * len(proto) + prototype prim.
    pi = np.asarray(ri["prim"])[ok]
    ii = np.asarray(ri["inst"])[ok]
    pf = np.asarray(rf["prim"])[ok]
    assert (pf == ii * len(proto) + pi).mean() > 0.995
    # Memory is O(unique geometry): instanced accel stores prototype
    # triangles once, flattened stores them n_inst times.
    assert acc_i.v0x.shape[0] * n_inst <= acc_f.v0x.shape[0] + n_inst


def test_sweep_instanced_interaction_normals():
    """api.closest on an instanced scene: normals match the flattened
    scene (including non-uniform scale, which needs world-space edges)."""
    from pbrt_tpu.lights.buffers import LightBuffers
    from pbrt_tpu.materials.buffers import MAT_DIFFUSE, MaterialBuffers
    from pbrt_tpu.scene import Scene

    proto = icosphere(2, 1.0)
    n_inst = 4
    o2w, flat = _instance_set(proto, n_inst, seed=5)

    def mk(geo_tris, sweep_acc):
        geom = GeometryBuffers.build(
            tri_verts=geo_tris,
            tri_mat=np.zeros(len(geo_tris), np.int32),
        )
        mats = MaterialBuffers.build(
            [{"kind": MAT_DIFFUSE, "albedo": (0.5,) * 3}]
        )
        lights = LightBuffers.build(
            points=[{"p": (0, 9, 0), "rgb": (1, 1, 1), "scale": 30.0}]
        )
        return Scene(
            geom=geom, materials=mats, lights=lights, sweep=sweep_acc,
        )

    sc_i = mk(proto, build_sweep(
        proto, proto_ranges=[(0, len(proto))],
        instances=(np.zeros(n_inst, np.int32), o2w),
    ))
    sc_f = mk(flat, build_sweep(flat))
    n = 2048
    o, d = _random_rays(n, 6, spread=7.0)
    isect_i = accel_api.closest(sc_i, o, d)
    isect_f = accel_api.closest(sc_f, o, d)
    vi = np.asarray(isect_i.valid)
    vf = np.asarray(isect_f.valid)
    np.testing.assert_array_equal(vi, vf)
    ok = vi
    np.testing.assert_allclose(
        np.asarray(isect_i.n)[ok], np.asarray(isect_f.n)[ok],
        rtol=1e-3, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(isect_i.p)[ok], np.asarray(isect_f.p)[ok],
        rtol=1e-3, atol=1e-3,
    )
    occ_i = accel_api.any_hit(sc_i, o, d, jnp.full((n,), 6.0))
    occ_f = accel_api.any_hit(sc_f, o, d, jnp.full((n,), 6.0))
    np.testing.assert_array_equal(np.asarray(occ_i), np.asarray(occ_f))


def test_sweep_scene_render_matches_dense():
    """End-to-end: a mesh render through the sweep accel matches the
    dense tester (same hits, same radiometry)."""
    from pbrt_tpu.films.rgb import spectrum_to_rgb
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import camera_rays
    from pbrt_tpu.scenes.meshes import mesh_gallery_scene

    scene, camera = mesh_gallery_scene(resolution=(32, 32), subdiv=3)
    sc_sweep = scene.replace(small=None, sweep=None).with_accel(threshold=0)
    sc_dense = scene.replace(small=None, sweep=None)
    integ = PathIntegrator(max_depth=3, rr_start_depth=3)
    nx, ny = camera.resolution
    pixel = jnp.arange(nx * ny, dtype=jnp.int32)
    sample = jnp.zeros_like(pixel)
    o, d, wl = camera_rays(camera, pixel, sample, jnp.int32(0))
    l_s = integ.trace(sc_sweep, o, d, wl, pixel, sample, jnp.int32(0))
    l_c = integ.trace(sc_dense, o, d, wl, pixel, sample, jnp.int32(0))
    rgb_s = np.asarray(spectrum_to_rgb(l_s, wl))
    rgb_c = np.asarray(spectrum_to_rgb(l_c, wl))
    np.testing.assert_allclose(rgb_s, rgb_c, rtol=2e-3, atol=2e-3)

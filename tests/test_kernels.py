"""Triton traversal kernels in interpret mode, the backend dispatch rule,
and the compile-cache location rule.

The kernels are checked against the dense oracle (accel/dense.py) at ray
counts that are not a multiple of the block, with dead lanes, in closest-
and any-hit mode, and (sweep) for an instanced scene.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrt_tpu.accel import api as accel_api
from pbrt_tpu.accel.dense import intersect_any, intersect_closest
from pbrt_tpu.ops import smallscene as small_mod
from pbrt_tpu.ops import sweep as sweep_mod
from pbrt_tpu.scenes.meshes import icosphere, torus
from pbrt_tpu.shapes.geometry import GeometryBuffers


def _random_rays(n, seed, spread=2.5):
    r = np.random.default_rng(seed)
    o = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _tmax(n, seed, finite, dead=0):
    r = np.random.default_rng(seed)
    t = (r.uniform(0.2, 3.0, n) if finite else np.full(n, np.inf))
    t = t.astype(np.float32)
    t[:dead] = 0.0  # dead lanes must stay misses
    return jnp.asarray(t)


def _check_closest(res, ref, tmax, mat=None, light=None):
    hit = np.asarray(ref.valid) & (np.asarray(ref.t) < np.asarray(tmax))
    np.testing.assert_array_equal(np.asarray(res["prim"] >= 0), hit)
    np.testing.assert_allclose(
        np.asarray(res["t"])[hit], np.asarray(ref.t)[hit], rtol=1e-4
    )
    same = (np.asarray(res["prim"]) == np.asarray(ref.prim))[hit]
    assert same.mean() > 0.995
    if mat is not None:
        np.testing.assert_array_equal(
            np.asarray(mat)[hit][same], np.asarray(ref.mat)[hit][same]
        )
        np.testing.assert_array_equal(
            np.asarray(light)[hit][same], np.asarray(ref.light)[hit][same]
        )


def _soup(n_tris, seed=0):
    r = np.random.default_rng(seed)
    c = r.uniform(-1.5, 1.5, (n_tris, 1, 3))
    tris = (c + r.normal(scale=0.35, size=(n_tris, 3, 3))).astype(np.float32)
    mat = r.integers(0, 4, n_tris).astype(np.int32)
    light = np.where(r.uniform(size=n_tris) < 0.1,
                     r.integers(0, 3, n_tris), -1).astype(np.int32)
    return tris, mat, light


# ---- brute-force kernel ------------------------------------------------


@pytest.mark.parametrize(
    "n_tris,n_rays,dead,block",
    [
        (36, 1000, 0, 256),  # unrolled walk, ragged last block
        (36, 512, 100, 128),  # dead lanes, exact blocks
        (300, 777, 50, 256),  # fori_loop walk
    ],
)
def test_smallscene_closest_matches_dense(n_tris, n_rays, dead, block):
    tris, mat, light = _soup(n_tris, seed=n_tris)
    geom = GeometryBuffers.build(tri_verts=tris, tri_mat=mat, tri_light=light)
    acc = small_mod.build_smallscene(tris, mat, light)
    o, d = _random_rays(n_rays, 1)
    tmax = _tmax(n_rays, 2, finite=False, dead=dead)
    ref = intersect_closest(geom, o, d)
    res = small_mod.smallscene_intersect(
        acc, o, d, tmax, interpret=True, block=block
    )
    _check_closest(res, ref, tmax, res["mat"], res["light"])
    # Hit normals are the unit geometric normals of the hit triangles.
    hit = np.asarray(res["prim"]) >= 0
    nrm = np.linalg.norm(np.asarray(res["n"])[hit], axis=-1)
    np.testing.assert_allclose(nrm, 1.0, atol=1e-5)


@pytest.mark.parametrize("n_tris,n_rays", [(36, 1000), (300, 600)])
def test_smallscene_any_matches_dense(n_tris, n_rays):
    tris, _, _ = _soup(n_tris, seed=7)
    geom = GeometryBuffers.build(tri_verts=tris)
    acc = small_mod.build_smallscene(tris)
    o, d = _random_rays(n_rays, 3)
    tmax = _tmax(n_rays, 4, finite=True, dead=60)
    ref = intersect_any(geom, o, d, tmax)
    res = small_mod.smallscene_intersect(
        acc, o, d, tmax, any_hit=True, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(res["prim"] >= 0),
                                  np.asarray(ref))


# ---- sweep kernel ------------------------------------------------------


@pytest.mark.parametrize(
    "n_rays,dead,tile,tri_chunk",
    [
        (1000, 0, 128, 32),  # ragged last tile
        (1536, 300, 64, 16),  # dead lanes, smaller tile and chunk
        (700, 40, 128, 128),  # one chunk per cluster
    ],
)
def test_sweep_kernel_closest_matches_dense(n_rays, dead, tile, tri_chunk):
    tris = np.concatenate(
        [icosphere(2, 0.8, (0, 0, 0)), torus(1.4, 0.3, 24, 12)]
    )
    geom = GeometryBuffers.build(tri_verts=tris)
    acc = sweep_mod.build_sweep(tris)
    o, d = _random_rays(n_rays, 5)
    tmax = _tmax(n_rays, 6, finite=False, dead=dead)
    ref = intersect_closest(geom, o, d)
    res = sweep_mod.sweep_intersect(
        acc, o, d, tmax, interpret=True, tile=tile, tri_chunk=tri_chunk
    )
    _check_closest(res, ref, tmax)


@pytest.mark.parametrize("tile,tri_chunk", [(128, 32), (64, 64)])
def test_sweep_kernel_any_matches_dense(tile, tri_chunk):
    tris = np.concatenate(
        [icosphere(2, 0.8, (0, 0, 0)), torus(1.4, 0.3, 24, 12)]
    )
    geom = GeometryBuffers.build(tri_verts=tris)
    acc = sweep_mod.build_sweep(tris)
    n = 900
    o, d = _random_rays(n, 8)
    tmax = _tmax(n, 9, finite=True, dead=100)
    ref = intersect_any(geom, o, d, tmax)
    res = sweep_mod.sweep_intersect(
        acc, o, d, tmax, any_hit=True, interpret=True, tile=tile,
        tri_chunk=tri_chunk,
    )
    np.testing.assert_array_equal(np.asarray(res["prim"] >= 0),
                                  np.asarray(ref))


@pytest.mark.parametrize("any_hit", [False, True])
def test_sweep_kernel_instanced_matches_dense(any_hit):
    """Instanced sweep against the dense oracle over the flattened world
    triangles (non-uniform scales, ragged ray count)."""
    proto = icosphere(1, 1.0)
    rng = np.random.default_rng(11)
    n_inst = 6
    o2w = np.tile(np.eye(4, dtype=np.float32), (n_inst, 1, 1))
    flat = []
    for i in range(n_inst):
        m = np.diag(rng.uniform(0.5, 1.5, 3)).astype(np.float32)
        o2w[i, :3, :3] = m
        o2w[i, :3, 3] = rng.uniform(-4, 4, 3)
        flat.append(proto @ m.T + o2w[i, :3, 3])
    flat = np.concatenate(flat).astype(np.float32)
    acc = sweep_mod.build_sweep(
        proto, proto_ranges=[(0, len(proto))],
        instances=(np.zeros(n_inst, np.int32), o2w),
    )
    geom = GeometryBuffers.build(tri_verts=flat)
    n = 999
    o, d = _random_rays(n, 12, spread=6.0)
    tmax = _tmax(n, 13, finite=any_hit, dead=30)
    res = sweep_mod.sweep_intersect(
        acc, o, d, tmax, any_hit=any_hit, interpret=True
    )
    if any_hit:
        ref = intersect_any(geom, o, d, tmax)
        np.testing.assert_array_equal(np.asarray(res["prim"] >= 0),
                                      np.asarray(ref))
        return
    ref = intersect_closest(geom, o, d)
    hit = np.asarray(ref.valid) & (np.asarray(tmax) > 0)
    np.testing.assert_array_equal(np.asarray(res["prim"] >= 0), hit)
    np.testing.assert_allclose(
        np.asarray(res["t"])[hit], np.asarray(ref.t)[hit], rtol=1e-4
    )
    flat_prim = np.asarray(res["inst"]) * len(proto) + np.asarray(res["prim"])
    assert (flat_prim == np.asarray(ref.prim))[hit].mean() > 0.995


# ---- dispatch ----------------------------------------------------------


def _scene(tris):
    from pbrt_tpu.lights.buffers import LightBuffers
    from pbrt_tpu.materials.buffers import MAT_DIFFUSE, MaterialBuffers
    from pbrt_tpu.scene import Scene

    geom = GeometryBuffers.build(
        tri_verts=tris, tri_mat=np.zeros(len(tris), np.int32)
    )
    mats = MaterialBuffers.build([{"kind": MAT_DIFFUSE, "albedo": (0.5,) * 3}])
    lights = LightBuffers.build(
        points=[{"p": (0, 0, 3), "rgb": (1, 1, 1), "scale": 1.0}]
    )
    return Scene(geom=geom, materials=mats, lights=lights)


def test_dispatch_rule_cpu_interprets():
    assert jax.default_backend() == "cpu"
    assert accel_api.kernels_compiled() is False


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_dispatch_rule_other_backend_raises(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(NotImplementedError):
        accel_api.kernels_compiled()
    sc = _scene(icosphere(1, 1.0)).with_accel()
    o, d = _random_rays(64, 0)
    with pytest.raises(NotImplementedError):
        accel_api.closest(sc, o, d)


def test_dispatch_gpu_runs_compiled_kernels(monkeypatch):
    """With the backend stubbed as the GPU, small scenes call the brute
    force kernel and large ones the sweep kernel, neither in interpret
    mode; on the CPU small scenes go to the dense tester."""
    calls = []

    def fake_small(accel, o, d, tmax, any_hit=False, interpret=False):
        calls.append(("small", any_hit, interpret))
        return small_mod._smallscene_intersect_impl(
            accel, o, d, tmax, any_hit=any_hit, interpret=True
        )

    def fake_sweep(accel, o, d, tmax, any_hit=False, interpret=False):
        calls.append(("sweep", any_hit, interpret))
        return sweep_mod._sweep_intersect_impl(
            accel, o, d, tmax, any_hit=any_hit, interpret=True
        )

    monkeypatch.setattr(small_mod, "smallscene_intersect", fake_small)
    monkeypatch.setattr(sweep_mod, "sweep_intersect", fake_sweep)
    small = _scene(icosphere(1, 1.0)).with_accel()
    big = _scene(icosphere(1, 1.0)).with_accel(threshold=0)
    assert small.small is not None and big.sweep is not None
    o, d = _random_rays(256, 1)
    tmax = jnp.full((256,), 2.0)

    accel_api.closest(small, o, d)
    accel_api.any_hit(small, o, d, tmax)
    assert calls == []  # CPU: dense tester, sweep not attached

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    isect = accel_api.closest(small, o, d)
    accel_api.any_hit(small, o, d, tmax)
    accel_api.closest(big, o, d)
    accel_api.any_hit(big, o, d, tmax)
    assert calls == [("small", False, False), ("small", True, False),
                     ("sweep", False, False), ("sweep", True, False)]
    assert np.asarray(isect.valid).any()


def test_with_accel_threshold_and_kinds():
    tris = icosphere(1, 1.0)  # 80 triangles
    sc = _scene(tris)
    assert sc.with_accel().small is not None
    assert sc.with_accel(threshold=80).small is not None
    assert sc.with_accel(threshold=79).sweep is not None
    assert sc.with_accel(threshold=0).small is None
    empty = sc.replace(geom=GeometryBuffers.build(
        spheres=np.array([[0.0, 0.0, 0.0, 1.0]], np.float32),
        sph_mat=np.zeros(1, np.int32)))
    assert empty.with_accel() is empty


# ---- compile cache -----------------------------------------------------


def test_compile_cache_dir_rule(monkeypatch, tmp_path):
    from pbrt_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    root = compile_cache.CHECKOUT
    assert compile_cache.cache_dir() == f"{root}/.jax_cache"
    assert compile_cache.cache_dir(".jax_cache_tests") == \
        f"{root}/.jax_cache_tests"
    import os

    assert os.path.isdir(os.path.join(root, "pbrt_tpu"))

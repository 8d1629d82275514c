"""Agreement of the traversal kernels with the dense reference.

The kernels (ops/smallscene.py, ops/sweep.py) are reached through the
accelerator dispatch (accel/api.py closest / any_hit) and compared with the
plain watertight tester of accel/dense.py on the same rays. The kernels use
Moller-Trumbore, so rays that graze a shared edge may hit on one side and
not the other: the gates below leave room for such edge ties and nothing
else.

Used by chip_smoke.py and tests/test_gpu.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Float32 throughout (no matrix products, so TF32 never enters).
MASK_AGREE = 0.9999  # hit masks agree on this share of rays
T_RTOL = 1e-4  # t where both hit the same triangle ...
T_ATOL = 1e-6  # ... plus float32 rounding for hits close to the origin
T_AGREE = 0.9999  # share of both-hit rays whose t agrees to T_RTOL
PRIM_AGREE = 0.995  # share of hits on the same triangle


def soup(n_tris: int, seed: int = 0, n_mat: int = 4, n_light: int = 3):
    """Seeded triangle soup in [-1.5, 1.5]^3 with material and light ids."""
    r = np.random.default_rng(seed)
    c = r.uniform(-1.5, 1.5, (n_tris, 1, 3))
    tris = (c + r.normal(scale=0.3, size=(n_tris, 3, 3))).astype(np.float32)
    mat = r.integers(0, n_mat, n_tris).astype(np.int32)
    light = np.where(r.uniform(size=n_tris) < 0.1,
                     r.integers(0, n_light, n_tris), -1).astype(np.int32)
    return tris, mat, light


def look_rays(n: int, eye, target_lo, target_hi, seed: int = 0):
    """Camera-like rays: one origin, directions to seeded targets."""
    r = np.random.default_rng(seed)
    tgt = r.uniform(target_lo, target_hi, (n, 3)).astype(np.float32)
    o = np.broadcast_to(np.asarray(eye, np.float32), (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d.astype(np.float32))


def dense_closest(geom, o, d, tmax, chunk: int):
    """The dense oracle in ray chunks (its (rays, block) intermediates
    would not fit at full width)."""
    from ..accel import dense

    f = jax.jit(lambda o, d, t: dense.intersect_closest(geom, o, d, t))
    outs = [f(o[i:i + chunk], d[i:i + chunk], tmax[i:i + chunk])
            for i in range(0, o.shape[0], chunk)]
    return {
        k: np.concatenate([np.asarray(getattr(x, k)) for x in outs])
        for k in ("valid", "t", "prim", "mat", "light", "n")
    }


def dense_any(geom, o, d, tmax, chunk: int):
    from ..accel import dense

    f = jax.jit(lambda o, d, t: dense.intersect_any(geom, o, d, t))
    return np.concatenate([
        np.asarray(f(o[i:i + chunk], d[i:i + chunk], tmax[i:i + chunk]))
        for i in range(0, o.shape[0], chunk)
    ])


def bounce_rays(ref, o, d, seed: int = 0, shadow: bool = False):
    """Cosine-weighted bounce rays from the reference's closest hits.

    Rays that missed become dead lanes (tmax = 0). shadow=True gives each
    live ray a seeded finite tmax instead of inf, for any-hit queries.
    """
    r = np.random.default_rng(seed)
    o = np.asarray(o)
    d = np.asarray(d)
    valid = ref["valid"]
    t = np.where(valid, ref["t"], 0.0)
    n = ref["n"]
    n = np.where((np.sum(n * d, axis=1) > 0)[:, None], -n, n)
    p = o + t[:, None] * d
    # Cosine-weighted hemisphere about n.
    u1, u2 = r.uniform(size=(2, o.shape[0]))
    rad = np.sqrt(u1)
    phi = 2 * np.pi * u2
    local = np.stack(
        [rad * np.cos(phi), rad * np.sin(phi), np.sqrt(1 - u1)], axis=1
    )
    a = np.where(np.abs(n[:, :1]) > 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    t1 = np.cross(n, a)
    t1 /= np.maximum(np.linalg.norm(t1, axis=1, keepdims=True), 1e-12)
    t2 = np.cross(n, t1)
    d2 = local[:, :1] * t1 + local[:, 1:2] * t2 + local[:, 2:] * n
    d2 /= np.maximum(np.linalg.norm(d2, axis=1, keepdims=True), 1e-12)
    o2 = p + 1e-4 * np.maximum(1.0, np.abs(p).max(axis=1, keepdims=True)) * n
    if shadow:
        tmax = r.uniform(0.05, 3.0, o.shape[0])
    else:
        tmax = np.full(o.shape[0], np.inf)
    tmax = np.where(valid, tmax, 0.0)
    o2 = np.where(valid[:, None], o2, 0.0)
    d2 = np.where(valid[:, None], d2, np.asarray([[0.0, 0.0, 1.0]]))
    return (jnp.asarray(o2.astype(np.float32)),
            jnp.asarray(d2.astype(np.float32)),
            jnp.asarray(tmax.astype(np.float32)))


def compare_closest(isect, ref) -> dict:
    """Gate a kernel Interaction against the dense reference dict.

    Returns the measured shares; raises AssertionError when a gate fails.
    """
    valid = np.asarray(isect.valid)
    prim = np.asarray(isect.prim)
    t = np.asarray(isect.t)
    rv = ref["valid"]
    both = valid & rv
    same = both & (prim == ref["prim"])
    t_ok = np.isclose(t, ref["t"], rtol=T_RTOL, atol=T_ATOL)
    stats = {
        "rays": int(valid.size),
        "hits": int(rv.sum()),
        "mask_agree": float(np.mean(valid == rv)),
        "t_agree": float(t_ok[both].mean()) if both.any() else 1.0,
        "prim_agree": float(same.sum() / max(both.sum(), 1)),
    }
    assert stats["hits"] > 0, "no reference hits: the rays miss the scene"
    assert stats["mask_agree"] >= MASK_AGREE, stats
    assert stats["t_agree"] >= T_AGREE, stats
    bad = same & ~t_ok
    assert not bad.any(), (
        "t disagrees on the same triangle", int(bad.sum()),
        t[bad][:4], ref["t"][bad][:4],
    )
    assert stats["prim_agree"] >= PRIM_AGREE, stats
    mat = np.asarray(isect.mat)
    light = np.asarray(isect.light)
    assert (mat[same] == ref["mat"][same]).all(), "mat disagrees"
    assert (light[same] == ref["light"][same]).all(), "light disagrees"
    return stats


def compare_any(occ, ref_occ, live) -> dict:
    occ = np.asarray(occ)
    live = np.asarray(live)
    stats = {
        "rays": int(occ.size),
        "occluded": int(ref_occ.sum()),
        "mask_agree": float(np.mean(occ == ref_occ)),
    }
    assert stats["occluded"] > 0, "no reference occlusions"
    assert not occ[~live].any(), "a dead lane reported a hit"
    assert stats["mask_agree"] >= MASK_AGREE, stats
    return stats


def instanced_pbrt(n_inst: int, seed: int = 0, flatten: bool = False,
                   subdiv: int = 1, res: int = 64) -> str:
    """A seeded scene of `n_inst` icosphere instances on a jittered grid.

    flatten=False writes one ObjectBegin prototype and `n_inst`
    ObjectInstance uses; flatten=True writes the same triangles as one
    world-space Shape per instance, which the parser does not instance.
    """
    from ..scenes.meshes import icosphere

    proto = icosphere(subdiv, 1.0).reshape(-1, 3)
    pts = " ".join(f"{x:.6f}" for x in proto.ravel())
    idx = " ".join(str(i) for i in range(len(proto)))
    mesh = f'Shape "trianglemesh" "point3 P" [{pts}] "integer indices" [{idx}]'
    r = np.random.default_rng(seed)
    side = int(np.ceil(n_inst ** (1 / 3)))
    lines = [
        "LookAt 0 0 -60  0 0 0  0 1 0",
        'Camera "perspective" "float fov" [40]',
        f'Film "rgb" "integer xresolution" [{res}] '
        f'"integer yresolution" [{res}]',
        "WorldBegin",
        'LightSource "point" "point3 from" [0 40 -40] "rgb I" [900 900 900]',
        'Material "diffuse"',
    ]
    if not flatten:
        lines += ['ObjectBegin "ico"', mesh, "ObjectEnd"]
    for i in range(n_inst):
        g = np.array([i % side, (i // side) % side, i // side ** 2])
        t = (g - (side - 1) / 2) * 3.0 + r.uniform(-0.5, 0.5, 3)
        ang = r.uniform(0, 360)
        ax = r.normal(size=3)
        ax /= np.linalg.norm(ax)
        sc = r.uniform(0.5, 1.2, 3)
        lines += [
            "AttributeBegin",
            f"Translate {t[0]:.5f} {t[1]:.5f} {t[2]:.5f}",
            f"Rotate {ang:.4f} {ax[0]:.5f} {ax[1]:.5f} {ax[2]:.5f}",
            f"Scale {sc[0]:.5f} {sc[1]:.5f} {sc[2]:.5f}",
            mesh if flatten else 'ObjectInstance "ico"',
            "AttributeEnd",
        ]
    return "\n".join(lines) + "\n"


def _jit_run(name, fn, *args):
    return jax.block_until_ready(jax.jit(fn)(*args))


def check_accel(label, scene, ref_geom, rays, chunk, ref_prim=None,
                run=_jit_run, log=print):
    """Closest and any-hit, camera and bounce rays, through the scene's
    accelerator (a compiled kernel on the GPU) against the dense oracle on
    `ref_geom`. ref_prim maps reference prim ids to the scene's;
    run(name, fn, *args) executes a query."""
    from ..accel import api

    o, d = rays
    n = o.shape[0]
    inf = jnp.full((n,), jnp.inf, jnp.float32)
    ref = dense_closest(ref_geom, o, d, inf, chunk)
    bounce = bounce_rays(ref, o, d, seed=1)
    shadow = bounce_rays(ref, o, d, seed=2, shadow=True)
    rng = np.random.default_rng(3)
    cam_tmax = jnp.asarray(
        np.where(ref["valid"], ref["t"], 10.0)
        * rng.uniform(0.5, 1.5, n).astype(np.float32)
    )

    def closest(o, d, t):
        return api.closest(scene, o, d, t)

    def any_hit(o, d, t):
        return api.any_hit(scene, o, d, t)

    for kind, (o_, d_, t_) in (("camera", (o, d, inf)), ("bounce", bounce)):
        ref_ = ref if kind == "camera" else dense_closest(
            ref_geom, o_, d_, t_, chunk)
        if ref_prim is not None:
            ref_ = dict(ref_, prim=ref_prim(ref_["prim"], ref_["valid"]))
        isect = run(f"{label} closest {kind}", closest, o_, d_, t_)
        log(f"   {label} closest {kind}: {compare_closest(isect, ref_)}")
    for kind, (o_, d_, t_) in (("camera", (o, d, cam_tmax)),
                               ("bounce", shadow)):
        ref_occ = dense_any(ref_geom, o_, d_, t_, chunk)
        occ = run(f"{label} any {kind}", any_hit, o_, d_, t_)
        log(f"   {label} any {kind}: "
            f"{compare_any(occ, ref_occ, np.asarray(t_) > 0)}")

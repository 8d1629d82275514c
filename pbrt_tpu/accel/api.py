"""Acceleration dispatch: dense brute force, Pallas kernels, or jnp trees.

The scene carries at most one triangle accelerator: `small` (the Pallas
brute-force kernel, ops/smallscene.py), `sweep` (per-tile candidate culling
plus the Pallas sweep kernel, ops/sweep.py — the only instancing path),
`bvh` (the jnp implicit-tree traversal, accel/bvh.py) or `kdtree`
(accel/kdtree.py). Without one, triangles go to the dense tester
(accel/dense.py), which is also the oracle the others are tested against.
Spheres and the other analytic families are always tested densely (scenes
have few analytic quadrics). Mirrors the reference's Primitive aggregate
dispatch (cpu/primitive.h) without the polymorphism.

Which backend runs the Pallas kernels is one rule (`kernels_compiled`):
the GPU runs them compiled through Triton; the CPU runs the sweep kernel in
interpret mode and answers small scenes with the dense tester; any other
backend raises.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.gather import gather_rows
from ..core.vecmath import normalize
from ..shapes.geometry import Interaction
from . import dense
from .bvh import bvh_intersect

_INF = jnp.inf


def kernels_compiled() -> bool:
    """True where the Pallas kernels run compiled (the GPU), False where
    they run in interpret mode (the CPU). Any other backend has no
    kernels and raises rather than fall back."""
    backend = jax.default_backend()
    if backend == "gpu":
        return True
    if backend == "cpu":
        return False
    raise NotImplementedError(
        f"no traversal kernels for the {backend!r} backend (gpu or cpu)"
    )


def _spread8(x):
    x = (x | (x << 8)) & 0x00F00F
    x = (x | (x << 4)) & 0x0C30C3
    x = (x | (x << 2)) & 0x249249
    return x


def _spread5(x):
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


@jax.named_scope("accel/ray_sort")
def ray_sort_perm(o, d, tmax=None):
    """Coherence permutation for the sweep kernel's per-tile candidate cull.

    The sweep kernel (ops/sweep.py) culls cluster entries per ray tile, so
    a tile's bundle of origins and directions decides the work. In raster
    order a tile is a strip of image rows, and on bounce 2+ rays are fully
    incoherent. Sorting by a fine origin Morton code, then by a 16-bit
    Morton-interleaved octahedral direction, makes tiles compact beams.
    Reference analogue: wavefront ray sorting for traversal coherence.
    """
    an = jnp.sum(jnp.abs(d), axis=-1, keepdims=True)
    p = d[:, :2] / jnp.maximum(an, 1e-20)
    neg = d[:, 2] < 0
    px = jnp.where(neg, (1 - jnp.abs(p[:, 1])) * jnp.sign(p[:, 0]), p[:, 0])
    py = jnp.where(neg, (1 - jnp.abs(p[:, 0])) * jnp.sign(p[:, 1]), p[:, 1])
    qx = jnp.clip(((px + 1) * 127.5).astype(jnp.int32), 0, 255)
    qy = jnp.clip(((py + 1) * 127.5).astype(jnp.int32), 0, 255)
    dcode = (_spread8(qx) | (_spread8(qy) << 1)).astype(jnp.uint32)  # 16 b
    lo = jnp.min(o, axis=0)
    hi = jnp.max(o, axis=0)
    q8 = jnp.clip(
        ((o - lo) / jnp.maximum(hi - lo, 1e-6) * 255).astype(jnp.int32),
        0, 255,
    )
    ocode = (
        _spread8(q8[:, 0]) | (_spread8(q8[:, 1]) << 1)
        | (_spread8(q8[:, 2]) << 2)
    ).astype(jnp.uint32)  # 24 bits (256^3 cells)
    # Two-key lexicographic sort: fine origin Morton major (24 bits), full
    # direction Morton minor. One 32-bit key cannot hold both at full
    # precision; two stable argsorts give the exact lexicographic order.
    if tmax is not None:
        # Dead lanes (tmax <= 0) sort into their own tiles, which get no
        # candidates — the tile-level form of wavefront dead-lane
        # compaction: masked-out rays stop charging the traversal kernel.
        ocode = ocode | jnp.where(
            tmax <= 0.0, jnp.uint32(1) << 30, jnp.uint32(0)
        )
    perm1 = jnp.argsort(dcode, stable=True)
    perm = perm1[jnp.argsort(ocode[perm1], stable=True)]
    inv = jnp.argsort(perm)
    return perm, inv


@jax.named_scope("accel/resolve_attrs_inst")
def resolve_tri_attrs_inst(geom, sweep_accel, o, d, prim, inst):
    """Instance-aware attribute resolution for the sweep accelerator.

    geom.tri_verts holds prototype triangles in OBJECT space; the hit
    instance's object-to-world affine (sweep_accel.o2w, rows of the 3x4
    matrix) lifts the triangle to world space, then Moller-Trumbore
    re-evaluation against the world ray yields u/v and the geometric
    normal (computed from world-space edges, so non-uniform instance
    scales shade correctly). Reference analogue: TransformedPrimitive::
    Intersect's interaction re-mapping (cpu/primitive.cpp:94-124)."""
    n_tri = geom.num_triangles
    tri_idx = jnp.clip(jnp.maximum(prim, 0), 0, max(n_tri - 1, 0))
    tv = jnp.asarray(geom.tri_verts)[tri_idx]  # (N, 3, 3) object space
    rows = jnp.asarray(sweep_accel.o2w)[
        jnp.clip(jnp.maximum(inst, 0), 0, sweep_accel.o2w.shape[0] - 1)
    ]  # (N, 12)
    m = rows.reshape(-1, 3, 4)
    tv = jnp.einsum(
        "nij,nkj->nki", m[:, :, :3], tv, precision=jax.lax.Precision.HIGHEST
    ) + m[:, None, :, 3]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    ng = normalize(jnp.cross(e1, e2))
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - tv[:, 0]
    u = jnp.sum(tvec * pvec, axis=-1) * inv
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv
    mat = jnp.asarray(geom.tri_mat)[tri_idx]
    light = jnp.asarray(geom.tri_light)[tri_idx]
    return u, v, ng, mat, light


@jax.named_scope("accel/resolve_attrs")
def resolve_tri_attrs(geom, o, d, prim):
    """Batched post-traversal attribute resolution for triangle hits.

    The sweep kernel returns only (t, prim); the hit triangle's row is
    gathered and u/v/normal re-evaluated here in one batched pass. Mirrors
    the reference's split between OptiX traversal results and
    SurfaceInteraction construction (gpu/optix.cu __closesthit__ ->
    intersect.h EnqueueWorkAfterIntersection).
    """
    n_tri = geom.num_triangles
    tri_idx = jnp.clip(jnp.maximum(prim, 0), 0, max(n_tri - 1, 0))
    tv = jnp.asarray(geom.tri_verts)[tri_idx]  # (N, 3, 3) native gather
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    ng = normalize(jnp.cross(e1, e2))
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - tv[:, 0]
    u = jnp.sum(tvec * pvec, axis=-1) * inv
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv
    mat = jnp.asarray(geom.tri_mat)[tri_idx]
    light = jnp.asarray(geom.tri_light)[tri_idx]
    return u, v, ng, mat, light


def interp_tri_uv(geom, prim, u, v):
    """Map barycentric (u, v) to the mesh's declared texture coordinates
    (util/mesh.h TriangleMesh uv; triangle.cpp InterpolateUV). The default
    per-triangle uv table is the identity map, so meshes without "point2
    uv" keep raw barycentrics. Non-triangle prims pass through."""
    n_tri = geom.num_triangles
    if n_tri == 0:
        return u, v
    is_tri = (prim >= 0) & (prim < n_tri)
    safe = jnp.clip(jnp.maximum(prim, 0), 0, n_tri - 1)
    uvt = jnp.asarray(geom.tri_uv)[safe]  # (N, 3, 2)
    w0 = (1.0 - u - v)[:, None]
    uvm = w0 * uvt[:, 0] + u[:, None] * uvt[:, 1] + v[:, None] * uvt[:, 2]
    return (
        jnp.where(is_tri, uvm[:, 0], u),
        jnp.where(is_tri, uvm[:, 1], v),
    )


def _sphere_best(geom, o, d, tmax):
    """Best sphere hit: (t, idx) with idx -1 on miss."""
    sblk, _ = dense._sph_soa(geom.sph)
    t_s = dense._intersect_sph_block(o, d, tmax, sblk)
    t_s = jnp.where(
        jnp.arange(t_s.shape[1])[None, :] < geom.num_spheres, t_s, _INF
    )
    arg = jnp.argmin(t_s, axis=1).astype(jnp.int32)
    t = jnp.min(t_s, axis=1)
    return jnp.where(jnp.isfinite(t), t, _INF), jnp.where(
        jnp.isfinite(t), arg, -1
    )


def _merge_disk_cyl(geom, o, d, isect: Interaction) -> Interaction:
    """Fold analytic disk/cylinder/bilinear-patch hits into a base
    Interaction (the same closest-wins merge the sphere/curve families
    use)."""
    if geom.num_disks == 0 and geom.num_cyls == 0 and geom.num_blps == 0:
        return isect
    t_cur = jnp.where(isect.valid, isect.t, _INF)
    base = geom.num_triangles + geom.num_spheres + geom.num_curves
    upd = isect
    for fam, best in (
        ("disk", dense.disk_best), ("cyl", dense.cyl_best),
        ("blp", dense.blp_best),
    ):
        n_fam = {"disk": geom.num_disks, "cyl": geom.num_cyls,
                 "blp": geom.num_blps}[fam]
        if n_fam == 0:
            continue
        t_f, i_f, u_f, v_f = best(geom, o, d, t_cur)
        better = t_f < t_cur
        if fam == "blp":
            ng = dense.blp_normal(geom, i_f, u_f, v_f)
        else:
            ng = dense.disk_cyl_normals(
                geom, o, d, t_f, jnp.full(t_f.shape, fam == "disk", bool),
                i_f,
            )
        mats = {"disk": geom.disk_mat, "cyl": geom.cyl_mat,
                "blp": geom.blp_mat}[fam]
        safe = jnp.clip(jnp.maximum(i_f, 0), 0, n_fam - 1)
        mat_f = gather_rows(mats, safe)
        p_new = o + t_f[:, None] * d
        upd = Interaction(
            valid=upd.valid | better,
            p=jnp.where(better[:, None], p_new, upd.p),
            n=jnp.where(better[:, None], ng, upd.n),
            t=jnp.where(better, t_f, upd.t),
            uv=jnp.where(
                better[:, None], jnp.stack([u_f, v_f], -1), upd.uv
            ),
            wo=upd.wo,
            mat=jnp.where(better, mat_f, upd.mat),
            light=jnp.where(better, -1, upd.light),
            prim=jnp.where(better, base + i_f, upd.prim),
            dpdu=jnp.where(better[:, None], jnp.zeros_like(upd.dpdu),
                           upd.dpdu),
        )
        t_cur = jnp.where(upd.valid, upd.t, _INF)
        base = base + n_fam
    return upd


def _tri_closest_once(scene, o, d, tmax):
    """One triangle-family closest-hit query via the scene's accelerator
    (sweep / smallscene / dense oracle). Returns a dict with t (inf =
    miss), prim (-1 = miss), u, v, ng, mat, light."""
    geom = scene.geom
    small = getattr(scene, "small", None)
    sweep = getattr(scene, "sweep", None)
    if sweep is not None:
        from ..ops.sweep import sweep_intersect

        interp = not kernels_compiled()
        perm, invp = ray_sort_perm(o, d, tmax)
        res = sweep_intersect(
            sweep, o[perm], d[perm], tmax[perm], any_hit=False,
            interpret=interp,
        )
        t, prim, inst = res["t"][invp], res["prim"][invp], res["inst"][invp]
        if sweep.instanced:
            u, v, ng, mat, light = resolve_tri_attrs_inst(
                geom, sweep, o, d, prim, inst
            )
        else:
            u, v, ng, mat, light = resolve_tri_attrs(geom, o, d, prim)
    elif small is not None and kernels_compiled():
        from ..ops.smallscene import smallscene_intersect

        res = smallscene_intersect(small, o, d, tmax, any_hit=False)
        t, prim = res["t"], res["prim"]
        u, v, ng = res["u"], res["v"], res["n"]
        mat, light = res["mat"], res["light"]
    elif geom.num_triangles > 0 and getattr(scene, "anim", None) is None:
        t, prim, u, v = dense.intersect_closest_tri(geom, o, d, tmax)
        u, v, ng, mat, light0 = resolve_tri_attrs(geom, o, d, prim)
        light = light0
    else:
        # Animated-instances-only scene (prototypes are object space and
        # must not be intersected directly), or no triangles at all.
        n_rays = o.shape[0]
        t = jnp.full((n_rays,), _INF, o.dtype)
        prim = jnp.full((n_rays,), -1, jnp.int32)
        u = jnp.zeros((n_rays,), o.dtype)
        v = jnp.zeros((n_rays,), o.dtype)
        ng = jnp.zeros((n_rays, 3), o.dtype)
        mat = jnp.zeros((n_rays,), jnp.int32)
        light = jnp.full((n_rays,), -1, jnp.int32)
    return {"t": t, "prim": prim, "u": u, "v": v, "ng": ng,
            "mat": mat, "light": light}


_ALPHA_ROUNDS = 4


def _alpha_at(scene, o, d, res):
    """Alpha of each hit: per-triangle constant x alpha texture at the
    hit uv (GeometricPrimitive alpha, cpu/primitive.h:59-63)."""
    geom = scene.geom
    prim_s = jnp.clip(
        jnp.maximum(res["prim"], 0), 0, max(geom.num_triangles - 1, 0)
    )
    base = jnp.asarray(geom.tri_alpha)[prim_s]
    texid = jnp.asarray(geom.tri_alpha_tex)[prim_s]
    tex = getattr(scene, "textures", None)
    if tex is None:
        return base
    from ..textures.buffers import evaluate_float

    um, vm = interp_tri_uv(scene.geom, res["prim"], res["u"], res["v"])
    uv = jnp.stack([um, vm], axis=-1)
    p_hit = o + res["t"][:, None] * d
    p_hit = jnp.where(jnp.isfinite(p_hit), p_hit, 0.0)
    a = evaluate_float(tex, texid, uv, p_hit, jnp.ones_like(base))
    return base * a


def _alpha_rand(o, d, k):
    """Deterministic per-ray uniform for the stochastic alpha test —
    hashed from the ray itself like the reference's HashFloat(o, d)
    (BasicTextureEvaluator alpha; gpu any-hit)."""
    from ..core.rng import pcg4d

    def b(x):
        return jax.lax.bitcast_convert_type(x, jnp.uint32)

    h0, _, _, _ = pcg4d(
        b(o[:, 0]) ^ b(d[:, 1]),
        b(o[:, 1]) ^ b(d[:, 2]),
        b(o[:, 2]) ^ b(d[:, 0]),
        jnp.uint32(k + 1),
    )
    return (h0 >> 8).astype(jnp.float32) * (1.0 / 16777216.0)


def _tri_closest(scene, o, d, tmax):
    """Triangle closest hit with the alpha-mask restart loop: alpha-cut
    hits (alpha == 0, or stochastic alpha test failure) are skipped by
    re-tracing from just past the hit, up to _ALPHA_ROUNDS surfaces
    (rays still cut after that accept the hit — bounded bias, opaque
    scenes compile the single-query path via the static has_alpha flag).
    Matches the reference's any-hit alpha programs
    (gpu/optix.cu __anyhit__, cpu GeometricPrimitive::Intersect)."""
    res = _tri_closest_once(scene, o, d, tmax)
    if not scene.geom.has_alpha:
        return res
    s = jnp.zeros_like(res["t"])
    # Only hits not yet alpha-tested are candidates: a hit that SURVIVES
    # its stochastic test is final (re-testing every round would cut
    # surviving hits with probability 1-alpha^K).
    pending = jnp.ones(res["t"].shape, bool)
    for k in range(_ALPHA_ROUNDS - 1):
        with jax.named_scope(f"accel/alpha_restart{k}"):
            a = _alpha_at(scene, o, d, res)
            hit = res["prim"] >= 0
            u01 = _alpha_rand(o, d, k)
            cut = pending & hit & (a < 1.0) & ((a <= 0.0) | (u01 > a))
            pending = cut
            eps = 1e-4 * jnp.maximum(1.0, jnp.abs(res["t"]))
            s_new = jnp.where(cut, res["t"] + eps, s)
            o_shift = o + s_new[:, None] * d
            tq = jnp.where(cut, tmax - s_new, 0.0)
            r2 = _tri_closest_once(scene, o_shift, d, tq)
            t2 = r2["t"] + s_new
            res = {
                "t": jnp.where(cut, t2, res["t"]),
                "prim": jnp.where(cut, r2["prim"], res["prim"]),
                "u": jnp.where(cut, r2["u"], res["u"]),
                "v": jnp.where(cut, r2["v"], res["v"]),
                "ng": jnp.where(cut[:, None], r2["ng"], res["ng"]),
                "mat": jnp.where(cut, r2["mat"], res["mat"]),
                "light": jnp.where(cut, r2["light"], res["light"]),
            }
            s = s_new
    return res


@jax.named_scope("accel/closest")
def closest(scene, o, d, tmax=None, time=None) -> Interaction:
    geom = scene.geom
    small = getattr(scene, "small", None)
    sweep = getattr(scene, "sweep", None)
    anim = getattr(scene, "anim", None)
    if scene.bvh is None and small is None \
            and getattr(scene, "kdtree", None) is None \
            and sweep is None and anim is None and not geom.has_alpha:
        isect = dense.intersect_closest(geom, o, d, tmax)
        u2, v2 = interp_tri_uv(
            geom, isect.prim, isect.uv[:, 0], isect.uv[:, 1]
        )
        isect = isect.replace(uv=jnp.stack([u2, v2], axis=-1))
        return _merge_disk_cyl(geom, o, d, isect)

    n_rays = o.shape[0]
    if tmax is None:
        tmax = jnp.full((n_rays,), _INF, o.dtype)

    if sweep is not None or small is not None or geom.has_alpha \
            or (scene.bvh is None
                and getattr(scene, "kdtree", None) is None):
        res = _tri_closest(scene, o, d, tmax)
        t, prim = res["t"], res["prim"]
        u, v, ng = res["u"], res["v"], res["ng"]
        mat, light = res["mat"], res["light"]
    elif getattr(scene, "kdtree", None) is not None:
        from .kdtree import kdtree_intersect

        t, prim, u, v = kdtree_intersect(scene.kdtree, o, d, tmax)
        t = jnp.where(prim >= 0, t, _INF)
        n_tri = geom.num_triangles
        tri_idx = jnp.clip(jnp.maximum(prim, 0), 0, max(n_tri - 1, 0))
        tv = gather_rows(geom.tri_verts, tri_idx)
        ng = normalize(
            jnp.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        )
        mat = gather_rows(geom.tri_mat, tri_idx)
        light = gather_rows(geom.tri_light, tri_idx)
    else:
        t, prim, u, v = bvh_intersect(scene.bvh, o, d, tmax, any_hit=False)
        t = jnp.where(prim >= 0, t, _INF)
        n_tri = geom.num_triangles
        tri_idx = jnp.clip(jnp.maximum(prim, 0), 0, max(n_tri - 1, 0))
        tv = gather_rows(geom.tri_verts, tri_idx)
        ng = normalize(
            jnp.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        )
        mat = gather_rows(geom.tri_mat, tri_idx)
        light = gather_rows(geom.tri_light, tri_idx)

    if anim is not None:
        from .instances import animated_best

        t_base = jnp.where(prim >= 0, t, _INF)
        t_base = jnp.minimum(t_base, tmax)
        t_a, p_a, u_a, v_a, ng_a, mat_a, light_a = animated_best(
            anim, geom, o, d, t_base, time
        )
        bet = t_a < t_base
        t = jnp.where(bet, t_a, t)
        prim = jnp.where(bet, p_a, prim)
        u = jnp.where(bet, u_a, u)
        v = jnp.where(bet, v_a, v)
        ng = jnp.where(bet[:, None], ng_a, ng)
        mat = jnp.where(bet, mat_a, mat)
        light = jnp.where(bet, light_a, light)

    # Barycentrics -> declared mesh texture coordinates (identity when no
    # "point2 uv" was given). Must precede the analytic-family merges,
    # whose prims carry their own uv conventions.
    u, v = interp_tri_uv(geom, prim, u, v)

    n_sph = geom.num_spheres
    if n_sph > 0:
        t_s, s_idx = _sphere_best(geom, o, d, tmax)
        sph_better = t_s < t
        sph_safe = jnp.clip(jnp.maximum(s_idx, 0), 0, n_sph - 1)
        sc = gather_rows(geom.sph, sph_safe)
        p_s = o + t_s[:, None] * d
        n_s = normalize(p_s - sc[:, :3])
        t = jnp.where(sph_better, t_s, t)
        prim = jnp.where(sph_better, geom.num_triangles + s_idx, prim)
        # Spherical uv (shapes.h Sphere::Intersect): u = phi / 2pi,
        # v = 1 - theta / pi for a full sphere (world-frame axes; pbrt
        # computes these in object space, identical for the
        # translate/uniform-scale transforms the parser's analytic-sphere
        # path accepts).
        phi_s = jnp.arctan2(n_s[:, 1], n_s[:, 0])
        u_s = jnp.where(phi_s < 0, phi_s + 2 * jnp.pi, phi_s) / (2 * jnp.pi)
        v_s = 1.0 - jnp.arccos(jnp.clip(n_s[:, 2], -1.0, 1.0)) / jnp.pi
        u = jnp.where(sph_better, u_s, u)
        v = jnp.where(sph_better, v_s, v)
        ng = jnp.where(sph_better[:, None], n_s, ng)
        mat = jnp.where(sph_better, gather_rows(geom.sph_mat, sph_safe), mat)
        light = jnp.where(
            sph_better, gather_rows(geom.sph_light, sph_safe), light
        )

    dpdu = jnp.zeros_like(o)
    n_crv = geom.num_curves
    if n_crv > 0:
        t_c, c_idx, u_c, v_c = dense.curve_best(geom, o, d, tmax)
        crv_better = t_c < t
        crv_safe = jnp.clip(jnp.maximum(c_idx, 0), 0, n_crv - 1)
        cr = gather_rows(geom.crv, crv_safe)
        tang = normalize(cr[:, 3:6] - cr[:, 0:3])
        wo = -d
        n_c = wo - jnp.sum(tang * wo, axis=-1, keepdims=True) * tang
        n_c = n_c / jnp.maximum(
            jnp.linalg.norm(n_c, axis=-1, keepdims=True), 1e-12
        )
        t = jnp.where(crv_better, t_c, t)
        prim = jnp.where(crv_better, geom.num_triangles + n_sph + c_idx, prim)
        u = jnp.where(crv_better, u_c, u)
        v = jnp.where(crv_better, v_c, v)
        ng = jnp.where(crv_better[:, None], n_c, ng)
        mat = jnp.where(crv_better, gather_rows(geom.crv_mat, crv_safe), mat)
        light = jnp.where(crv_better, -1, light)
        dpdu = jnp.where(crv_better[:, None], tang, dpdu)

    valid = prim >= 0
    p = jnp.where(valid[:, None], o + t[:, None] * d, 0.0)
    return _merge_disk_cyl(geom, o, d, Interaction(
        valid=valid,
        t=t,
        p=p,
        n=ng,
        uv=jnp.stack([u, v], axis=-1),
        wo=-d,
        mat=jnp.where(valid, mat, 0),
        light=jnp.where(valid, light, -1),
        prim=prim,
        dpdu=dpdu,
    ))


def _merge_anyhit_quadrics(geom, o, d, tmax, occ):
    """OR the analytic families (spheres/curves/disks/cyls/blps) into a
    triangle-occlusion mask."""
    if geom.num_spheres > 0:
        sblk, _ = dense._sph_soa(geom.sph)
        t_s = dense._intersect_sph_block(o, d, tmax, sblk)
        t_s = jnp.where(
            jnp.arange(t_s.shape[1])[None, :] < geom.num_spheres, t_s, _INF
        )
        occ = occ | jnp.any(jnp.isfinite(t_s), axis=1)
    if geom.num_curves > 0:
        _, c_idx, _, _ = dense.curve_best(geom, o, d, tmax)
        occ = occ | (c_idx >= 0)
    if geom.num_disks > 0:
        _, i_d, _, _ = dense.disk_best(geom, o, d, tmax)
        occ = occ | (i_d >= 0)
    if geom.num_cyls > 0:
        _, i_c, _, _ = dense.cyl_best(geom, o, d, tmax)
        occ = occ | (i_c >= 0)
    if geom.num_blps > 0:
        _, i_b, _, _ = dense.blp_best(geom, o, d, tmax)
        occ = occ | (i_b >= 0)
    return occ


@jax.named_scope("accel/any_hit")
def any_hit(scene, o, d, tmax, time=None) -> jnp.ndarray:
    geom = scene.geom
    small = getattr(scene, "small", None)
    sweep = getattr(scene, "sweep", None)
    anim = getattr(scene, "anim", None)

    def with_anim(occ):
        if anim is None:
            return occ
        from .instances import animated_any

        return occ | animated_any(anim, geom, o, d, tmax, time)

    if geom.has_alpha:
        # Alpha-masked geometry: the first-hit-wins any-hit kernels
        # cannot skip cut surfaces, so shadow rays run the closest-hit
        # alpha restart loop (reference: __anyhit__ alpha programs,
        # gpu/optix.cu; stochastic test identical to closest).
        res = _tri_closest(scene, o, d, tmax)
        occ = res["prim"] >= 0
        return _merge_anyhit_quadrics(geom, o, d, tmax, with_anim(occ))
    if sweep is not None:
        from ..ops.sweep import sweep_intersect

        interp = not kernels_compiled()
        perm, invp = ray_sort_perm(o, d, tmax)
        res = sweep_intersect(
            sweep, o[perm], d[perm], tmax[perm], any_hit=True,
            interpret=interp,
        )
        occ = (res["prim"] >= 0)[invp]
        return _merge_anyhit_quadrics(geom, o, d, tmax, with_anim(occ))
    if scene.bvh is None and small is None \
            and getattr(scene, "kdtree", None) is None:
        if anim is None:
            occ = dense.intersect_any(geom, o, d, tmax)
        else:
            # Animated-only scene: the static triangles are object-space
            # prototypes; only the animated pass and the analytic
            # families apply.
            occ = with_anim(jnp.zeros(o.shape[0], bool))
        if geom.num_disks > 0:
            _, i_d, _, _ = dense.disk_best(geom, o, d, tmax)
            occ = occ | (i_d >= 0)
        if geom.num_cyls > 0:
            _, i_c, _, _ = dense.cyl_best(geom, o, d, tmax)
            occ = occ | (i_c >= 0)
        if geom.num_blps > 0:
            _, i_b, _, _ = dense.blp_best(geom, o, d, tmax)
            occ = occ | (i_b >= 0)
        return occ
    if getattr(scene, "kdtree", None) is not None:
        from .kdtree import kdtree_intersect

        occ = kdtree_intersect(scene.kdtree, o, d, tmax, any_hit=True)
    elif small is not None and kernels_compiled():
        from ..ops.smallscene import smallscene_intersect

        res = smallscene_intersect(small, o, d, tmax, any_hit=True)
        occ = res["prim"] >= 0
    elif small is not None:
        # CPU: the dense tester covers tri/sphere/curve; the quadric
        # families merge below (the extra sphere/curve ORs are no-ops).
        occ = dense.intersect_any(geom, o, d, tmax)
    else:
        _, prim, _, _ = bvh_intersect(scene.bvh, o, d, tmax, any_hit=True)
        occ = prim >= 0
    return _merge_anyhit_quadrics(geom, o, d, tmax, with_anim(occ))

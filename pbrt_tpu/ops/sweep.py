"""Candidate-sweep ray traversal: XLA-side per-tile candidate culling +
t-ordered Pallas (Triton) sweep with early termination. Supports object
instancing.

  1. CANDIDATES (XLA, vectorized): each TILE-ray tile is abstracted to an
     interval bundle (origin box O, direction box D, max-t). For every
     (tile, cluster-entry) pair, interval arithmetic yields the feasible
     ray-parameter window [t_lo, t_hi] in which ANY ray of the bundle can
     touch the entry's world AABB (empty window = impossible). This is a
     dense (T, E) computation, and entries are argsorted per tile by
     conservative entry t_lo.
  2. SWEEP (Pallas through Triton): one program per ray tile keeps its rays
     and their running best hit in registers and walks ONLY its candidate
     entries, nearest-first, with a while loop that stops as soon as the
     next entry's t_lo exceeds the tile's worst live t_best (the tile-level
     form of BVH front-to-back early termination), or every lane is
     occluded (any-hit mode). Per entry: a per-ray slab test against the
     cluster box gates the whole tile; a tile with a live ray loads the
     cluster's 128 triangles from global memory in (TILE x tri_chunk)
     Moller-Trumbore sub-blocks.

  Instancing: an entry is a (cluster, instance) pair. Prototype triangles
  and object-space cluster AABBs are stored ONCE; per entry the kernel
  reads the instance's 3x4 world-to-object transform (12 scalar loads) and
  transforms the tile's rays into object space (directions unnormalized,
  so object-space t == world-space t and the shared t_best prune stays
  valid across instances). Memory is O(unique geometry) + O(instances).
  Reference analogue: TransformedPrimitive / per-instance GAS
  (cpu/primitive.h:86-119, scene.cpp:1352-1557).

Attributes are always deferred: the kernel returns (t, prim, inst); the
caller resolves u/v/normal/material in one batched gather
(accel/api.py resolve_tri_attrs).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..core.pytree import pytree, static_field

_CLUSTER = 128  # triangles per cluster
# Tile, sub-block and warp count chosen on an H100
# (tools/profile_accel.py --part tune).
TILE = 64  # rays per candidate tile == rays per program
TRI_CHUNK = 32  # triangles per (rays x triangles) sub-block
NUM_WARPS = 4
_BIG = 3e38


@pytree
class SweepAccel:
    # Prototype triangle components, cluster-major: (C, 128) each, in
    # OBJECT space (== world space when not instanced). pid is the global
    # geometry triangle id + 1 as float (0.0 = pad slot).
    v0x: jnp.ndarray
    v0y: jnp.ndarray
    v0z: jnp.ndarray
    e1x: jnp.ndarray
    e1y: jnp.ndarray
    e1z: jnp.ndarray
    e2x: jnp.ndarray
    e2y: jnp.ndarray
    e2z: jnp.ndarray
    pid: jnp.ndarray
    # Object-space cluster AABB rows: (C, 8) = [lo(3) hi(3) 0 0].
    boxes: jnp.ndarray
    # Candidate entries: an entry is a (cluster, instance) pair.
    # wboxes: (E, 8) world-space AABBs; ecluster/einst: (E,) int32.
    wboxes: jnp.ndarray
    ecluster: jnp.ndarray
    einst: jnp.ndarray
    # Instance transforms, row-major 3x4 affines: (I, 12).
    w2o: jnp.ndarray  # world -> object
    o2w: jnp.ndarray  # object -> world (normals use inverse-transpose of
    #                   w2o linear part == o2w^T linear part)
    n_clusters: int = static_field(default=0)
    n_entries: int = static_field(default=0)
    instanced: bool = static_field(default=False)


def _affine_rows(m):
    m = np.asarray(m, np.float64)
    return np.ascontiguousarray(m[:3, :4]).reshape(12).astype(np.float32)


def _cluster_pack(tri_verts, order):
    """Pack Morton-ordered triangles into (c, 128) component planes +
    cluster AABBs. Returns dict of planes + boxes + padded pid base."""
    v = np.asarray(tri_verts, np.float32)[order]
    t = v.shape[0]
    c = -(-t // _CLUSTER)
    p = c * _CLUSTER
    vp = np.full((p, 3, 3), 1e30, np.float32)
    vp[:t] = v
    pid = np.full((p,), -1, np.int64)
    pid[:t] = order
    vp4 = vp.reshape(c, _CLUSTER, 3, 3)
    real = (pid.reshape(c, _CLUSTER) >= 0)[..., None, None]
    lo = np.where(real, vp4, np.inf).min(axis=(1, 2)).astype(np.float32)
    hi = np.where(real, vp4, -np.inf).max(axis=(1, 2)).astype(np.float32)
    # Pad-only clusters (possible when t % 128 == 0 padding rounds up):
    # give them a far degenerate box.
    deg = ~np.isfinite(lo[:, 0])
    lo[deg] = 2e30
    hi[deg] = 2e30
    e1 = vp4[:, :, 1] - vp4[:, :, 0]
    e2 = vp4[:, :, 2] - vp4[:, :, 0]
    return {
        "v0": vp4[:, :, 0], "e1": e1, "e2": e2,
        "pid": pid.reshape(c, _CLUSTER),
        "lo": lo, "hi": hi, "n_clusters": c,
    }


def build_sweep(
    tri_verts: np.ndarray,
    tri_mat=None,
    tri_light=None,
    proto_ranges=None,
    instances=None,
) -> SweepAccel:
    """Build the sweep accelerator.

    tri_verts: (T, 3, 3) — ALL unique triangles, prototypes concatenated
        (object space for instanced prototypes, world space otherwise).
        pid outputs index into this array, so it must be the same array
        the scene's GeometryBuffers holds.
    proto_ranges: list of (start, count) triangle ranges, one per
        prototype. None => single prototype covering everything.
    instances: None, or (proto_id (I,) int, obj_to_world (I, 4, 4)).
        None => one identity instance of prototype 0.
    """
    from ..accel.bvh import morton_order

    tri_verts = np.asarray(tri_verts, np.float32)
    t_all = tri_verts.shape[0]
    if proto_ranges is None:
        proto_ranges = [(0, t_all)]

    planes = {k: [] for k in ("v0", "e1", "e2", "pid")}
    boxes_lo, boxes_hi = [], []
    proto_cranges = []  # (cluster_start, cluster_count) per prototype
    cbase = 0
    for start, count in proto_ranges:
        sub = tri_verts[start : start + count]
        order = morton_order(sub.mean(axis=1)) + start
        packed = _cluster_pack(tri_verts, order)
        for k in ("v0", "e1", "e2", "pid"):
            planes[k].append(packed[k])
        boxes_lo.append(packed["lo"])
        boxes_hi.append(packed["hi"])
        proto_cranges.append((cbase, packed["n_clusters"]))
        cbase += packed["n_clusters"]
    v0 = np.concatenate(planes["v0"])
    e1 = np.concatenate(planes["e1"])
    e2 = np.concatenate(planes["e2"])
    pid = np.concatenate(planes["pid"])
    lo = np.concatenate(boxes_lo)
    hi = np.concatenate(boxes_hi)
    c_tot = v0.shape[0]
    boxes = np.concatenate(
        [lo, hi, np.zeros((c_tot, 2), np.float32)], axis=1
    )

    if instances is None:
        proto_id = np.zeros((1,), np.int32)
        o2w = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1))
    else:
        proto_id, o2w = instances
        proto_id = np.asarray(proto_id, np.int32)
        o2w = np.asarray(o2w, np.float32)
    n_inst = proto_id.shape[0]
    instanced = instances is not None

    # Candidate entries: (instance, cluster-of-its-prototype) pairs with
    # world AABBs (transform the 8 object-box corners).
    ecluster, einst, wlo, whi = [], [], [], []
    for i in range(n_inst):
        cs, cc = proto_cranges[proto_id[i]]
        cls = np.arange(cs, cs + cc, dtype=np.int32)
        ecluster.append(cls)
        einst.append(np.full((cc,), i, np.int32))
        l, h = lo[cs : cs + cc], hi[cs : cs + cc]
        if instanced:
            m = o2w[i]
            corners = np.stack(
                [
                    np.stack(
                        [
                            np.where(np.array([cx, cy, cz], bool), h, l)[:, k]
                            for k in range(3)
                        ],
                        axis=1,
                    )
                    for cx in (0, 1) for cy in (0, 1) for cz in (0, 1)
                ],
                axis=1,
            )  # (cc, 8, 3)
            wc = corners @ m[:3, :3].T + m[:3, 3]
            wlo.append(wc.min(axis=1).astype(np.float32))
            whi.append(wc.max(axis=1).astype(np.float32))
        else:
            wlo.append(l)
            whi.append(h)
    ecluster = np.concatenate(ecluster)
    einst = np.concatenate(einst)
    wlo = np.concatenate(wlo)
    whi = np.concatenate(whi)
    n_e = ecluster.shape[0]
    wboxes = np.concatenate(
        [wlo, whi, np.zeros((n_e, 2), np.float32)], axis=1
    )

    w2o_rows = np.stack(
        [_affine_rows(np.linalg.inv(o2w[i].astype(np.float64)))
         for i in range(n_inst)]
    )
    o2w_rows = np.stack([_affine_rows(o2w[i]) for i in range(n_inst)])

    return SweepAccel(
        v0x=jnp.asarray(v0[..., 0]), v0y=jnp.asarray(v0[..., 1]),
        v0z=jnp.asarray(v0[..., 2]),
        e1x=jnp.asarray(e1[..., 0]), e1y=jnp.asarray(e1[..., 1]),
        e1z=jnp.asarray(e1[..., 2]),
        e2x=jnp.asarray(e2[..., 0]), e2y=jnp.asarray(e2[..., 1]),
        e2z=jnp.asarray(e2[..., 2]),
        pid=jnp.asarray((pid + 1).astype(np.float32)),
        boxes=jnp.asarray(boxes),
        wboxes=jnp.asarray(wboxes),
        ecluster=jnp.asarray(ecluster),
        einst=jnp.asarray(einst),
        w2o=jnp.asarray(w2o_rows),
        o2w=jnp.asarray(o2w_rows),
        n_clusters=c_tot,
        n_entries=n_e,
        instanced=instanced,
    )


@jax.named_scope("sweep/candidates")
def _candidates(accel: SweepAccel, o, d, tmax, n_tiles: int, tile: int):
    """Per-tile t-sorted candidate entries.

    o, d, tmax are padded to n_tiles * tile rays (pad lanes tmax=-1).
    Returns (cand_cluster (T, E) i32, cand_inst (T, E) i32,
    enter_t (T, E) f32 ascending with +inf for non-candidates,
    count (T,) i32).
    """
    live = (tmax > 0.0)[:, None]  # (N, 1)
    big = jnp.float32(_BIG)
    o_t = o.reshape(n_tiles, tile, 3)
    d_t = d.reshape(n_tiles, tile, 3)
    lv = live.reshape(n_tiles, tile, 1)
    olo = jnp.min(jnp.where(lv, o_t, big), axis=1)  # (T, 3)
    ohi = jnp.max(jnp.where(lv, o_t, -big), axis=1)
    dlo = jnp.min(jnp.where(lv, d_t, big), axis=1)
    dhi = jnp.max(jnp.where(lv, d_t, -big), axis=1)
    thi_tile = jnp.max(
        jnp.where(lv[..., 0], tmax.reshape(n_tiles, tile), 0.0), axis=1
    )  # (T,)

    blo = accel.wboxes[:, 0:3]  # (E, 3)
    bhi = accel.wboxes[:, 3:6]

    # Feasible t-window per axis for the interval bundle:
    #   reach(t) = [olo + t*dlo, ohi + t*dhi]   (t >= 0)
    #   need olo + t*dlo <= bhi  AND  ohi + t*dhi >= blo.
    a = dlo[:, None, :]  # (T, 1, 3)
    b = dhi[:, None, :]
    q = bhi[None, :, :] - olo[:, None, :]  # (T, E, 3)
    r = blo[None, :, :] - ohi[:, None, :]
    eps = 1e-30

    # c1: t*a <= q -> upper bound if a>0, lower bound if a<0, else q>=0.
    up1 = jnp.where(a > 0, q / jnp.maximum(a, eps), big)
    lo1 = jnp.where(a < 0, q / jnp.minimum(a, -eps), 0.0)
    bad1 = (a == 0) & (q < 0)
    # c2: t*b >= r -> lower bound if b>0, upper bound if b<0, else r<=0.
    lo2 = jnp.where(b > 0, r / jnp.maximum(b, eps), 0.0)
    up2 = jnp.where(b < 0, r / jnp.minimum(b, -eps), big)
    bad2 = (b == 0) & (r > 0)

    t_lo = jnp.max(jnp.maximum(lo1, lo2), axis=-1)  # (T, E)
    t_hi = jnp.min(jnp.minimum(up1, up2), axis=-1)
    bad = jnp.any(bad1 | bad2, axis=-1)
    feasible = (~bad) & (t_lo <= t_hi) & (t_lo < thi_tile[:, None])

    key = jnp.where(feasible, t_lo, jnp.float32(jnp.inf))
    order = jnp.argsort(key, axis=1).astype(jnp.int32)  # (T, E)
    enter_t = jnp.take_along_axis(key, order, axis=1)
    cand_c = accel.ecluster[order]
    cand_i = accel.einst[order]
    count = jnp.sum(feasible, axis=1, dtype=jnp.int32)
    return cand_c, cand_i, enter_t, count


def _sweep_kernel(
    count_ref,  # (T,) int32 candidate count per tile
    candc_ref,  # (T, E) int32 candidate cluster rows (t-sorted)
    candi_ref,  # (T, E) int32 candidate instance ids
    entert_ref,  # (T, E) f32 conservative entry t (ascending)
    boxes_ref,  # (C, 8) object-space cluster AABBs
    w2o_ref,  # (I, 12) world->object affines
    v0x_ref, v0y_ref, v0z_ref,
    e1x_ref, e1y_ref, e1z_ref,
    e2x_ref, e2y_ref, e2z_ref, pid_ref,
    ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmax_ref,
    t_out, prim_out, inst_out,
    *,
    n_entries: int,
    any_hit: bool,
    instanced: bool,
    tri_chunk: int,
):
    eps = 1e-12
    tile = pl.program_id(0)
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]  # (tile,)
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    tmax = tmax_ref[...]
    cnt = count_ref[tile]

    def entry_body(k, t_best, prim, inst):
        c = candc_ref[tile, k]
        if instanced:
            i = candi_ref[tile, k]
            a00 = w2o_ref[i, 0]
            a01 = w2o_ref[i, 1]
            a02 = w2o_ref[i, 2]
            b0 = w2o_ref[i, 3]
            a10 = w2o_ref[i, 4]
            a11 = w2o_ref[i, 5]
            a12 = w2o_ref[i, 6]
            b1 = w2o_ref[i, 7]
            a20 = w2o_ref[i, 8]
            a21 = w2o_ref[i, 9]
            a22 = w2o_ref[i, 10]
            b2 = w2o_ref[i, 11]
            lox = a00 * ox + a01 * oy + a02 * oz + b0
            loy = a10 * ox + a11 * oy + a12 * oz + b1
            loz = a20 * ox + a21 * oy + a22 * oz + b2
            # Direction left unnormalized: object-space t == world t.
            ldx = a00 * dx + a01 * dy + a02 * dz
            ldy = a10 * dx + a11 * dy + a12 * dz
            ldz = a20 * dx + a21 * dy + a22 * dz
            inst_f = (i + 1).astype(jnp.float32)
        else:
            lox, loy, loz = ox, oy, oz
            ldx, ldy, ldz = dx, dy, dz
            inst_f = jnp.float32(1.0)

        inv_dx = 1.0 / jnp.where(jnp.abs(ldx) < eps, eps, ldx)
        inv_dy = 1.0 / jnp.where(jnp.abs(ldy) < eps, eps, ldy)
        inv_dz = 1.0 / jnp.where(jnp.abs(ldz) < eps, eps, ldz)

        # Per-ray slab test vs the OBJECT-space cluster box (rays already
        # in object space), including the closer-hit prune. The tile tests
        # the cluster's triangles only if some ray can reach the box.
        tx0 = (boxes_ref[c, 0] - lox) * inv_dx
        tx1 = (boxes_ref[c, 3] - lox) * inv_dx
        ty0 = (boxes_ref[c, 1] - loy) * inv_dy
        ty1 = (boxes_ref[c, 4] - loy) * inv_dy
        tz0 = (boxes_ref[c, 2] - loz) * inv_dz
        tz1 = (boxes_ref[c, 5] - loz) * inv_dz
        tmin = jnp.maximum(
            jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
            jnp.maximum(jnp.minimum(tz0, tz1), 0.0),
        )
        tmx = jnp.minimum(
            jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
            jnp.maximum(tz0, tz1),
        )
        rayhit = (tmx >= tmin) & (tmin < t_best)
        live = jnp.max(rayhit.astype(jnp.int32)) > 0

        # (tile, 1) ray columns against (1, tri_chunk) triangle rows.
        oxg, oyg, ozg = lox[:, None], loy[:, None], loz[:, None]
        dxg, dyg, dzg = ldx[:, None], ldy[:, None], ldz[:, None]

        def chunk(j, carry):
            t_best, prim, inst = carry
            sl = pl.ds(j * tri_chunk, tri_chunk)
            v0xr = v0x_ref[c, sl][None, :]
            v0yr = v0y_ref[c, sl][None, :]
            v0zr = v0z_ref[c, sl][None, :]
            e1xr = e1x_ref[c, sl][None, :]
            e1yr = e1y_ref[c, sl][None, :]
            e1zr = e1z_ref[c, sl][None, :]
            e2xr = e2x_ref[c, sl][None, :]
            e2yr = e2y_ref[c, sl][None, :]
            e2zr = e2z_ref[c, sl][None, :]
            pidr = pid_ref[c, sl][None, :]
            px = dyg * e2zr - dzg * e2yr
            py = dzg * e2xr - dxg * e2zr
            pz = dxg * e2yr - dyg * e2xr
            det = e1xr * px + e1yr * py + e1zr * pz
            inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
            tvx = oxg - v0xr
            tvy = oyg - v0yr
            tvz = ozg - v0zr
            uk = (tvx * px + tvy * py + tvz * pz) * inv_det
            qx = tvy * e1zr - tvz * e1yr
            qy = tvz * e1xr - tvx * e1zr
            qz = tvx * e1yr - tvy * e1xr
            vk = (dxg * qx + dyg * qy + dzg * qz) * inv_det
            tk = (e2xr * qx + e2yr * qy + e2zr * qz) * inv_det
            tb = t_best[:, None]
            hit = (
                (jnp.abs(det) > eps)
                & (uk >= 0.0)
                & (vk >= 0.0)
                & (uk + vk <= 1.0)
                & (tk > 0.0)
                & (tk < tb)
            )
            if any_hit:
                p_sel = jnp.max(jnp.where(hit, pidr, 0.0), axis=1)
                got = p_sel > 0.0
                return (
                    jnp.where(got, 0.0, t_best),
                    jnp.where(got, p_sel, prim),
                    jnp.where(got, inst_f, inst),
                )
            tkh = jnp.where(hit, tk, _BIG)
            tmin_new = jnp.min(tkh, axis=1)
            better = tmin_new < t_best
            eq = hit & (tkh == tmin_new[:, None])
            pid_sel = jnp.max(jnp.where(eq, pidr, 0.0), axis=1)
            return (
                jnp.where(better, tmin_new, t_best),
                jnp.where(better, pid_sel, prim),
                jnp.where(better, inst_f, inst),
            )

        def test(carry):
            return jax.lax.fori_loop(0, _CLUSTER // tri_chunk, chunk, carry)

        return jax.lax.cond(live, test, lambda carry: carry,
                            (t_best, prim, inst))

    def cond(state):
        k, t_best, prim, inst = state
        # Front-to-back early termination: once the nearest untested
        # entry starts beyond every live lane's current best t, no entry
        # can improve any lane (entries are t_lo-ascending). Dead/pad
        # lanes carry t_best <= 0 and never inflate the bound. In any-hit
        # mode occluded lanes collapse to 0, so the sweep stops when all
        # live lanes are occluded.
        kc = jnp.minimum(k, n_entries - 1)
        return (k < cnt) & (entert_ref[tile, kc] < jnp.max(t_best))

    def body(state):
        k, t_best, prim, inst = state
        t_best, prim, inst = entry_body(k, t_best, prim, inst)
        return k + 1, t_best, prim, inst

    zero = jnp.zeros_like(tmax)
    _, t_best, prim, inst = jax.lax.while_loop(
        cond, body, (jnp.int32(0), tmax, zero, zero)
    )
    t_out[...] = t_best
    prim_out[...] = prim
    inst_out[...] = inst


@functools.partial(
    jax.jit,
    static_argnames=("any_hit", "interpret", "tile", "tri_chunk",
                     "num_warps"),
)
def _sweep_intersect_impl(accel: SweepAccel, o, d, tmax,
                          any_hit: bool = False, interpret: bool = False,
                          tile: int = TILE, tri_chunk: int = TRI_CHUNK,
                          num_warps: int = NUM_WARPS):
    """Hit query over sorted rays. Returns dict with per-ray 't'
    (inf = miss), 'prim' (int32 global triangle id, -1 = miss), 'inst'
    (int32 instance id, -1 = miss)."""
    n = o.shape[0]
    pad = (-n) % tile
    npad = n + pad
    n_tiles = npad // tile

    o_p = jnp.pad(o, ((0, pad), (0, 0)))
    d_p = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    tm_p = jnp.pad(tmax, (0, pad), constant_values=-1.0)

    cand_c, cand_i, enter_t, count = _candidates(
        accel, o_p, d_p, tm_p, n_tiles, tile
    )

    def full(x):
        return pl.BlockSpec(x.shape, lambda i: (0,) * x.ndim)

    ray_spec = pl.BlockSpec((tile,), lambda i: (i,))
    tables = (
        count, cand_c, cand_i, enter_t, accel.boxes, accel.w2o,
        accel.v0x, accel.v0y, accel.v0z,
        accel.e1x, accel.e1y, accel.e1z,
        accel.e2x, accel.e2y, accel.e2z, accel.pid,
    )
    rays = (o_p[:, 0], o_p[:, 1], o_p[:, 2],
            d_p[:, 0], d_p[:, 1], d_p[:, 2], tm_p)
    kernel = functools.partial(
        _sweep_kernel,
        n_entries=accel.n_entries,
        any_hit=any_hit,
        instanced=accel.instanced,
        tri_chunk=tri_chunk,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=[full(x) for x in tables] + [ray_spec] * 7,
        out_specs=[ray_spec] * 3,
        out_shape=[
            jax.ShapeDtypeStruct((npad,), jnp.float32) for _ in range(3)
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        interpret=interpret,
        name="sweep_intersect",
    )(*tables, *rays)

    t, prim_f, inst_f = (x[:n] for x in outs)
    miss = prim_f <= 0.0
    prim = jnp.where(miss, -1, prim_f.astype(jnp.int32) - 1)
    inst = jnp.where(miss, -1, inst_f.astype(jnp.int32) - 1)
    t = jnp.where(miss, jnp.inf, t)
    return {"t": t, "prim": prim, "inst": inst}


from .detach import detached_query  # noqa: E402

sweep_intersect = detached_query(_sweep_intersect_impl)

"""SAH kd-tree aggregate.

Reference analogue: KdTreeAggregate (cpu/aggregates.h:131, aggregates.cpp:
747-1151) — pbrt's second aggregate next to the BVH. Build runs on the host
(numpy, SAH over sorted bound edges with the reference's cost model:
traversal cost 1, intersection cost 80/affinity, empty-space bonus); the
flattened node array mirrors the reference's 8-byte KdTreeNode packing
(split axis / leaf flag + above-child index / prim offset) in SoA form so
traversal is pure gathers.

Traversal is the reference's parametric short-stack walk
(aggregates.cpp:1030-1151) expressed as a jax.lax.while_loop under vmap:
each ray carries a fixed 64-entry (node, tMin, tMax) todo stack. This is a
capability/parity engine — the Pallas kernels (ops/smallscene.py,
ops/sweep.py) are the performance path, as pbrt defaults to the BVH.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.pytree import pytree, static_field

_INF = jnp.inf
_STACK = 64

# Build-time cost model (aggregates.cpp KdTreeAggregate ctor defaults).
_ISECT_COST = 5.0
_TRAV_COST = 1.0
_EMPTY_BONUS = 0.5


@pytree
class KdTree:
    # Node SoA: axis (0/1/2, 3 == leaf), split position, above-child index
    # (below child is node+1, as in the reference's depth-first layout),
    # leaf prim offset/count into prim_indices.
    axis: jnp.ndarray          # (M,) int32
    split: jnp.ndarray         # (M,) float32
    above: jnp.ndarray         # (M,) int32
    prim_off: jnp.ndarray      # (M,) int32
    prim_cnt: jnp.ndarray      # (M,) int32
    prim_indices: jnp.ndarray  # (K,) int32 triangle ids
    tri_verts: jnp.ndarray     # (T, 3, 3)
    bounds_lo: jnp.ndarray     # (3,)
    bounds_hi: jnp.ndarray     # (3,)
    n_nodes: int = static_field(default=0)


def build_kdtree(tri_verts: np.ndarray, max_prims: int = 4,
                 max_depth: int | None = None) -> KdTree:
    """Host-side SAH build (KdTreeAggregate::BuildTree, aggregates.cpp:830).

    tri_verts: (T, 3, 3) float32.
    """
    tv = np.asarray(tri_verts, np.float32)
    n_tri = tv.shape[0]
    lo_all = tv.min(axis=1)  # (T, 3)
    hi_all = tv.max(axis=1)
    bounds_lo = lo_all.min(axis=0) if n_tri else np.zeros(3, np.float32)
    bounds_hi = hi_all.max(axis=0) if n_tri else np.ones(3, np.float32)
    if max_depth is None:
        # Reference heuristic: 8 + 1.3 log2(N) (aggregates.cpp:789).
        max_depth = int(round(8 + 1.3 * np.log2(max(n_tri, 1) + 1)))

    axis_l, split_l, above_l, off_l, cnt_l = [], [], [], [], []
    prim_indices: list[int] = []

    def add_leaf(prims):
        axis_l.append(3)
        split_l.append(0.0)
        above_l.append(0)
        off_l.append(len(prim_indices))
        cnt_l.append(len(prims))
        prim_indices.extend(int(p) for p in prims)

    def rec(prims, nlo, nhi, depth, bad_refines):
        node_id = len(axis_l)
        if len(prims) <= max_prims or depth == 0:
            add_leaf(prims)
            return node_id
        # SAH over bound edges on each axis (aggregates.cpp:857-929).
        d = nhi - nlo
        inv_total_sa = 1.0 / max(
            2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]), 1e-20
        )
        old_cost = _ISECT_COST * len(prims)
        best = (None, None, np.inf)  # (axis, split_t, cost)
        p_lo = lo_all[prims]
        p_hi = hi_all[prims]
        for ax in np.argsort(-d):  # try widest axis first
            ax = int(ax)
            # Edge list: (position, is_start).
            starts = p_lo[:, ax]
            ends = p_hi[:, ax]
            pos = np.concatenate([starts, ends])
            kind = np.concatenate(
                [np.zeros(len(prims)), np.ones(len(prims))]
            )  # 0 = start, 1 = end
            order = np.lexsort((kind, pos))
            pos, kind = pos[order], kind[order]
            n_below, n_above = 0, len(prims)
            o_ax = [a for a in range(3) if a != ax]
            for i in range(len(pos)):
                if kind[i] == 1:
                    n_above -= 1
                pt = pos[i]
                if nlo[ax] < pt < nhi[ax]:
                    d0, d1 = d[o_ax[0]], d[o_ax[1]]
                    below_sa = 2.0 * (
                        d0 * d1 + (pt - nlo[ax]) * (d0 + d1)
                    )
                    above_sa = 2.0 * (
                        d0 * d1 + (nhi[ax] - pt) * (d0 + d1)
                    )
                    pb = below_sa * inv_total_sa
                    pa = above_sa * inv_total_sa
                    eb = _EMPTY_BONUS if (n_above == 0 or n_below == 0) else 0.0
                    cost = (
                        _TRAV_COST
                        + _ISECT_COST * (1.0 - eb)
                        * (pb * n_below + pa * n_above)
                    )
                    if cost < best[2]:
                        best = (ax, pt, cost)
                if kind[i] == 0:
                    n_below += 1
            if best[0] is not None:
                break  # reference retries other axes only when none found
        if best[0] is None or (
            best[2] > 4.0 * old_cost and len(prims) < 16
        ):
            add_leaf(prims)
            return node_id
        if best[2] > old_cost:
            bad_refines += 1
            if bad_refines == 3:
                add_leaf(prims)
                return node_id
        ax, pt, _ = best
        below = [p for p in prims if lo_all[p][ax] < pt]
        above = [p for p in prims if hi_all[p][ax] > pt]
        # Straddlers land on both sides; flat-on-plane prims go above.
        below += [p for p in prims if lo_all[p][ax] == pt == hi_all[p][ax]
                  and p not in below]
        # Interior node placeholder; children fill in depth-first order.
        axis_l.append(int(ax))
        split_l.append(float(pt))
        above_l.append(0)
        off_l.append(0)
        cnt_l.append(0)
        lo_b, hi_b = nlo.copy(), nhi.copy()
        hi_b[ax] = pt
        rec(below, nlo, hi_b, depth - 1, bad_refines)
        lo_a = nlo.copy()
        lo_a[ax] = pt
        above_l[node_id] = len(axis_l)
        rec(above, lo_a, nhi, depth - 1, bad_refines)
        return node_id

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        rec(list(range(n_tri)), bounds_lo.copy(), bounds_hi.copy(),
            max_depth, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    return KdTree(
        axis=jnp.asarray(axis_l, jnp.int32),
        split=jnp.asarray(split_l, jnp.float32),
        above=jnp.asarray(above_l, jnp.int32),
        prim_off=jnp.asarray(off_l, jnp.int32),
        prim_cnt=jnp.asarray(cnt_l, jnp.int32),
        prim_indices=jnp.asarray(
            prim_indices if prim_indices else [0], jnp.int32
        ),
        tri_verts=jnp.asarray(tv if n_tri else np.zeros((1, 3, 3)),
                              jnp.float32),
        bounds_lo=jnp.asarray(bounds_lo),
        bounds_hi=jnp.asarray(bounds_hi),
        n_nodes=len(axis_l),
    )


def _tri_hit(tv, o, d):
    """Scalar Moller-Trumbore: tv (3,3); returns (t, u, v), t=inf on miss."""
    e1 = tv[1] - tv[0]
    e2 = tv[2] - tv[0]
    pv = jnp.cross(d, e2)
    det = jnp.dot(e1, pv)
    inv = jnp.where(jnp.abs(det) < 1e-12, 0.0, 1.0 / det)
    tvec = o - tv[0]
    u = jnp.dot(tvec, pv) * inv
    qv = jnp.cross(tvec, e1)
    v = jnp.dot(d, qv) * inv
    t = jnp.dot(e2, qv) * inv
    ok = (
        (inv != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
    )
    return jnp.where(ok, t, _INF), u, v


def kdtree_intersect(kd: KdTree, o, d, tmax, any_hit: bool = False):
    """Batched parametric kd traversal (KdTreeAggregate::Intersect,
    aggregates.cpp:1030). Returns (t, prim, u, v) with prim -1 on miss;
    with any_hit=True returns a bool occlusion mask."""

    def one(o1, d1, tmax1):
        inv_d = jnp.where(jnp.abs(d1) < 1e-20,
                          jnp.sign(d1) * 1e20 + (d1 == 0.0) * 1e20,
                          1.0 / d1)
        # Ray vs scene bounds.
        t0 = (kd.bounds_lo - o1) * inv_d
        t1 = (kd.bounds_hi - o1) * inv_d
        tn = jnp.minimum(t0, t1)
        tf = jnp.maximum(t0, t1)
        # Conservative f32 slab span: scene surfaces often lie exactly on
        # the kd bounds (e.g. box walls), putting hits at t == tmax where
        # one ulp of rounding prunes the containing leaf (the reference
        # widens its slab test by gamma(3) the same way, vecmath.h
        # Bounds3::IntersectP).
        tmin0 = jnp.maximum(jnp.max(tn), 0.0)
        tmax0 = jnp.minimum(jnp.min(tf), tmax1)
        pad0 = 1e-5 * jnp.abs(tmax0) + 1e-7
        tmin0 = jnp.maximum(tmin0 - pad0, 0.0)
        tmax0 = tmax0 + pad0

        state = dict(
            node=jnp.int32(0),
            tmin=tmin0,
            tmax=tmax0,
            todo_node=jnp.zeros((_STACK,), jnp.int32),
            todo_tmin=jnp.zeros((_STACK,), jnp.float32),
            todo_tmax=jnp.zeros((_STACK,), jnp.float32),
            top=jnp.int32(0),
            best_t=jnp.where(tmin0 <= tmax0, tmax1, -_INF),  # -inf: dead
            best_prim=jnp.int32(-1),
            best_u=jnp.float32(0.0),
            best_v=jnp.float32(0.0),
            alive=tmin0 <= tmax0,
        )

        def cond(s):
            return s["alive"]

        def body(s):
            nid = s["node"]
            ax = kd.axis[nid]
            is_leaf = ax == 3

            # ---- Leaf: test prims sequentially (fori over count).
            def leaf_case(s):
                off = kd.prim_off[nid]
                cnt = kd.prim_cnt[nid]

                def pbody(i, acc):
                    bt, bp, bu, bv = acc
                    pid = kd.prim_indices[
                        jnp.clip(off + i, 0, kd.prim_indices.shape[0] - 1)
                    ]
                    t, u, v = _tri_hit(kd.tri_verts[pid], o1, d1)
                    better = t < bt
                    return (
                        jnp.where(better, t, bt),
                        jnp.where(better, pid, bp),
                        jnp.where(better, u, bu),
                        jnp.where(better, v, bv),
                    )

                bt, bp, bu, bv = jax.lax.fori_loop(
                    0, cnt,
                    pbody,
                    (s["best_t"], s["best_prim"], s["best_u"], s["best_v"]),
                )
                s = dict(s, best_t=bt, best_prim=bp, best_u=bu, best_v=bv)
                # Pop the todo stack (or finish).
                has = s["top"] > 0
                stop_early = any_hit & (bp >= 0)
                top = s["top"] - 1
                idx = jnp.maximum(top, 0)
                nxt_tmin = s["todo_tmin"][idx]
                # Early-out: best hit before the next span's entry
                # (shrinking tMax, aggregates.cpp:1136).
                closer = bt <= nxt_tmin
                keep = has & ~stop_early & ~(closer & ~jnp.isinf(bt))
                return dict(
                    s,
                    node=jnp.where(keep, s["todo_node"][idx], 0),
                    tmin=jnp.where(keep, nxt_tmin, 0.0),
                    tmax=jnp.where(keep, s["todo_tmax"][idx], 0.0),
                    top=jnp.where(has, top, 0),
                    alive=keep,
                )

            # ---- Interior: order children, maybe push far side.
            def interior_case(s):
                axi = ax
                sp = kd.split[nid]
                o_ax = o1[axi]
                d_ax = d1[axi]
                inv = jnp.where(jnp.abs(d_ax) < 1e-20, 1e20, 1.0 / d_ax)
                t_plane = (sp - o_ax) * inv
                below_first = (o_ax < sp) | ((o_ax == sp) & (d_ax <= 0))
                below = nid + 1
                above = kd.above[nid]
                first = jnp.where(below_first, below, above)
                second = jnp.where(below_first, above, below)
                # Single-child cases (plane outside [tmin, tmax] or
                # parallel ray); comparisons padded one ulp-scale so
                # boundary hits never lose their leaf to f32 rounding.
                pad = 1e-6 * jnp.abs(t_plane) + 1e-7
                only_first = (t_plane > s["tmax"] + pad) | (t_plane <= 0.0)
                # Strict else-if order (aggregates.cpp:1096): a plane behind
                # the ray (t_plane <= 0) must resolve to the FIRST child
                # even when t_plane < tmin also holds.
                only_second = ~only_first & (t_plane < s["tmin"] - pad)
                push = ~(only_first | only_second)
                top = s["top"]
                idx = jnp.minimum(top, _STACK - 1)
                s2 = dict(
                    s,
                    todo_node=s["todo_node"].at[idx].set(
                        jnp.where(push, second, s["todo_node"][idx])
                    ),
                    todo_tmin=s["todo_tmin"].at[idx].set(
                        jnp.where(push, t_plane, s["todo_tmin"][idx])
                    ),
                    todo_tmax=s["todo_tmax"].at[idx].set(
                        jnp.where(push, s["tmax"], s["todo_tmax"][idx])
                    ),
                    top=jnp.where(push, jnp.minimum(top + 1, _STACK),
                                  top),
                )
                node = jnp.where(
                    only_second, second, first
                )
                tmax2 = jnp.where(push, t_plane, s["tmax"])
                return dict(s2, node=node, tmax=tmax2)

            return jax.lax.cond(is_leaf, leaf_case, interior_case, s)

        out = jax.lax.while_loop(cond, body, state)
        bt = out["best_t"]
        hit = (out["best_prim"] >= 0) & (bt < tmax1)
        return (
            jnp.where(hit, bt, _INF),
            jnp.where(hit, out["best_prim"], -1),
            out["best_u"],
            out["best_v"],
        )

    t, prim, u, v = jax.vmap(one)(o, d, tmax)
    if any_hit:
        return prim >= 0
    return t, prim, u, v

"""BVH: host-side Morton/LBVH build -> flattened implicit-tree tensors,
with a batched masked traversal on device.

Reference analogue: BVHAggregate (/root/reference/src/pbrt/cpu/aggregates.h:31)
— HLBVH Morton build (aggregates.cpp:389-505) and the stack-based traversal
(:529-624). Redesign per SURVEY.md section 7:
  * build: numpy-vectorized Morton sort -> COMPLETE implicit binary tree over
    2^k leaf slots (heap layout: children of i are 2i+1/2i+2). No pointers,
    no flattening pass; node boxes come from one bottom-up vectorized reduce.
  * traversal: all rays advance in lockstep through a lax.while_loop with a
    per-ray explicit stack (N, depth) tensor; leaves hold `leaf_size`
    primitives tested branchlessly. Terminated rays are masked.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.pytree import pytree, static_field

_INF = np.float32(np.inf)


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords -> 30-bit Morton codes. x: (n, 3) in [0,1)."""
    q = np.clip((x * 1024.0).astype(np.uint32), 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (
        spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (spread(q[:, 2]) << np.uint64(2))
    )


def morton_order(cent: np.ndarray) -> np.ndarray:
    """Stable ascending-Morton permutation of (n, 3) float32 centroids.

    Prefers the native C++ radix-sort stage (native/accel_build.cpp — the
    HLBVH build front half, aggregates.cpp:389-505 analogue; ~10x numpy at
    1M tris); falls back to the bit-identical numpy path.
    """
    from ..native import morton_order_native

    order = morton_order_native(cent)
    if order is not None:
        return order
    lo = cent.min(axis=0)
    hi = cent.max(axis=0)
    norm = (cent - lo) / np.maximum(hi - lo, 1e-12)
    return np.argsort(_morton3(norm), kind="stable")


@pytree
class BVH:
    # Implicit complete binary tree over 2^depth leaves; heap index layout.
    node_lo: jnp.ndarray  # (n_nodes, 3)
    node_hi: jnp.ndarray  # (n_nodes, 3)
    # Reordered triangle SOA (n_leaves * leaf_size entries, padded with
    # degenerate triangles mapping to prim_id -1).
    v0: jnp.ndarray  # (P, 3)
    e1: jnp.ndarray  # (P, 3)
    e2: jnp.ndarray  # (P, 3)
    prim_id: jnp.ndarray  # (P,) original triangle index or -1
    depth: int = static_field(default=0)  # tree depth (leaves at this level)
    leaf_size: int = static_field(default=4)

    @property
    def n_leaves(self) -> int:
        return 1 << self.depth

    @property
    def first_leaf(self) -> int:
        return (1 << self.depth) - 1


def build_bvh(tri_verts: np.ndarray, leaf_size: int = 4) -> BVH:
    """Host build: Morton-sort triangles, pack into a complete implicit tree."""
    tri_verts = np.asarray(tri_verts, np.float32)
    t = tri_verts.shape[0]
    cent = tri_verts.mean(axis=1)
    order = morton_order(cent)
    sorted_tris = tri_verts[order]

    n_leaves_needed = max(1, -(-t // leaf_size))
    depth = max(0, int(np.ceil(np.log2(n_leaves_needed))))
    n_leaves = 1 << depth
    p = n_leaves * leaf_size

    # Padded, reordered primitive SOA. Padding triangles are degenerate
    # (zero area at a far point) and carry prim_id -1.
    v = np.full((p, 3, 3), 1e30, np.float32)
    v[:t] = sorted_tris
    prim_id = np.full((p,), -1, np.int64)
    prim_id[:t] = order

    # Leaf AABBs.
    leaf_v = v.reshape(n_leaves, leaf_size, 3, 3)
    real = (prim_id.reshape(n_leaves, leaf_size) >= 0)[..., None, None]
    leaf_lo = np.where(real, leaf_v, _INF).min(axis=(1, 2))
    leaf_hi = np.where(real, leaf_v, -_INF).max(axis=(1, 2))

    # Bottom-up box reduce into the heap array.
    n_nodes = 2 * n_leaves - 1
    node_lo = np.full((n_nodes, 3), _INF, np.float32)
    node_hi = np.full((n_nodes, 3), -_INF, np.float32)
    first_leaf = n_leaves - 1
    node_lo[first_leaf:] = leaf_lo
    node_hi[first_leaf:] = leaf_hi
    for level in range(depth - 1, -1, -1):
        s = (1 << level) - 1
        e = (1 << (level + 1)) - 1
        left = 2 * np.arange(s, e) + 1
        node_lo[s:e] = np.minimum(node_lo[left], node_lo[left + 1])
        node_hi[s:e] = np.maximum(node_hi[left], node_hi[left + 1])

    return BVH(
        node_lo=jnp.asarray(node_lo),
        node_hi=jnp.asarray(node_hi),
        v0=jnp.asarray(v[:, 0]),
        e1=jnp.asarray(v[:, 1] - v[:, 0]),
        e2=jnp.asarray(v[:, 2] - v[:, 0]),
        prim_id=jnp.asarray(prim_id, jnp.int32),
        depth=depth,
        leaf_size=leaf_size,
    )


def _aabb_hit(lo, hi, o, inv_d, t_best):
    """Slab test: (N,) bool whether the box [lo, hi] is hit before t_best."""
    ta = (lo - o) * inv_d
    tb = (hi - o) * inv_d
    tmin = jnp.max(jnp.minimum(ta, tb), axis=-1)
    tmax = jnp.min(jnp.maximum(ta, tb), axis=-1)
    return (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < t_best)


def _aabb_entry(lo, hi, o, inv_d):
    """Conservative slab entry distance (clamped at 0) for child ordering."""
    ta = (lo - o) * inv_d
    tb = (hi - o) * inv_d
    return jnp.maximum(jnp.max(jnp.minimum(ta, tb), axis=-1), 0.0)


def _leaf_test(bvh: BVH, leaf_idx, o, d, t_best, best_prim, best_u, best_v,
               any_hit: bool):
    """Test the leaf_size triangles of leaf `leaf_idx` (N,) for each ray."""
    ls = bvh.leaf_size
    base = leaf_idx * ls
    for k in range(ls):
        idx = base + k
        v0 = bvh.v0[idx]
        e1 = bvh.e1[idx]
        e2 = bvh.e2[idx]
        pvec = jnp.cross(d, e2)
        det = jnp.sum(e1 * pvec, axis=-1)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = o - v0
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, e1)
        vv = jnp.sum(d * qvec, axis=-1) * inv_det
        tt = jnp.sum(e2 * qvec, axis=-1) * inv_det
        hit = (
            (jnp.abs(det) > 1e-12)
            & (u >= 0.0)
            & (vv >= 0.0)
            & (u + vv <= 1.0)
            & (tt > 0.0)
            & (tt < t_best)
            & (bvh.prim_id[idx] >= 0)
        )
        t_best = jnp.where(hit, tt, t_best)
        best_prim = jnp.where(hit, bvh.prim_id[idx], best_prim)
        best_u = jnp.where(hit, u, best_u)
        best_v = jnp.where(hit, vv, best_v)
    return t_best, best_prim, best_u, best_v


def bvh_intersect(bvh: BVH, o, d, tmax, any_hit: bool = False):
    """Closest-hit (or any-hit) traversal.

    Returns (t, prim_id, u, v) with prim_id == -1 for misses. For any_hit,
    rays terminate at the first confirmed triangle hit (t < tmax).
    """
    n = o.shape[0]
    stack_depth = bvh.depth + 2
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)

    stack = jnp.zeros((n, stack_depth), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)  # root pushed at slot 0
    t_best = tmax
    best_prim = jnp.full((n,), -1, jnp.int32)
    best_u = jnp.zeros((n,), o.dtype)
    best_v = jnp.zeros((n,), o.dtype)

    first_leaf = bvh.first_leaf

    def cond(state):
        sp = state[1]
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, t_best, best_prim, best_u, best_v = state
        if any_hit:
            # A confirmed hit terminates the ray: drain its stack.
            sp = jnp.where(best_prim >= 0, 0, sp)
        live = sp > 0
        sp_idx = jnp.maximum(sp - 1, 0)
        node = jnp.take_along_axis(stack, sp_idx[:, None], axis=1)[:, 0]
        sp = jnp.where(live, sp - 1, sp)
        node = jnp.where(live, node, 0)

        lo = bvh.node_lo[node]
        hi = bvh.node_hi[node]
        hit_box = live & _aabb_hit(lo, hi, o, inv_d, t_best)

        is_leaf = node >= first_leaf
        # --- leaf: test primitives.
        do_leaf = hit_box & is_leaf
        leaf_idx = jnp.maximum(node - first_leaf, 0)
        t_new, p_new, u_new, v_new = _leaf_test(
            bvh, leaf_idx, o, d, t_best, best_prim, best_u, best_v, any_hit
        )
        t_best = jnp.where(do_leaf, t_new, t_best)
        best_prim = jnp.where(do_leaf, p_new, best_prim)
        best_u = jnp.where(do_leaf, u_new, best_u)
        best_v = jnp.where(do_leaf, v_new, best_v)

        # --- internal: push both children near-first (far child pushed
        # first so the near one pops first — aggregates.cpp:611-622's
        # dirIsNeg child ordering, done here with the actual slab entry
        # distances so closest-hit t_best shrinks as early as possible).
        do_push = hit_box & ~is_leaf
        child0 = 2 * node + 1
        child1 = 2 * node + 2
        t0 = _aabb_entry(bvh.node_lo[child0], bvh.node_hi[child0], o, inv_d)
        t1 = _aabb_entry(bvh.node_lo[child1], bvh.node_hi[child1], o, inv_d)
        near_is_0 = t0 <= t1
        near = jnp.where(near_is_0, child0, child1)
        far = jnp.where(near_is_0, child1, child0)
        onehot = (
            jnp.arange(stack_depth, dtype=jnp.int32)[None, :] == sp[:, None]
        )
        stack = jnp.where(
            onehot & do_push[:, None], far[:, None], stack
        )
        sp = jnp.where(do_push, sp + 1, sp)
        onehot = (
            jnp.arange(stack_depth, dtype=jnp.int32)[None, :] == sp[:, None]
        )
        stack = jnp.where(
            onehot & do_push[:, None], near[:, None], stack
        )
        sp = jnp.where(do_push, sp + 1, sp)
        return stack, sp, t_best, best_prim, best_u, best_v

    state = (stack, sp, t_best, best_prim, best_u, best_v)
    _, _, t_best, best_prim, best_u, best_v = jax.lax.while_loop(
        cond, body, state
    )
    return t_best, best_prim, best_u, best_v

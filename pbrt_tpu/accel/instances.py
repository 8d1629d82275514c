"""Animated (motion-blurred) object instances.

Reference analogue: AnimatedPrimitive (cpu/primitive.h:86-119,
primitive.cpp:40-77): the instance's object-to-world transform is an
AnimatedTransform; each ray interpolates it at ray.time, transforms into
object space, intersects the prototype, and maps the interaction back.

Design: animated instances are intersected OUTSIDE the Pallas sweep
kernel in a fully vectorized XLA pass — the per-ray transform interpolation
(lerp T / slerp R / lerp S, core/transform.py) is a handful of (N, 3, 3)
matmuls, and the prototype triangles are tested with a chunked dense
Moller-Trumbore (static shapes, no gathers on the hot path). Scenes
typically carry few moving instances, so this stays off the static sweep's
critical path while keeping motion exact per ray time.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.pytree import pytree, static_field
from ..core.transform import AnimatedTransform, Transform

_INF = jnp.inf
_CHUNK = 512  # prototype triangles per dense block


@pytree
class AnimatedInstances:
    """A small set of TRS-keyframed instances over shared prototypes."""

    # One AnimatedTransform per instance (object -> world), batched as a
    # tuple so per-instance Python loops stay static.
    xforms: Tuple[AnimatedTransform, ...]
    # (start, count) triangle range of each instance's prototype inside
    # the scene's (object-space) triangle buffer.
    ranges: Tuple[Tuple[int, int], ...] = static_field(default=())
    time0: float = static_field(default=0.0)
    time1: float = static_field(default=1.0)


def build_animated_instances(tri_verts, proto_ranges, pid, o2w0, o2w1,
                             times=(0.0, 1.0)) -> AnimatedInstances:
    """pid: (A,) prototype index per animated instance; o2w0/o2w1:
    (A, 4, 4) keyframe matrices; proto_ranges: triangle ranges per
    prototype."""
    xforms = []
    ranges = []
    for a in range(len(pid)):
        xforms.append(
            AnimatedTransform.build(
                Transform.from_matrix(np.asarray(o2w0[a], np.float32)),
                Transform.from_matrix(np.asarray(o2w1[a], np.float32)),
                time0=float(times[0]), time1=float(times[1]),
            )
        )
        ranges.append(tuple(proto_ranges[int(pid[a])]))
    return AnimatedInstances(
        xforms=tuple(xforms), ranges=tuple(ranges),
        time0=float(times[0]), time1=float(times[1]),
    )


def _inv3(m):
    """Batched analytic 3x3 inverse (adjugate / det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = jnp.stack(
        [
            jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        -2,
    )
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    return co / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)[..., None, None]


def _proto_mt(tris, o, d, t_best):
    """Chunked dense MT of rays (N,3) against a static triangle block
    (K, 3, 3). Returns (t (N,), prim_local (N,), u, v) with t=inf miss."""
    n = o.shape[0]
    k = tris.shape[0]
    t_out = jnp.full((n,), _INF, o.dtype)
    p_out = jnp.full((n,), -1, jnp.int32)
    u_out = jnp.zeros((n,), o.dtype)
    v_out = jnp.zeros((n,), o.dtype)
    for c0 in range(0, k, _CHUNK):
        blk = tris[c0 : c0 + _CHUNK]  # (B, 3, 3)
        v0 = blk[:, 0]
        e1 = blk[:, 1] - blk[:, 0]
        e2 = blk[:, 2] - blk[:, 0]
        pvec = jnp.cross(d[:, None, :], e2[None])  # (N, B, 3)
        det = jnp.sum(e1[None] * pvec, -1)
        inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = o[:, None, :] - v0[None]
        uk = jnp.sum(tvec * pvec, -1) * inv
        qvec = jnp.cross(tvec, e1[None])
        vk = jnp.sum(d[:, None, :] * qvec, -1) * inv
        tk = jnp.sum(e2[None] * qvec, -1) * inv
        hit = (
            (jnp.abs(det) > 1e-12) & (uk >= 0) & (vk >= 0)
            & (uk + vk <= 1) & (tk > 0)
            & (tk < jnp.minimum(t_best, t_out)[:, None])
        )
        tkh = jnp.where(hit, tk, _INF)
        arg = jnp.argmin(tkh, axis=1)
        t_new = jnp.take_along_axis(tkh, arg[:, None], 1)[:, 0]
        better = t_new < t_out
        t_out = jnp.where(better, t_new, t_out)
        p_out = jnp.where(better, c0 + arg.astype(jnp.int32), p_out)
        u_out = jnp.where(
            better, jnp.take_along_axis(uk, arg[:, None], 1)[:, 0], u_out
        )
        v_out = jnp.where(
            better, jnp.take_along_axis(vk, arg[:, None], 1)[:, 0], v_out
        )
    return t_out, p_out, u_out, v_out


@jax.named_scope("accel/animated_best")
def animated_best(anim: AnimatedInstances, geom, o, d, t_cur, time):
    """Closest hit against every animated instance at per-ray `time`.

    Returns (t, prim, u, v, ng, mat, light) with t=inf on miss; prim is a
    global geometry triangle id. t_cur prunes (only closer hits win)."""
    n = o.shape[0]
    if time is None:
        time = jnp.full((n,), 0.5 * (anim.time0 + anim.time1), o.dtype)
    t_b = jnp.where(jnp.isfinite(t_cur), t_cur, _INF)
    t_out = jnp.full((n,), _INF, o.dtype)
    p_out = jnp.full((n,), -1, jnp.int32)
    u_out = jnp.zeros((n,), o.dtype)
    v_out = jnp.zeros((n,), o.dtype)
    ng_out = jnp.zeros((n, 3), o.dtype)
    tri_verts = jnp.asarray(geom.tri_verts)
    for a, (start, count) in enumerate(anim.ranges):
        lin, tr = anim.xforms[a].interpolate_matrices(time)  # (N,3,3),(N,3)
        w2o = _inv3(lin)
        o_l = jnp.einsum("nij,nj->ni", w2o, o - tr, precision=jax.lax.Precision.HIGHEST)
        d_l = jnp.einsum("nij,nj->ni", w2o, d, precision=jax.lax.Precision.HIGHEST)  # unnormalized: t preserved
        tris = tri_verts[start : start + count]
        t_a, p_l, u_a, v_a = _proto_mt(
            tris, o_l, d_l, jnp.minimum(t_b, t_out)
        )
        better = t_a < jnp.minimum(t_b, t_out)
        prim_g = start + jnp.maximum(p_l, 0)
        # World-space geometric normal: transform the hit triangle's
        # edges by the per-ray interpolated linear part.
        tv = tri_verts[jnp.clip(prim_g, start, start + count - 1)]
        e1w = jnp.einsum(
            "nij,nj->ni", lin, tv[:, 1] - tv[:, 0], precision=jax.lax.Precision.HIGHEST
        )
        e2w = jnp.einsum(
            "nij,nj->ni", lin, tv[:, 2] - tv[:, 0], precision=jax.lax.Precision.HIGHEST
        )
        ngw = jnp.cross(e1w, e2w)
        ngw = ngw / jnp.maximum(
            jnp.linalg.norm(ngw, axis=-1, keepdims=True), 1e-20
        )
        t_out = jnp.where(better, t_a, t_out)
        p_out = jnp.where(better, prim_g, p_out)
        u_out = jnp.where(better, u_a, u_out)
        v_out = jnp.where(better, v_a, v_out)
        ng_out = jnp.where(better[:, None], ngw, ng_out)
    safe = jnp.clip(jnp.maximum(p_out, 0), 0, geom.num_triangles - 1)
    mat = jnp.asarray(geom.tri_mat)[safe]
    light = jnp.full((n,), -1, jnp.int32)  # no emissive instances
    return t_out, p_out, u_out, v_out, ng_out, mat, light


@jax.named_scope("accel/animated_any")
def animated_any(anim: AnimatedInstances, geom, o, d, tmax, time):
    """Occlusion against animated instances at per-ray time."""
    t, prim, _, _, _, _, _ = animated_best(anim, geom, o, d, tmax, time)
    return prim >= 0

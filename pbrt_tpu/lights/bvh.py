"""Many-light BVH sampler (Conty Estevez & Kulla adaptive tree splitting).

Reference analogue: BVHLightSampler + LightBounds + CompactLightBounds
(/root/reference/src/pbrt/lightsamplers.h:102-320, lights.h:104). The C++
builds a pointer tree of 32-byte quantized nodes and walks it with a
data-dependent loop per shading point; here the tree is flattened at build
time (host numpy) into one packed (n_nodes, 16) f32 matrix, and traversal is
a fixed-depth lax.scan of masked stochastic descents — every ray fetches its
current node's two children with one row gather and descends by relative
importance. Nodes stay unquantized f32 (one 64-byte row per node) rather
than the reference's bit-packing (octahedral axis + 15-bit cosine).

PMF evaluation (needed for MIS when a BSDF ray lands on a light) replays the
descent along the light's precomputed root->leaf path: build records, per
light, the (chosen child, sibling, side) ids at every tree level, so the
product of branch probabilities is another fixed-depth masked scan.

Sampled-vs-PMF consistency is gated by tests/test_lightbvh.py, mirroring
/root/reference/src/pbrt/lightsamplers_test.cpp.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.gather import gather_rows
from ..core.pytree import pytree, static_field

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Host-side build
# ---------------------------------------------------------------------------


def _cone_union(w1, t1, w2, t2):
    """Union of two direction cones (axis, spread angle); DirectionCone::
    Union (util/vecmath.h:1787) semantics."""
    if t1 >= np.pi or t2 >= np.pi:
        return np.array([0.0, 0.0, 1.0]), np.pi
    cos_d = float(np.clip(np.dot(w1, w2), -1.0, 1.0))
    theta_d = np.arccos(cos_d)
    # One cone inside the other?
    if min(theta_d + t2, np.pi) <= t1:
        return w1, t1
    if min(theta_d + t1, np.pi) <= t2:
        return w2, t2
    theta_o = (t1 + t2 + theta_d) / 2.0
    if theta_o >= np.pi:
        return np.array([0.0, 0.0, 1.0]), np.pi
    # Rotate w1 toward w2 by (theta_o - t1).
    theta_r = theta_o - t1
    axis = np.cross(w1, w2)
    norm = np.linalg.norm(axis)
    if norm < 1e-9:
        return w1, theta_o
    axis = axis / norm
    c, s = np.cos(theta_r), np.sin(theta_r)
    w = (
        w1 * c
        + np.cross(axis, w1) * s
        + axis * np.dot(axis, w1) * (1.0 - c)
    )
    return w / np.linalg.norm(w), theta_o


def _orientation_measure(theta_o, theta_e):
    """Solid-angle measure of a light cone's emission directions —
    M_Omega from Conty Estevez & Kulla 2018 (the SAOH cost's orientation
    term; reference LightBounds cost in lightsamplers.cpp)."""
    theta_w = min(theta_o + theta_e, np.pi)
    s_o = np.sin(theta_o)
    return 2.0 * np.pi * (1.0 - np.cos(theta_o)) + (np.pi / 2.0) * (
        2.0 * theta_w * s_o
        - np.cos(theta_o - 2.0 * theta_w)
        + 2.0 * theta_o * s_o
        + np.cos(theta_o)
    )


class _Bounds:
    __slots__ = ("lo", "hi", "w", "theta_o", "theta_e", "phi", "two")

    def __init__(self, lo, hi, w, theta_o, theta_e, phi, two):
        self.lo, self.hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
        self.w = np.asarray(w, np.float64)
        self.theta_o, self.theta_e = float(theta_o), float(theta_e)
        self.phi = float(phi)
        self.two = bool(two)

    def union(self, o: "_Bounds") -> "_Bounds":
        w, theta_o = _cone_union(self.w, self.theta_o, o.w, o.theta_o)
        return _Bounds(
            np.minimum(self.lo, o.lo),
            np.maximum(self.hi, o.hi),
            w,
            theta_o,
            max(self.theta_e, o.theta_e),
            self.phi + o.phi,
            self.two or o.two,
        )

    def cost(self) -> float:
        ext = np.maximum(self.hi - self.lo, 0.0)
        area = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])
        return self.phi * _orientation_measure(self.theta_o, self.theta_e) * (
            area + 1e-8
        )


def light_bounds_arrays(lights) -> list:
    """Per-positional-light _Bounds for [area | point | spot] lights, in
    global light-index order. Reference: DiffuseAreaLight/PointLight/
    SpotLight::Bounds (lights.cpp)."""
    out = []
    av = np.asarray(lights.area_verts)
    a_sc = np.asarray(lights.area_scale)
    a_co = np.asarray(lights.area_coeffs)
    a_two = np.asarray(lights.area_two_sided)
    a_area = np.asarray(lights.area_area)
    for i in range(av.shape[0]):
        v = av[i]
        n = np.cross(v[1] - v[0], v[2] - v[0])
        nn = np.linalg.norm(n)
        n = n / nn if nn > 0 else np.array([0.0, 0.0, 1.0])
        # phi ~ scale * area * pi (sigmoid coeff mean ~ rgb mean; the exact
        # spectral integral only changes relative importance mildly)
        phi = float(a_sc[i]) * float(a_area[i]) * np.pi * (
            2.0 if a_two[i] else 1.0
        )
        out.append(
            _Bounds(v.min(0), v.max(0), n, 0.0, np.pi / 2.0, max(phi, 1e-9),
                    bool(a_two[i]))
        )
    # Emissive analytic spheres: normals span the full direction sphere
    # (Sphere::NormalBounds == EntireSphere), so theta_o = pi like a point
    # light; phi = scale * 4 pi r^2 * pi.
    qc = np.asarray(lights.sphl_c)
    qr = np.asarray(lights.sphl_r)
    q_sc = np.asarray(lights.sphl_scale)
    q_two = np.asarray(lights.sphl_two)
    for i in range(qc.shape[0]):
        r = float(qr[i])
        phi = float(q_sc[i]) * 4.0 * np.pi * r * r * np.pi * (
            2.0 if q_two[i] else 1.0
        )
        out.append(
            _Bounds(qc[i] - r, qc[i] + r, np.array([0.0, 0.0, 1.0]),
                    np.pi, np.pi / 2.0, max(phi, 1e-9), bool(q_two[i]))
        )
    pp = np.asarray(lights.point_p)
    p_sc = np.asarray(lights.point_scale)
    for i in range(pp.shape[0]):
        phi = 4.0 * np.pi * float(p_sc[i])
        out.append(
            _Bounds(pp[i], pp[i], np.array([0.0, 0.0, 1.0]), np.pi,
                    np.pi / 2.0, max(phi, 1e-9), False)
        )
    sp = np.asarray(lights.spot_p)
    sdir = np.asarray(lights.spot_dir)
    s_sc = np.asarray(lights.spot_scale)
    s_c1 = np.asarray(lights.spot_cos_end)
    for i in range(sp.shape[0]):
        theta_e = float(np.arccos(np.clip(s_c1[i], -1.0, 1.0)))
        solid = 2.0 * np.pi * (1.0 - float(s_c1[i]))
        phi = float(s_sc[i]) * solid
        out.append(
            _Bounds(sp[i], sp[i], sdir[i], 0.0, theta_e, max(phi, 1e-9),
                    False)
        )
    # Projection lights: cone around the projection axis (ProjectionLight::
    # Bounds, lights.cpp); goniometric: point-like full sphere.
    jp = np.asarray(lights.proj_p)
    j_rot = np.asarray(lights.proj_rot)
    j_tan = np.asarray(lights.proj_tan)
    j_sc = np.asarray(lights.proj_scale_tx)
    for i in range(jp.shape[0]):
        theta_e = float(np.arctan(float(j_tan[i]) * np.sqrt(2.0)))
        solid = 2.0 * np.pi * (1.0 - np.cos(theta_e))
        phi = float(j_sc[i].mean()) * solid
        out.append(
            _Bounds(jp[i], jp[i], j_rot[i, 2], 0.0, theta_e,
                    max(phi, 1e-9), False)
        )
    gp = np.asarray(lights.gonio_p)
    g_sc = np.asarray(lights.gonio_scale_tx)
    for i in range(gp.shape[0]):
        phi = 4.0 * np.pi * float(g_sc[i].mean())
        out.append(
            _Bounds(gp[i], gp[i], np.array([0.0, 0.0, 1.0]), np.pi,
                    np.pi / 2.0, max(phi, 1e-9), False)
        )
    return out


def pack_light_records(lbs) -> np.ndarray:
    """Pack per-light _Bounds into the (L, 16) record layout
    node_importance reads (the LightBVH leaf layout). Used by the
    ExhaustiveLightSampler, which evaluates every light's importance
    directly (reference: ExhaustiveLightSampler, base/lightsampler.h:29 /
    lightsamplers.cpp) — the brute-force oracle the BVH descent
    approximates."""
    packed = np.zeros((len(lbs), 16), np.float32)
    for i, b in enumerate(lbs):
        packed[i, 0:3] = b.lo
        packed[i, 3:6] = b.hi
        packed[i, 6:9] = b.w
        packed[i, 9] = np.cos(b.theta_o)
        packed[i, 10] = np.cos(b.theta_e)
        packed[i, 11] = b.phi
        packed[i, 12] = float(i)
        packed[i, 13] = -1.0
        packed[i, 14] = 1.0 if b.two else 0.0
    return packed


def exhaustive_importance(recs, p, n_ref):
    """(N, L) importance of every light record at every shading point."""
    import jax

    n = p.shape[0]

    def one(rec):
        return node_importance(
            jnp.broadcast_to(rec[None, :], (n, 16)), p, n_ref
        )

    return jnp.transpose(jax.vmap(one)(recs))  # (N, L)


@pytree
class LightBVH:
    """Flattened light tree + per-light descent paths."""

    # Packed per-node record, 16 f32 columns:
    # 0:3 lo, 3:6 hi, 6:9 axis w, 9 cos_theta_o, 10 cos_theta_e, 11 phi,
    # 12 child0/light-idx, 13 child1 (-1 => leaf), 14 two_sided, 15 pad.
    nodes: jnp.ndarray  # (n_nodes, 16) f32
    # Descent replay per light: visited (chosen, sibling) node ids per level,
    # -1 padded. (L, D, 2) int32 packed as float-safe int32 array.
    paths: jnp.ndarray  # (L, D, 2) int32
    path_len: jnp.ndarray  # (L,) int32
    max_depth: int = static_field(default=0)
    n_lights: int = static_field(default=0)

    @staticmethod
    def build(lights) -> "LightBVH | None":
        lbs = light_bounds_arrays(lights)
        nl = len(lbs)
        if nl == 0:
            return None
        nodes = []  # dicts: b, c0, c1, light

        def emit(b, light=-1, c0=-1, c1=-1):
            nodes.append({"b": b, "light": light, "c0": c0, "c1": c1})
            return len(nodes) - 1

        def build_rec(idxs):
            if len(idxs) == 1:
                return emit(lbs[idxs[0]], light=idxs[0])
            tot = lbs[idxs[0]]
            for i in idxs[1:]:
                tot = tot.union(lbs[i])
            me = emit(tot)
            cents = np.stack(
                [(lbs[i].lo + lbs[i].hi) * 0.5 for i in idxs]
            )
            ext = cents.max(0) - cents.min(0)
            axis = int(np.argmax(ext))
            if ext[axis] < 1e-12:
                half = len(idxs) // 2
                order = list(idxs)
            else:
                # 12-bucket SAOH sweep (reference lightsamplers.cpp
                # buildBVH): minimize cost(left)+cost(right).
                order = sorted(idxs, key=lambda i: (lbs[i].lo + lbs[i].hi)[
                    axis
                ])
                nb = min(12, len(order) - 1)
                best_cost, half = np.inf, len(order) // 2
                marks = [
                    max(1, min(len(order) - 1,
                               round(k * len(order) / (nb + 1))))
                    for k in range(1, nb + 1)
                ]
                for m in sorted(set(marks)):
                    bl = lbs[order[0]]
                    for i in order[1:m]:
                        bl = bl.union(lbs[i])
                    br = lbs[order[m]]
                    for i in order[m + 1:]:
                        br = br.union(lbs[i])
                    c = bl.cost() + br.cost()
                    if c < best_cost:
                        best_cost, half = c, m
            c0 = build_rec(order[:half])
            c1 = build_rec(order[half:])
            nodes[me]["c0"], nodes[me]["c1"] = c0, c1
            return me

        build_rec(list(range(nl)))

        nn = len(nodes)
        packed = np.zeros((nn, 16), np.float32)
        for i, nd in enumerate(nodes):
            b = nd["b"]
            packed[i, 0:3] = b.lo
            packed[i, 3:6] = b.hi
            packed[i, 6:9] = b.w
            packed[i, 9] = np.cos(b.theta_o)
            packed[i, 10] = np.cos(b.theta_e)
            packed[i, 11] = b.phi
            if nd["c1"] < 0:
                packed[i, 12] = float(nd["light"])
                packed[i, 13] = -1.0
            else:
                packed[i, 12] = float(nd["c0"])
                packed[i, 13] = float(nd["c1"])
            packed[i, 14] = 1.0 if b.two else 0.0

        # Root->leaf replay paths.
        paths = {}

        def walk(node, trail):
            nd = nodes[node]
            if nd["c1"] < 0:
                paths[nd["light"]] = list(trail)
                return
            walk(nd["c0"], trail + [(nd["c0"], nd["c1"])])
            walk(nd["c1"], trail + [(nd["c1"], nd["c0"])])

        walk(0, [])
        depth = max((len(t) for t in paths.values()), default=0)
        parr = np.full((nl, max(depth, 1), 2), -1, np.int32)
        plen = np.zeros((nl,), np.int32)
        for li, trail in paths.items():
            plen[li] = len(trail)
            for k, (c, s) in enumerate(trail):
                parr[li, k, 0] = c
                parr[li, k, 1] = s
        return LightBVH(
            nodes=jnp.asarray(packed),
            paths=jnp.asarray(parr),
            path_len=jnp.asarray(plen),
            max_depth=depth,
            n_lights=nl,
        )


# ---------------------------------------------------------------------------
# Device-side importance / traversal
# ---------------------------------------------------------------------------


def _cos_sub(cos_a, sin_a, cos_b, sin_b):
    """cos(max(0, theta_a - theta_b)) given the four sin/cos values
    (reference LightBounds::Importance's CosSubClamped, lights.h:104)."""
    return jnp.where(cos_a < cos_b, cos_a * cos_b + sin_a * sin_b, 1.0)


def _sin_sub(cos_a, sin_a, cos_b, sin_b):
    return jnp.where(cos_a < cos_b, sin_a * cos_b - cos_a * sin_b, 0.0)


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def node_importance(rec, p, n_ref):
    """Importance of a packed node record (N, 16) for shading points p (N,3)
    with optional surface normals n_ref (N,3) or None.

    Reference: LightBounds::Importance (lights.cpp; quantized variant
    CompactLightBounds::Importance, lightsamplers.h:198-228).
    """
    lo, hi = rec[:, 0:3], rec[:, 3:6]
    w = rec[:, 6:9]
    cos_o, cos_e = rec[:, 9], rec[:, 10]
    phi = rec[:, 11]
    two = rec[:, 14] > 0.5

    pc = 0.5 * (lo + hi)
    dvec = p - pc
    d2 = jnp.sum(dvec * dvec, axis=-1)
    diag = hi - lo
    r2 = 0.25 * jnp.sum(diag * diag, axis=-1)
    d2c = jnp.maximum(d2, r2)  # don't explode inside the bounds
    wi = dvec / jnp.sqrt(jnp.maximum(d2, _EPS))[..., None]

    cos_w = jnp.sum(w * wi, axis=-1)
    cos_w = jnp.where(two, jnp.abs(cos_w), cos_w)
    sin_w = _safe_sqrt(1.0 - cos_w * cos_w)

    sin2_u = jnp.minimum(r2 / jnp.maximum(d2, _EPS), 1.0)
    sin_u = jnp.sqrt(sin2_u)
    cos_u = _safe_sqrt(1.0 - sin2_u)

    sin_o = _safe_sqrt(1.0 - cos_o * cos_o)
    cos_wo = _cos_sub(cos_w, sin_w, cos_o, sin_o)
    sin_wo = _sin_sub(cos_w, sin_w, cos_o, sin_o)
    cos_x = _cos_sub(cos_wo, sin_wo, cos_u, sin_u)

    imp = jnp.where(cos_x > cos_e, phi * cos_x / d2c, 0.0)
    if n_ref is not None:
        cos_i = jnp.abs(jnp.sum(wi * n_ref, axis=-1))
        sin_i = _safe_sqrt(1.0 - cos_i * cos_i)
        # All-zero normals mean "no surface orientation" (e.g. the previous
        # vertex was a medium scatter): skip the incident-cosine factor.
        has_n = jnp.sum(n_ref * n_ref, axis=-1) > 0.5
        imp = imp * jnp.where(
            has_n, _cos_sub(cos_i, sin_i, cos_u, sin_u), 1.0
        )
    return jnp.maximum(imp, 0.0)


def sample(bvh: LightBVH, p, n_ref, u):
    """Stochastic descent: returns (light_idx (N,) int32, pmf (N,)).

    light_idx == -1 (pmf 0) when every branch importance vanishes.
    Reference: BVHLightSampler::Sample (lightsamplers.h:260-320).
    """
    import jax

    n = p.shape[0]
    if bvh.n_lights == 1:
        return jnp.zeros((n,), jnp.int32), jnp.ones((n,), p.dtype)

    def step(carry, _):
        node, u, pmf, done, dead = carry
        rec = gather_rows(bvh.nodes, node)
        is_leaf = rec[:, 13] < 0.0
        light = jnp.round(rec[:, 12]).astype(jnp.int32)
        c0 = jnp.clip(jnp.round(rec[:, 12]).astype(jnp.int32), 0, None)
        c1 = jnp.clip(jnp.round(rec[:, 13]).astype(jnp.int32), 0, None)
        r0 = gather_rows(bvh.nodes, c0)
        r1 = gather_rows(bvh.nodes, c1)
        i0 = node_importance(r0, p, n_ref)
        i1 = node_importance(r1, p, n_ref)
        tot = i0 + i1
        q0 = jnp.where(tot > 0.0, i0 / jnp.maximum(tot, _EPS), 0.0)
        go0 = u < q0
        # Remap u to keep stratification (SampleDiscrete remap).
        u_next = jnp.where(
            go0,
            u / jnp.maximum(q0, _EPS),
            (u - q0) / jnp.maximum(1.0 - q0, _EPS),
        )
        u_next = jnp.clip(u_next, 0.0, 1.0 - 1e-7)
        q = jnp.where(go0, q0, 1.0 - q0)
        nxt = jnp.where(go0, c0, c1)
        act = ~done & ~dead & ~is_leaf
        dead = dead | (act & (tot <= 0.0))
        step_ok = act & (tot > 0.0)
        carry = (
            jnp.where(step_ok, nxt, node),
            jnp.where(step_ok, u_next, u),
            jnp.where(step_ok, pmf * q, pmf),
            done | (~dead & is_leaf),
            dead,
        )
        return carry, None

    init = (
        jnp.zeros((n,), jnp.int32),
        u,
        jnp.ones((n,), p.dtype),
        jnp.zeros((n,), bool),
        jnp.zeros((n,), bool),
    )
    (node, _, pmf, done, dead), _ = jax.lax.scan(
        step, init, None, length=bvh.max_depth + 1
    )
    rec = gather_rows(bvh.nodes, node)
    light = jnp.round(rec[:, 12]).astype(jnp.int32)
    ok = done & ~dead
    return jnp.where(ok, light, -1), jnp.where(ok, pmf, 0.0)


def pmf(bvh: LightBVH, p, n_ref, light_idx):
    """Probability that `sample` picks light_idx at shading point p.

    Replays the light's stored root->leaf branch choices.
    Reference: BVHLightSampler::PMF (lightsamplers.h:300-320).
    """
    import jax

    n = p.shape[0]
    if bvh.n_lights == 1:
        return jnp.ones((n,), p.dtype)
    li = jnp.clip(light_idx, 0, bvh.n_lights - 1)
    # (N, D, 2) per-ray descent path.
    path = gather_rows(bvh.paths.reshape(bvh.n_lights, -1), li).reshape(
        n, -1, 2
    ).astype(jnp.int32)
    plen = gather_rows(bvh.path_len, li)

    def step(carry, k):
        prob = carry
        chosen = path[:, k, 0]
        sibling = path[:, k, 1]
        valid = k < plen
        rc = gather_rows(bvh.nodes, jnp.clip(chosen, 0, None))
        rs = gather_rows(bvh.nodes, jnp.clip(sibling, 0, None))
        ic = node_importance(rc, p, n_ref)
        is_ = node_importance(rs, p, n_ref)
        tot = ic + is_
        q = jnp.where(tot > 0.0, ic / jnp.maximum(tot, _EPS), 0.0)
        return jnp.where(valid, prob * q, prob), None

    prob, _ = jax.lax.scan(
        step, jnp.ones((n,), p.dtype), jnp.arange(bvh.paths.shape[1])
    )
    return jnp.where(light_idx >= 0, prob, 0.0)

"""Brute-force (dense) ray-scene intersection, blocked over primitives.

Every ray tests every primitive in lockstep with no divergence and no
gathers in the inner loop; it is the plain XLA oracle the Pallas kernels
(ops/) are tested against. The per-block running minimum is carried through
a lax.scan so peak memory is O(N_rays * BLOCK).

Layout note: all inner-loop arithmetic is on (N_rays, BLOCK) component
arrays, so the primitive-block axis is the vectorized one rather than an
extent-3 (x, y, z) axis.

Reference analogue: the ray-triangle test of
/root/reference/src/pbrt/shapes.h:820-833 (Moller-Trumbore here; watertight
Woop-style transform is a later refinement) and Sphere::Intersect quadrics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.gather import gather_rows
from ..core.vecmath import cross, dot, normalize
from ..shapes.geometry import GeometryBuffers, Interaction

_TRI_BLOCK = 2048  # primitives per scan step; multiple of 128
_LANE = 128
_DET_EPS = 1e-12
INF = jnp.inf


def _pad_lanes(n: int) -> int:
    return max(_LANE, ((n + _LANE - 1) // _LANE) * _LANE)


def _tri_soa(tri_verts):
    """(T,3,3) -> component SOA padded to a lane multiple: dict of (Tp,) arrays."""
    t = tri_verts.shape[0]
    tp = _pad_lanes(t)
    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    out = {}
    # Raw v1/v2 ride along (not reconstructed from the edges): the
    # watertight tester needs the EXACT shared vertices so adjacent
    # triangles see bitwise-identical edge functions.
    for name, arr in (("v0", v0), ("e1", e1), ("e2", e2),
                      ("v1", tri_verts[:, 1]), ("v2", tri_verts[:, 2])):
        for c, ax in (("x", 0), ("y", 1), ("z", 2)):
            out[name + c] = jnp.pad(arr[:, ax], (0, tp - t))
    return out, tp


def _intersect_tri_block(o, d, tmax, blk):
    """Moller-Trumbore on (N, B) component arrays.

    o, d: (N, 3); tmax: (N,); blk: dict of (B,) triangle components.
    Returns (t, u, v) each (N, B), t = inf where missed.
    """
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]  # (N, 1)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    e1x, e1y, e1z = blk["e1x"][None], blk["e1y"][None], blk["e1z"][None]  # (1, B)
    e2x, e2y, e2z = blk["e2x"][None], blk["e2y"][None], blk["e2z"][None]
    v0x, v0y, v0z = blk["v0x"][None], blk["v0y"][None], blk["v0z"][None]

    # p = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz  # (N, B)
    inv_det = jnp.where(jnp.abs(det) > _DET_EPS, 1.0 / det, 0.0)
    # tvec = o - v0
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # q = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (
        (jnp.abs(det) > _DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
        & (t < tmax[:, None])
    )
    return jnp.where(hit, t, INF), u, v


def _intersect_tri_block_wt(o, d, tmax, blk):
    """Watertight ray-triangle test (shapes.h:820-930, Woop et al.):
    translate to the ray origin, permute axes so |d_z| is maximal, shear
    to align the ray with +z, then signed 2D edge functions decide the
    hit. Edge functions are computed with DifferenceOfProducts (correctly
    rounded), so the shared edge of two adjacent triangles yields exactly
    negated values — a ray through the edge registers on at least one of
    the two triangles (no cracks). Replaces the reference's
    double-precision fallback (float64 is disabled under JAX's default
    config; a correctly-rounded f32 product difference serves the same
    sign-stability purpose).

    o, d: (N, 3); tmax: (N,); blk: (B,) component dict (needs raw
    v0/v1/v2). Returns (t, u, v) each (N, B), t = inf where missed.
    """
    from ..core.floats import difference_of_products as dop

    ax, ay, az = jnp.abs(d[:, 0:1]), jnp.abs(d[:, 1:2]), jnp.abs(d[:, 2:3])
    kz = jnp.where(
        (az >= ax) & (az >= ay), 2, jnp.where(ay >= ax, 1, 0)
    )  # (N, 1)

    def permute(cx, cy, cz):
        """Per-ray axis rotation so component kz lands in z."""
        px = jnp.where(kz == 0, cy, jnp.where(kz == 1, cz, cx))
        py = jnp.where(kz == 0, cz, jnp.where(kz == 1, cx, cy))
        pz = jnp.where(kz == 0, cx, jnp.where(kz == 1, cy, cz))
        return px, py, pz

    dxp, dyp, dzp = permute(d[:, 0:1], d[:, 1:2], d[:, 2:3])
    # Winding consistency: if d_z < 0, swap x and y (shapes.h:842).
    neg = dzp < 0.0
    dxp, dyp = jnp.where(neg, dyp, dxp), jnp.where(neg, dxp, dyp)
    sx = -dxp / dzp
    sy = -dyp / dzp
    sz = 1.0 / dzp

    xs, ys, zs = [], [], []
    for vname in ("v0", "v1", "v2"):
        cx = blk[vname + "x"][None] - o[:, 0:1]
        cy = blk[vname + "y"][None] - o[:, 1:2]
        cz = blk[vname + "z"][None] - o[:, 2:3]
        px, py, pz = permute(cx, cy, cz)
        px, py = jnp.where(neg, py, px), jnp.where(neg, px, py)
        xs.append(px + sx * pz)
        ys.append(py + sy * pz)
        zs.append(sz * pz)
    x0, x1, x2 = xs
    y0, y1, y2 = ys
    z0, z1, z2 = zs

    e0 = dop(x1, y2, y1, x2)
    e1_ = dop(x2, y0, y2, x0)
    e2_ = dop(x0, y1, y0, x1)
    same_sign = ((e0 >= 0) & (e1_ >= 0) & (e2_ >= 0)) | (
        (e0 <= 0) & (e1_ <= 0) & (e2_ <= 0)
    )
    det = e0 + e1_ + e2_
    zt = e0 * z0 + e1_ * z1 + e2_ * z2
    # Sign-aware t window test before the division (shapes.h:886-893).
    tm = tmax[:, None]
    bad_neg = (det < 0) & ((zt >= 0) | (zt < tm * det))
    bad_pos = (det > 0) & ((zt <= 0) | (zt > tm * det))
    hit = same_sign & (det != 0) & ~bad_neg & ~bad_pos
    inv_det = jnp.where(det != 0, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    t = zt * inv_det
    u = e1_ * inv_det  # barycentric weight of v1 (MT's u)
    v = e2_ * inv_det
    return jnp.where(hit, t, INF), u, v


# Watertight triangles are the production dense tester (robust shared
# edges); the Pallas kernels keep Moller-Trumbore — matching the
# reference's own CPU(watertight)/GPU(hardware-MT) split.
WATERTIGHT = True


def _tri_block_tester():
    return _intersect_tri_block_wt if WATERTIGHT else _intersect_tri_block


def _sph_soa(sph):
    s = sph.shape[0]
    sp = _pad_lanes(s)
    out = {
        "cx": jnp.pad(sph[:, 0], (0, sp - s)),
        "cy": jnp.pad(sph[:, 1], (0, sp - s)),
        "cz": jnp.pad(sph[:, 2], (0, sp - s)),
        "r": jnp.pad(sph[:, 3], (0, sp - s)),  # padded radius 0 => never hits
    }
    return out, sp


def _intersect_sph_block(o, d, tmax, blk):
    """Ray-sphere on (N, B) components -> t (N, B), inf where missed.

    Runs the quadratic through ULP-widened interval arithmetic
    (core/interval.py), the robustness scheme of the reference's
    Sphere::BasicIntersect (shapes.h:110-180): catastrophic cancellation
    in b^2 - 4ac for distant/grazing spheres widens the root interval
    instead of silently flipping the hit decision; the accept/reject
    tests use the conservative interval bounds."""
    from ..core.interval import Interval

    ex = Interval.exact
    ocx = ex(o[:, 0:1]) - ex(blk["cx"][None])
    ocy = ex(o[:, 1:2]) - ex(blk["cy"][None])
    ocz = ex(o[:, 2:3]) - ex(blk["cz"][None])
    dx, dy, dz = ex(d[:, 0:1]), ex(d[:, 1:2]), ex(d[:, 2:3])
    a = dx.sqr() + dy.sqr() + dz.sqr()
    b = (ocx * dx + ocy * dy + ocz * dz) * ex(2.0)
    r = blk["r"][None]
    c = ocx.sqr() + ocy.sqr() + ocz.sqr() - ex(r).sqr()
    # Cancellation-free discriminant (shapes.h:118-136): the closest
    # approach f = oc - (b/2a) d has no large-magnitude cancellation, and
    # discrim = 4a (r + |f|)(r - |f|) keeps the grazing decision sharp
    # where b^2 - 4ac in f32 is pure noise.
    half_t = b / (a * ex(2.0))
    fx = ocx - half_t * dx
    fy = ocy - half_t * dy
    fz = ocz - half_t * dz
    len_sq = fx.sqr() + fy.sqr() + fz.sqr()
    flen = Interval(
        lo=jnp.sqrt(jnp.maximum(len_sq.lo, 0.0)),
        hi=jnp.sqrt(jnp.maximum(len_sq.hi, 0.0)),
    )
    ri = ex(r)
    disc = (ri + flen) * (ri - flen) * a * ex(4.0)
    has = disc.hi >= 0.0
    root = Interval(
        lo=jnp.sqrt(jnp.maximum(disc.lo, 0.0)),
        hi=jnp.sqrt(jnp.maximum(disc.hi, 0.0)),
    )
    # Stable quadratic (interval.h Quadratic): q = -0.5 (b ± root),
    # t0 = q/a, t1 = c/q, ordered.
    neg_b = b.lo < 0.0  # b is far from 0 whenever it matters
    q = Interval(
        lo=jnp.where(neg_b, -0.5 * (b.lo - root.hi),
                     -0.5 * (b.hi + root.hi)),
        hi=jnp.where(neg_b, -0.5 * (b.hi - root.lo),
                     -0.5 * (b.lo + root.lo)),
    )
    q = Interval(lo=jnp.minimum(q.lo, q.hi), hi=jnp.maximum(q.lo, q.hi))
    ra = q / a
    rb = c / q
    t0 = Interval(
        lo=jnp.minimum(ra.lo, rb.lo), hi=jnp.minimum(ra.hi, rb.hi)
    )
    t1 = Interval(
        lo=jnp.maximum(ra.lo, rb.lo), hi=jnp.maximum(ra.hi, rb.hi)
    )
    # Reference accept logic (shapes.h:137-146): reject when the nearer
    # root starts beyond tmax or the farther root can't be positive;
    # take t0 unless it may be behind the origin, then t1.
    tm = tmax[:, None]
    use_t0 = t0.lo > 0.0
    pick_lo = jnp.where(use_t0, t0.lo, t1.lo)
    pick_hi = jnp.where(use_t0, t0.hi, t1.hi)
    t_mid = 0.5 * (pick_lo + pick_hi)
    # Newton-refine the midpoint: the interval only BOUNDS the root
    # (width grows with distance); two steps of t <- t - f(t)/f'(t) on
    # f(t) = |oc + t d|^2 - r^2, evaluated at the advanced point where
    # the cancellation is mild, recover full float32 accuracy — the
    # role of the reference's hit-point reprojection (shapes.h:152).
    ocx_m, ocy_m, ocz_m = (
        0.5 * (iv.lo + iv.hi) for iv in (ocx, ocy, ocz)
    )
    dxm, dym, dzm = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    for _ in range(2):
        qx = ocx_m + t_mid * dxm
        qy = ocy_m + t_mid * dym
        qz = ocz_m + t_mid * dzm
        f = qx * qx + qy * qy + qz * qz - r * r
        fp = 2.0 * (qx * dxm + qy * dym + qz * dzm)
        t_mid = t_mid - f / jnp.where(jnp.abs(fp) < 1e-12, 1e-12, fp)
    hit = (
        has
        & (r > 0.0)
        & (t0.lo <= tm)
        & (t1.hi > 0.0)
        & (pick_hi <= tm)
        & (t_mid > 0.0)
    )
    return jnp.where(hit, t_mid, INF)


def _crv_soa(crv):
    """(C,8) [p0 p1 r0 r1] -> component SOA padded to a lane multiple."""
    c = crv.shape[0]
    cpad = _pad_lanes(c)
    names = ("ax", "ay", "az", "bx", "by", "bz", "r0", "r1")
    out = {
        n: jnp.pad(crv[:, i], (0, cpad - c)) for i, n in enumerate(names)
    }
    return out, cpad


def _crv_soa_full(geom):
    """Curve SOA including the per-segment curve-parameter span."""
    out, cpad = _crv_soa(geom.crv)
    c = geom.num_curves
    out["u0"] = jnp.pad(geom.crv_u[:, 0], (0, cpad - c))
    out["u1"] = jnp.pad(geom.crv_u[:, 1], (0, cpad - c))
    return out, cpad


def _intersect_crv_block(o, d, tmax, blk):
    """Ray vs round curve segment on (N, B) components.

    The reference's leaf test (shapes.cpp Curve::RecursiveIntersect, final
    depth): closest approach between the ray and the segment axis, hit when
    the perpendicular distance is within the lerped local radius. t is pulled
    forward by sqrt(r^2 - dist^2) so round curves occlude like thin cylinders.

    Returns (t, s, hsign) each (N, B): s = fraction along the segment,
    hsign = signed offset / radius in [-1, 1] (HairBxDF's h, sign from the
    (ray x tangent) binormal).
    """
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    axp, ayp, azp = blk["ax"][None], blk["ay"][None], blk["az"][None]
    ux = blk["bx"][None] - axp
    uy = blk["by"][None] - ayp
    uz = blk["bz"][None] - azp
    w0x = axp - ox
    w0y = ayp - oy
    w0z = azp - oz

    A = ux * ux + uy * uy + uz * uz
    B = ux * dx + uy * dy + uz * dz
    D = ux * w0x + uy * w0y + uz * w0z
    E = dx * w0x + dy * w0y + dz * w0z
    denom = A - B * B
    s = jnp.where(denom > 1e-12, (B * E - D) / jnp.where(denom > 1e-12, denom, 1.0), 0.0)
    s = jnp.clip(s, 0.0, 1.0)
    t_ca = s * B + E  # ray parameter of closest approach
    # Perpendicular offset vector c = (o + t*d) - (a + s*u)
    cx = t_ca * dx - w0x - s * ux
    cy = t_ca * dy - w0y - s * uy
    cz = t_ca * dz - w0z - s * uz
    dist2 = cx * cx + cy * cy + cz * cz
    r = blk["r0"][None] + s * (blk["r1"][None] - blk["r0"][None])
    thick = jnp.sqrt(jnp.maximum(r * r - dist2, 0.0))
    t = t_ca - thick
    hit = (
        (dist2 <= r * r)
        & (r > 0.0)
        & (t > 1e-5)
        & (t < tmax[:, None])
    )
    # Signed offset: binormal = d x tangent (unnormalized scale cancels in
    # the sign; magnitude from dist/r keeps |h| correct).
    bnx = dy * uz - dz * uy
    bny = dz * ux - dx * uz
    bnz = dx * uy - dy * ux
    side = cx * bnx + cy * bny + cz * bnz
    h = jnp.sqrt(dist2) / jnp.maximum(r, 1e-12)
    h = jnp.clip(jnp.where(side >= 0.0, h, -h), -1.0, 1.0)
    return jnp.where(hit, t, INF), s, h


def _fold_min(best, t_blk, u_blk, v_blk, block_base):
    """Fold a block's per-ray minima into the running (t, idx, u, v).

    Gather-free: per-row argmin + fancy indexing (t_blk[n, arg]) lowers to
    per-element gathers on this backend (~3 ms / 64k rows); a min-reduce
    plus equality-masked reduces does the same selection in pure vector ops.
    """
    t_new = jnp.min(t_blk, axis=1)
    cols = jnp.arange(t_blk.shape[1], dtype=jnp.int32)[None, :]
    eq = t_blk == t_new[:, None]
    # Resolve ties to ONE column (the largest index) so u/v stay paired.
    arg = jnp.max(jnp.where(eq, cols, -1), axis=1)
    one = eq & (cols == arg[:, None])
    u_new = jnp.sum(jnp.where(one, u_blk, 0.0), axis=1)
    v_new = jnp.sum(jnp.where(one, v_blk, 0.0), axis=1)
    better = t_new < best[0]
    return (
        jnp.where(better, t_new, best[0]),
        jnp.where(better, block_base + arg, best[1]),
        jnp.where(better, u_new, best[2]),
        jnp.where(better, v_new, best[3]),
    )


def _scan_tri_blocks(soa, tp, o, d, tmax, fold, init):
    """Apply fold(carry, blk, base) over lane-aligned triangle blocks."""
    if tp <= _TRI_BLOCK:
        return fold(init, soa, jnp.int32(0))
    n_blocks = (tp + _TRI_BLOCK - 1) // _TRI_BLOCK
    tpad = n_blocks * _TRI_BLOCK
    blocked = {
        k: jnp.pad(a, (0, tpad - tp)).reshape(n_blocks, _TRI_BLOCK)
        for k, a in soa.items()
    }
    bases = jnp.arange(n_blocks, dtype=jnp.int32) * _TRI_BLOCK

    def body(carry, xs):
        blk, base = xs
        return fold(carry, blk, base), None

    out, _ = jax.lax.scan(body, init, (blocked, bases))
    return out


def intersect_closest_tri(geom: GeometryBuffers, o, d, tmax=None):
    """Triangle-family-only closest hit: (t (inf=miss), prim (-1=miss),
    u, v) — the dense oracle counterpart of the Pallas kernels' deferred
    output, for the api-level alpha restart loop."""
    n_rays = o.shape[0]
    if tmax is None:
        tmax = jnp.full((n_rays,), INF, o.dtype)
    best = (
        jnp.full((n_rays,), INF, o.dtype),
        jnp.full((n_rays,), -1, jnp.int32),
        jnp.zeros((n_rays,), o.dtype),
        jnp.zeros((n_rays,), o.dtype),
    )
    if geom.num_triangles > 0:
        soa, tp = _tri_soa(geom.tri_verts)

        def fold(carry, blk, base):
            t, u, v = _tri_block_tester()(o, d, tmax, blk)
            return _fold_min(carry, t, u, v, base)

        best = _scan_tri_blocks(soa, tp, o, d, tmax, fold, best)
    return best


def intersect_closest(geom: GeometryBuffers, o, d, tmax=None) -> Interaction:
    """Closest-hit query for a batch of rays.

    o, d: (N, 3); tmax: (N,) or None. Returns an Interaction with geometric
    outward normals (winding / outward-facing for spheres); callers
    face-forward as needed.
    """
    n_rays = o.shape[0]
    if tmax is None:
        tmax = jnp.full((n_rays,), INF, o.dtype)

    best = (
        jnp.full((n_rays,), INF, o.dtype),
        jnp.full((n_rays,), -1, jnp.int32),
        jnp.zeros((n_rays,), o.dtype),
        jnp.zeros((n_rays,), o.dtype),
    )

    n_tri = geom.num_triangles
    if n_tri > 0:
        soa, tp = _tri_soa(geom.tri_verts)

        def fold(carry, blk, base):
            t, u, v = _tri_block_tester()(o, d, tmax, blk)
            return _fold_min(carry, t, u, v, base)

        best = _scan_tri_blocks(soa, tp, o, d, tmax, fold, best)

    n_sph = geom.num_spheres
    if n_sph > 0:
        sblk, _ = _sph_soa(geom.sph)
        t_s = _intersect_sph_block(o, d, tmax, sblk)
        zeros = jnp.zeros_like(t_s)
        best = _fold_min(
            (best[0], best[1], best[2], best[3]),
            jnp.where(
                jnp.arange(t_s.shape[1])[None, :] < n_sph, t_s, INF
            ),
            zeros,
            zeros,
            jnp.int32(n_tri),
        )

    if geom.num_curves > 0:
        soa, cp = _crv_soa_full(geom)

        def foldc(carry, blk, base):
            t, s, h = _intersect_crv_block(o, d, tmax, blk)
            u_g = blk["u0"][None] + s * (blk["u1"][None] - blk["u0"][None])
            return _fold_min(carry, t, u_g, 0.5 * (h + 1.0), base)

        best = _scan_tri_blocks(
            soa, cp, o, d, tmax, foldc,
            (best[0], best[1] - jnp.int32(n_tri + n_sph), best[2], best[3]),
        )
        best = (best[0], best[1] + jnp.int32(n_tri + n_sph), best[2], best[3])

    return assemble_interaction(geom, o, d, best)


def assemble_interaction(geom: GeometryBuffers, o, d, best) -> Interaction:
    """Build the Interaction SOA from a (t, prim_idx, u, v) best-hit tuple.

    prim index ranges: [0, T) triangles, [T, T+S) spheres, [T+S, T+S+C)
    curve segments.
    """
    n_rays = o.shape[0]
    n_tri = geom.num_triangles
    n_sph = geom.num_spheres
    n_crv = geom.num_curves
    t, idx, u, v = best
    valid = idx >= 0
    idx_safe = jnp.maximum(idx, 0)
    p = o + t[:, None] * d
    p = jnp.where(valid[:, None], p, 0.0)

    is_tri = valid & (idx < n_tri)
    if n_tri > 0:
        tri_idx = jnp.clip(idx_safe, 0, n_tri - 1)
        tv = gather_rows(geom.tri_verts, tri_idx)
        n_tri_geo = normalize(cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))
        mat_tri = gather_rows(geom.tri_mat, tri_idx)
        light_tri = gather_rows(geom.tri_light, tri_idx)
    else:
        n_tri_geo = jnp.zeros_like(o)
        mat_tri = jnp.zeros((n_rays,), jnp.int32)
        light_tri = jnp.full((n_rays,), -1, jnp.int32)

    if n_sph > 0:
        sph_idx = jnp.clip(idx_safe - n_tri, 0, n_sph - 1)
        sc = gather_rows(geom.sph, sph_idx)
        n_sph_geo = normalize(p - sc[:, :3])
        mat_sph = gather_rows(geom.sph_mat, sph_idx)
        light_sph = gather_rows(geom.sph_light, sph_idx)
    else:
        n_sph_geo = jnp.zeros_like(o)
        mat_sph = jnp.zeros((n_rays,), jnp.int32)
        light_sph = jnp.full((n_rays,), -1, jnp.int32)

    if n_sph > 0:
        # Spherical uv (shapes.h Sphere::Intersect): u = phi/2pi,
        # v = 1 - theta/pi (full sphere; see accel/api.py note).
        is_sph = valid & (idx >= n_tri) & (idx < n_tri + n_sph)
        phi_s = jnp.arctan2(n_sph_geo[:, 1], n_sph_geo[:, 0])
        u_s = jnp.where(phi_s < 0, phi_s + 2 * jnp.pi, phi_s) / (
            2 * jnp.pi)
        v_s = 1.0 - jnp.arccos(
            jnp.clip(n_sph_geo[:, 2], -1.0, 1.0)) / jnp.pi
        u = jnp.where(is_sph, u_s, u)
        v = jnp.where(is_sph, v_s, v)

    ng = jnp.where(is_tri[:, None], n_tri_geo, n_sph_geo)
    mat = jnp.where(is_tri, mat_tri, mat_sph)
    light = jnp.where(is_tri, light_tri, light_sph)
    dpdu = jnp.zeros_like(o)

    if n_crv > 0:
        is_crv = valid & (idx >= n_tri + n_sph)
        crv_idx = jnp.clip(idx_safe - n_tri - n_sph, 0, n_crv - 1)
        cr = gather_rows(geom.crv, crv_idx)
        tang = normalize(cr[:, 3:6] - cr[:, 0:3])
        # Camera-facing normal perpendicular to the fiber axis: the hair
        # BSDF's frame needs only (tangent, any consistent normal-plane
        # basis); the azimuthal origin pairs with hsign from the ray test.
        wo = -d
        n_c = wo - dot(tang, wo, keepdims=True) * tang
        n_c = n_c / jnp.maximum(
            jnp.linalg.norm(n_c, axis=-1, keepdims=True), 1e-12
        )
        ng = jnp.where(is_crv[:, None], n_c, ng)
        mat = jnp.where(is_crv, gather_rows(geom.crv_mat, crv_idx), mat)
        light = jnp.where(is_crv, -1, light)
        dpdu = jnp.where(is_crv[:, None], tang, dpdu)

    return Interaction(
        valid=valid,
        t=t,
        p=p,
        n=ng,
        uv=jnp.stack([u, v], axis=-1),
        wo=-d,
        mat=jnp.where(valid, mat, 0),
        light=jnp.where(valid, light, -1),
        prim=idx,
        dpdu=dpdu,
    )


def intersect_any(geom: GeometryBuffers, o, d, tmax) -> jnp.ndarray:
    """Occlusion (shadow-ray) query: True where any hit with t < tmax.

    Reference analogue: IntersectP / the wavefront shadow pipeline
    (src/pbrt/wavefront/integrator.cpp TraceShadowRays).
    """
    n_rays = o.shape[0]
    occluded = jnp.zeros((n_rays,), bool)

    if geom.num_triangles > 0:
        soa, tp = _tri_soa(geom.tri_verts)

        def fold(carry, blk, base):
            t, _, _ = _tri_block_tester()(o, d, tmax, blk)
            return carry | jnp.any(jnp.isfinite(t), axis=1)

        occluded = _scan_tri_blocks(soa, tp, o, d, tmax, fold, occluded)

    if geom.num_spheres > 0:
        sblk, _ = _sph_soa(geom.sph)
        t_s = _intersect_sph_block(o, d, tmax, sblk)
        occluded = occluded | jnp.any(jnp.isfinite(t_s), axis=1)

    if geom.num_curves > 0:
        csoa, cp = _crv_soa(geom.crv)

        def foldc(carry, blk, base):
            t, _, _ = _intersect_crv_block(o, d, tmax, blk)
            return carry | jnp.any(jnp.isfinite(t), axis=1)

        occluded = _scan_tri_blocks(csoa, cp, o, d, tmax, foldc, occluded)

    return occluded


def curve_best(geom: GeometryBuffers, o, d, tmax):
    """Best curve-segment hit for merging into an accel path's result.

    Returns (t, seg_idx, u, v) with seg_idx = -1 on miss; u is the global
    curve parameter, v = (h + 1) / 2.
    """
    n_rays = o.shape[0]
    init = (
        jnp.full((n_rays,), INF, o.dtype),
        jnp.full((n_rays,), -1, jnp.int32),
        jnp.zeros((n_rays,), o.dtype),
        jnp.zeros((n_rays,), o.dtype),
    )
    soa, cp = _crv_soa_full(geom)

    def foldc(carry, blk, base):
        t, s, h = _intersect_crv_block(o, d, tmax, blk)
        u_g = blk["u0"][None] + s * (blk["u1"][None] - blk["u0"][None])
        return _fold_min(carry, t, u_g, 0.5 * (h + 1.0), base)

    return _scan_tri_blocks(soa, cp, o, d, tmax, foldc, init)


def offset_ray_origin(p, n, d):
    """Spawn-ray origin offset to avoid self-intersection.

    The reference computes exact FP error bounds (interaction.h SpawnRay /
    OffsetRayOrigin); we use a scale-aware epsilon along the geometric normal,
    signed toward the outgoing direction.
    """
    scale = jnp.maximum(1.0, jnp.max(jnp.abs(p), axis=-1, keepdims=True))
    eps = 1e-4 * scale
    sign = jnp.where(dot(n, d, keepdims=True) >= 0.0, 1.0, -1.0)
    return p + sign * eps * n


def shadow_segment(p, n, wi, dist):
    """Robust shadow segment from a surface point to a light sample.

    Reference analogue: Interaction::SpawnRayTo (interaction.h:236) — both
    ray endpoints are offset off their surfaces and tMax is parametric in
    the re-aimed segment. Offsetting only the origin and keeping the
    original (wi, dist) is NOT robust: at grazing angles the normal offset
    shifts where the ray crosses the light's plane by eps/|wi.n_l|, which
    can exceed the relative shortening and self-hit the light (seen as
    fully-occluded NEE from surfaces nearly coplanar with the light).

    Returns (origin, direction, t_max); infinite dist (delta/infinite
    lights) keeps the original direction with a large t_max.
    """
    so = offset_ray_origin(p, n, wi)
    finite = jnp.isfinite(dist)
    dist_f = jnp.where(finite, dist, 1.0)
    target = p + wi * dist_f[..., None]
    seg = target - so
    seg_len = jnp.maximum(
        jnp.sqrt(jnp.sum(seg * seg, axis=-1)), 1e-20
    )
    wi2 = jnp.where(finite[..., None], seg / seg_len[..., None], wi)
    smax = jnp.where(finite, seg_len * (1.0 - 1e-3), 1e30)
    return so, wi2, smax


# --- Analytic disk / cylinder quadrics (Disk/Cylinder, shapes.h) ------------


def disk_best(geom: GeometryBuffers, o, d, tmax):
    """Best analytic-disk hit: (t, idx, u, v); idx -1 on miss.

    Disk row: [center(3) normal(3) radius inner]; uv = (phi/2pi, radial).
    Reference: Disk::Intersect (shapes.h plane solve + radius window).
    """
    n_rays = o.shape[0]
    if tmax is None:
        tmax = jnp.full((n_rays,), INF, o.dtype)
    dk = geom.disk
    nd = geom.num_disks
    c = dk[None, :, 0:3]
    nrm = dk[None, :, 3:6]
    r = dk[None, :, 6]
    ri = dk[None, :, 7]
    denom = jnp.sum(d[:, None, :] * nrm, axis=-1)
    denom = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
    t = jnp.sum((c - o[:, None, :]) * nrm, axis=-1) / denom
    p = o[:, None, :] + t[..., None] * d[:, None, :]
    rel = p - c
    dist2 = jnp.sum(rel * rel, axis=-1)
    hit = (
        (t > 1e-5) & (t < tmax[:, None])
        & (dist2 <= r * r) & (dist2 >= ri * ri)
    )
    tm = jnp.where(hit, t, INF)
    idx = jnp.argmin(tm, axis=1).astype(jnp.int32)
    tb = jnp.min(tm, axis=1)
    sel = jnp.take_along_axis
    pick = lambda a: sel(a, idx[:, None], axis=1)[:, 0]
    phi = jnp.arctan2(
        pick(rel[..., 1]), pick(rel[..., 0])
    ) / (2.0 * jnp.pi) + 0.5
    rad = jnp.sqrt(jnp.maximum(pick(dist2), 0.0)) / jnp.maximum(
        pick(jnp.broadcast_to(r, dist2.shape)), 1e-9
    )
    ok = jnp.isfinite(tb) & (nd > 0)
    return (
        jnp.where(ok, tb, INF),
        jnp.where(ok, idx, -1),
        jnp.where(ok, phi, 0.0),
        jnp.where(ok, rad, 0.0),
    )


def cyl_best(geom: GeometryBuffers, o, d, tmax):
    """Best analytic-cylinder hit (open tube): (t, idx, u, v).

    Cylinder row: [base_point(3) axis(3) radius half_len]; the tube spans
    axial coordinate [-half_len, +half_len] about base_point.
    Reference: Cylinder::Intersect quadratic (shapes.h).
    """
    n_rays = o.shape[0]
    if tmax is None:
        tmax = jnp.full((n_rays,), INF, o.dtype)
    cy = geom.cyl
    nc = geom.num_cyls
    pa = cy[None, :, 0:3]
    ax = cy[None, :, 3:6]
    r = cy[None, :, 6]
    h = cy[None, :, 7]
    rel = o[:, None, :] - pa
    d_ax = jnp.sum(d[:, None, :] * ax, axis=-1)
    rel_ax = jnp.sum(rel * ax, axis=-1)
    d_perp = d[:, None, :] - d_ax[..., None] * ax
    rel_perp = rel - rel_ax[..., None] * ax
    a = jnp.sum(d_perp * d_perp, axis=-1)
    b = 2.0 * jnp.sum(d_perp * rel_perp, axis=-1)
    cq = jnp.sum(rel_perp * rel_perp, axis=-1) - r * r
    disc = b * b - 4.0 * a * cq
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    a_safe = jnp.where(jnp.abs(a) < 1e-12, 1e-12, a)
    t0 = (-b - sq) / (2.0 * a_safe)
    t1 = (-b + sq) / (2.0 * a_safe)

    def axial_ok(t):
        z = rel_ax + t * d_ax
        return (jnp.abs(z) <= h) & (t > 1e-5) & (t < tmax[:, None])

    ok0 = (disc > 0.0) & axial_ok(t0)
    ok1 = (disc > 0.0) & axial_ok(t1)
    t = jnp.where(ok0, t0, jnp.where(ok1, t1, INF))
    tm = jnp.where(jnp.isfinite(t), t, INF)
    idx = jnp.argmin(tm, axis=1).astype(jnp.int32)
    tb = jnp.min(tm, axis=1)
    pick = lambda arr: jnp.take_along_axis(arr, idx[:, None], axis=1)[:, 0]
    z = pick(rel_ax) + tb * pick(d_ax)
    v = jnp.clip((z / jnp.maximum(pick(jnp.broadcast_to(h, rel_ax.shape)),
                                  1e-9) + 1.0) * 0.5, 0.0, 1.0)
    ok = jnp.isfinite(tb) & (nc > 0)
    return (
        jnp.where(ok, tb, INF),
        jnp.where(ok, idx, -1),
        jnp.where(ok, v, 0.0),  # u along the axis
        jnp.zeros_like(tb),
    )


def disk_cyl_normals(geom, o, d, t, kind_disk, idx):
    """Geometric normals for merged disk/cylinder hits."""
    from ..core.gather import gather_rows

    nd = max(geom.num_disks, 1)
    ncy = max(geom.num_cyls, 1)
    safe_d = jnp.clip(idx, 0, nd - 1)
    safe_c = jnp.clip(idx, 0, ncy - 1)
    p = o + t[:, None] * d
    if geom.num_disks > 0:
        n_disk = gather_rows(geom.disk, safe_d)[:, 3:6]
    else:
        n_disk = jnp.zeros_like(o)
    if geom.num_cyls > 0:
        row = gather_rows(geom.cyl, safe_c)
        pa, ax = row[:, 0:3], row[:, 3:6]
        rel = p - pa
        z = jnp.sum(rel * ax, axis=-1, keepdims=True)
        n_cyl = rel - z * ax
        n_cyl = n_cyl / jnp.maximum(
            jnp.linalg.norm(n_cyl, axis=-1, keepdims=True), 1e-9
        )
    else:
        n_cyl = jnp.zeros_like(o)
    return jnp.where(kind_disk[:, None], n_disk, n_cyl)


def blp_best(geom: GeometryBuffers, o, d, tmax):
    """Best analytic bilinear-patch hit: (t, idx, u, v); idx -1 on miss.

    Patch row: [p00 p10 p01 p11] (12 floats). Solves Reshetov's quadratic
    in u from the coplanarity determinant, then v and t per root
    (BilinearPatch::Intersect, shapes.h:1350 'Cool Patches' method).
    """
    n_rays = o.shape[0]
    if tmax is None:
        tmax = jnp.full((n_rays,), INF, o.dtype)
    bp = geom.blp
    p00 = bp[None, :, 0:3]
    p10 = bp[None, :, 3:6]
    p01 = bp[None, :, 6:9]
    p11 = bp[None, :, 9:12]
    e10 = p10 - p00
    e00 = p01 - p00
    E = p11 - p10 - p01 + p00
    q = p00 - o[:, None, :]
    dd = d[:, None, :]

    def det3(a, b, c):
        return jnp.sum(jnp.cross(a, b) * c, axis=-1)

    A = det3(e10, E, dd)
    B = det3(e10, e00, dd) + det3(q, E, dd)
    C = det3(q, e00, dd)
    # Robust quadratic (degenerates to linear for planar patches, A ~ 0).
    lin = jnp.abs(A) < 1e-12
    disc = B * B - 4.0 * A * C
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    qf = -0.5 * (B + jnp.sign(jnp.where(B == 0.0, 1.0, B)) * sq)
    A_s = jnp.where(lin, 1.0, A)
    u_a = jnp.where(lin, -C / jnp.where(jnp.abs(B) < 1e-12, 1e-12, B),
                    qf / A_s)
    u_b = jnp.where(lin, 2.0, C / jnp.where(jnp.abs(qf) < 1e-12, 1e-12, qf))
    valid_roots = jnp.where(lin[..., None],
                            jnp.stack([jnp.ones_like(disc),
                                       jnp.zeros_like(disc)], -1) > 0,
                            jnp.stack([disc >= 0.0, disc >= 0.0], -1))

    t_best = jnp.full(A.shape, INF)
    u_best = jnp.zeros(A.shape)
    v_best = jnp.zeros(A.shape)
    for r, uu in ((0, u_a), (1, u_b)):
        pu = q + uu[..., None] * e10
        gv = e00 + uu[..., None] * E
        pu_x_d = jnp.cross(pu, dd)
        gv_x_d = jnp.cross(gv, dd)
        denom = jnp.sum(gv_x_d * gv_x_d, axis=-1)
        vv = -jnp.sum(pu_x_d * gv_x_d, axis=-1) / jnp.where(
            denom < 1e-18, 1e-18, denom
        )
        tt = jnp.sum((pu + vv[..., None] * gv) * dd, axis=-1)
        ok = (
            valid_roots[..., r]
            & (uu >= -1e-5) & (uu <= 1.0 + 1e-5)
            & (vv >= -1e-5) & (vv <= 1.0 + 1e-5)
            & (tt > 1e-5) & (tt < tmax[:, None]) & (denom > 1e-18)
        )
        better = ok & (tt < t_best)
        t_best = jnp.where(better, tt, t_best)
        u_best = jnp.where(better, uu, u_best)
        v_best = jnp.where(better, vv, v_best)

    tm = jnp.where(jnp.isfinite(t_best), t_best, INF)
    idx = jnp.argmin(tm, axis=1).astype(jnp.int32)
    tb = jnp.min(tm, axis=1)
    pick = lambda a: jnp.take_along_axis(a, idx[:, None], axis=1)[:, 0]
    ok = jnp.isfinite(tb) & (geom.num_blps > 0)
    return (
        jnp.where(ok, tb, INF),
        jnp.where(ok, idx, -1),
        jnp.where(ok, pick(u_best), 0.0),
        jnp.where(ok, pick(v_best), 0.0),
    )


def blp_normal(geom, idx, u, v):
    """Geometric normal of bilinear-patch hits: cross(dP/du, dP/dv)."""
    from ..core.gather import gather_rows

    nb = max(geom.num_blps, 1)
    row = gather_rows(geom.blp, jnp.clip(idx, 0, nb - 1))
    p00, p10 = row[:, 0:3], row[:, 3:6]
    p01, p11 = row[:, 6:9], row[:, 9:12]
    e10 = p10 - p00
    e00 = p01 - p00
    E = p11 - p10 - p01 + p00
    du = e10 + v[:, None] * E
    dv = e00 + u[:, None] * E
    n = jnp.cross(du, dv)
    return n / jnp.maximum(
        jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12
    )

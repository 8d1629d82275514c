"""Curve shapes: cubic Béziers flattened to round linear segments.

Reference analogue: /root/reference/src/pbrt/shapes.h:1219 (Curve),
shapes.cpp Curve::RecursiveIntersect. The reference subdivides each Bézier
*per ray* down to a refinement depth chosen from its curvature, then runs a
ray-space linear-segment width test at the leaves. That data-dependent
recursion is hostile to XLA, so the design hoists the subdivision to
scene-build time: each curve is flattened ONCE into the number of linear
segments its curvature bound demands (the same log4 criterion the reference
uses to pick its recursion depth, shapes.cpp:1452-1460), and the per-ray
work is the identical leaf test — a branchless ray/segment closest-approach
with lerped width — over dense segment blocks.

The leaf test matches the reference's semantics: hit if the ray passes
within half the local width of the segment axis, u from the segment's span
of the curve parameter, v = (h+1)/2 where h in [-1,1] is the signed
perpendicular offset (the quantity HairBxDF consumes), dpdu = the curve
tangent.
"""

from __future__ import annotations

import numpy as np

CURVE_FLAT = 0
CURVE_CYLINDER = 1
CURVE_RIBBON = 2

_MAX_SEGS = 64


def bezier_eval(cp, t):
    """Evaluate cubic Bézier. cp: (..., 4, 3); t: (...,). Returns (..., 3)."""
    t = np.asarray(t)[..., None]
    p01 = (1 - t) * cp[..., 0, :] + t * cp[..., 1, :]
    p12 = (1 - t) * cp[..., 1, :] + t * cp[..., 2, :]
    p23 = (1 - t) * cp[..., 2, :] + t * cp[..., 3, :]
    p012 = (1 - t) * p01 + t * p12
    p123 = (1 - t) * p12 + t * p23
    return (1 - t) * p012 + t * p123


def segment_count(cp) -> int:
    """Segments needed so the flattened polyline stays within ~the width
    tolerance of the true curve (the reference's refinement criterion:
    L0 = max control-point second difference, depth = log4(1.41 L0 / eps),
    shapes.cpp:1452)."""
    d2 = cp[:-2] - 2.0 * cp[1:-1] + cp[2:]
    l0 = float(np.max(np.abs(d2))) if len(d2) else 0.0
    diag = float(np.max(np.ptp(cp, axis=0)))
    eps = max(diag, 1e-6) * 0.005
    if l0 <= eps:
        return 2
    r0 = int(np.log2(1.41421356 * 6.0 * l0 / (8.0 * eps)) / 2.0)
    depth = int(np.clip(r0, 1, 6))
    return min(1 << depth, _MAX_SEGS)


def flatten_curve(cp, width0, width1, u_range=(0.0, 1.0), n_segs=None):
    """Flatten one cubic Bézier into segment arrays.

    cp: (4, 3) control points (world space). Returns dict of arrays:
    p0, p1 (K, 3), r0, r1 (K,), u0, u1 (K,) — per-segment curve-parameter
    spans and *radii* (pbrt widths are full widths; radius = width/2).
    """
    cp = np.asarray(cp, np.float32).reshape(4, 3)
    k = int(n_segs) if n_segs is not None else segment_count(cp)
    t = np.linspace(0.0, 1.0, k + 1, dtype=np.float32)
    pts = bezier_eval(cp[None], t).astype(np.float32)  # (K+1, 3)
    ua, ub = u_range
    u = (ua + (ub - ua) * t).astype(np.float32)
    w = (width0 + (width1 - width0) * u).astype(np.float32)
    return {
        "p0": pts[:-1],
        "p1": pts[1:],
        "r0": 0.5 * w[:-1],
        "r1": 0.5 * w[1:],
        "u0": u[:-1],
        "u1": u[1:],
    }


def bspline_to_bezier(cp):
    """Uniform cubic B-spline control points (n>=4, 3) -> list of (4,3)
    Bézier spans (the reference converts bspline/catmull-rom bases the same
    way, shapes.cpp CreateCurve)."""
    cp = np.asarray(cp, np.float32)
    out = []
    for i in range(len(cp) - 3):
        p0, p1, p2, p3 = cp[i], cp[i + 1], cp[i + 2], cp[i + 3]
        b0 = (p0 + 4.0 * p1 + p2) / 6.0
        b1 = (4.0 * p1 + 2.0 * p2) / 6.0
        b2 = (2.0 * p1 + 4.0 * p2) / 6.0
        b3 = (p1 + 4.0 * p2 + p3) / 6.0
        out.append(np.stack([b0, b1, b2, b3]))
    return out


def build_curve_segments(curves):
    """curves: list of dicts {cp (4,3) or (n,3) bspline, width0, width1,
    basis: 'bezier'|'bspline', mat: int}. Returns packed arrays for
    GeometryBuffers: seg (C, 8) [p0 p1 r0 r1], seg_u (C, 2), seg_mat (C,)."""
    segs, seg_u, seg_mat = [], [], []
    for c in curves:
        cp = np.asarray(c["cp"], np.float32)
        basis = c.get("basis", "bezier")
        w0 = float(c.get("width0", c.get("width", 1.0)))
        w1 = float(c.get("width1", c.get("width", 1.0)))
        if basis == "bspline":
            spans = bspline_to_bezier(cp)
        else:
            spans = [cp[i: i + 4] for i in range(0, max(len(cp) - 3, 1), 3)]
        ns = len(spans)
        for j, span in enumerate(spans):
            ua, ub = j / ns, (j + 1) / ns
            f = flatten_curve(
                span,
                w0 + (w1 - w0) * ua,
                w0 + (w1 - w0) * ub,
                u_range=(ua, ub),
            )
            k = len(f["p0"])
            segs.append(
                np.concatenate(
                    [f["p0"], f["p1"], f["r0"][:, None], f["r1"][:, None]],
                    axis=1,
                )
            )
            seg_u.append(np.stack([f["u0"], f["u1"]], axis=1))
            seg_mat.append(np.full((k,), c.get("mat", 0), np.int32))
    if not segs:
        return (
            np.zeros((0, 8), np.float32),
            np.zeros((0, 2), np.float32),
            np.zeros((0,), np.int32),
        )
    return (
        np.concatenate(segs).astype(np.float32),
        np.concatenate(seg_u).astype(np.float32),
        np.concatenate(seg_mat),
    )

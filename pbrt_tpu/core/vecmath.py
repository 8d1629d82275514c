"""Vector geometry on batched (..., 3) arrays.

Counterpart of the reference's src/pbrt/util/vecmath.h (Point3f /
Vector3f / Normal3f / Frame / OctahedralVector). There are no vector *types*:
a point is any float array whose trailing axis has extent 3, and every routine
is batched over leading axes so it vectorizes.
"""

from __future__ import annotations

import jax.numpy as jnp

# A conservative machine epsilon helper mirroring pbrt's gamma(n) FP error
# bound (reference: src/pbrt/util/float.h:576 `gamma`).
MACHINE_EPS = float(jnp.finfo(jnp.float32).eps) * 0.5


def gamma(n: int) -> float:
    return (n * MACHINE_EPS) / (1 - n * MACHINE_EPS)


def dot(a, b, keepdims: bool = False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def absdot(a, b, keepdims: bool = False):
    return jnp.abs(dot(a, b, keepdims=keepdims))


def cross(a, b):
    return jnp.cross(a, b)


def length_squared(v, keepdims: bool = False):
    return jnp.sum(v * v, axis=-1, keepdims=keepdims)


def length(v, keepdims: bool = False):
    return jnp.sqrt(length_squared(v, keepdims=keepdims))


def normalize(v, eps: float = 1e-20):
    return v * jax_rsqrt(jnp.maximum(length_squared(v, keepdims=True), eps))


def jax_rsqrt(x):
    import jax.lax

    return jax.lax.rsqrt(x)


def distance(a, b):
    return length(a - b)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def safe_acos(x):
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


def face_forward(n, v):
    """Flip n so it lies in the same hemisphere as v."""
    s = jnp.sign(dot(n, v, keepdims=True))
    return n * jnp.where(s == 0, 1.0, s)


def coordinate_system(v):
    """Branchless orthonormal basis from a unit vector (Duff et al. 2017).

    Reference analogue: Frame::FromZ / CoordinateSystem
    (src/pbrt/util/vecmath.h:1855). Returns (t1, t2) with (t1, t2, v) an
    orthonormal right-handed frame.
    """
    z = v[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = v[..., 0] * v[..., 1] * a
    t1 = jnp.stack(
        [1.0 + sign * v[..., 0] * v[..., 0] * a, sign * b, -sign * v[..., 0]],
        axis=-1,
    )
    t2 = jnp.stack([b, sign + v[..., 1] * v[..., 1] * a, -v[..., 1]], axis=-1)
    return t1, t2


def shading_frame(ns, dpdu):
    """Shading-frame tangents (t1, t2) for normal ns and optional tangent.

    Where dpdu is nonzero (curve hits carry the fiber tangent) the frame is
    anchored to it — t1 = dpdu orthogonalized against ns — because HairBxDF
    measures longitudinal angles from the local x-axis (reference
    hair.h / SurfaceInteraction shading frame, interaction.h:285). Elsewhere
    falls back to the branchless Duff basis.
    """
    t1d, t2d = coordinate_system(ns)
    has_t = jnp.sum(dpdu * dpdu, axis=-1, keepdims=True) > 1e-12
    tang = dpdu - dot(dpdu, ns, keepdims=True) * ns
    norm = jnp.sqrt(jnp.maximum(jnp.sum(tang * tang, axis=-1, keepdims=True), 1e-24))
    t1c = tang / norm
    t1 = jnp.where(has_t, t1c, t1d)
    t2 = jnp.where(has_t, cross(ns, t1c), t2d)
    return t1, t2


def to_local(v, t1, t2, n):
    """World -> shading-local (z = n) coordinates."""
    return jnp.stack([dot(v, t1), dot(v, t2), dot(v, n)], axis=-1)


def from_local(v, t1, t2, n):
    """Shading-local -> world coordinates."""
    return (
        v[..., 0:1] * t1 + v[..., 1:2] * t2 + v[..., 2:3] * n
    )


def spherical_direction(sin_theta, cos_theta, phi):
    return jnp.stack(
        [
            jnp.clip(sin_theta, -1.0, 1.0) * jnp.cos(phi),
            jnp.clip(sin_theta, -1.0, 1.0) * jnp.sin(phi),
            jnp.clip(cos_theta, -1.0, 1.0),
        ],
        axis=-1,
    )


def spherical_theta(v):
    return safe_acos(v[..., 2])


def spherical_phi(v):
    p = jnp.arctan2(v[..., 1], v[..., 0])
    return jnp.where(p < 0.0, p + 2.0 * jnp.pi, p)


def reflect(wo, n):
    """Mirror reflection of wo about n (both pointing away from surface)."""
    return -wo + 2.0 * dot(wo, n, keepdims=True) * n


def refract(wi, n, eta):
    """Refract wi through the interface with normal n.

    Convention of pbrt's Refract (src/pbrt/util/scattering.h:37): eta is the
    relative IOR of the medium on the non-normal side over the normal side;
    if wi arrives from below n, both n and eta are flipped. `eta` must be
    broadcastable to wi[..., 0] (one relative IOR per ray).

    Returns (valid, wt, eta_eff): valid=False marks total internal reflection;
    eta_eff is the possibly-inverted relative IOR actually used.
    """
    cos_theta_i = dot(wi, n)
    flip = cos_theta_i < 0.0
    eta = jnp.where(flip, 1.0 / eta, eta)
    cos_theta_i = jnp.abs(cos_theta_i)
    n = jnp.where(flip[..., None], -n, n)
    sin2_theta_i = jnp.maximum(0.0, 1.0 - cos_theta_i * cos_theta_i)
    sin2_theta_t = sin2_theta_i / (eta * eta)
    valid = sin2_theta_t < 1.0  # total internal reflection otherwise
    cos_theta_t = safe_sqrt(1.0 - sin2_theta_t)
    wt = (
        -wi / eta[..., None]
        + (cos_theta_i / eta - cos_theta_t)[..., None] * n
    )
    return valid, wt, eta


def octahedral_encode(v):
    """Unit vector -> 2D octahedral coordinates in [-1, 1]^2.

    Reference analogue: OctahedralVector (src/pbrt/util/vecmath.h:1735); we
    keep float32 coordinates rather than 16-bit quantization (cheaper to decode).
    """
    d = jnp.sum(jnp.abs(v), axis=-1, keepdims=True)
    p = v[..., :2] / d
    x, y = p[..., 0], p[..., 1]
    neg = v[..., 2] < 0.0
    xo = jnp.where(neg, (1.0 - jnp.abs(y)) * jnp.where(x >= 0, 1.0, -1.0), x)
    yo = jnp.where(neg, (1.0 - jnp.abs(x)) * jnp.where(y >= 0, 1.0, -1.0), y)
    return jnp.stack([xo, yo], axis=-1)


def octahedral_decode(e):
    """Inverse of octahedral_encode."""
    x, y = e[..., 0], e[..., 1]
    z = 1.0 - jnp.abs(x) - jnp.abs(y)
    neg = z < 0.0
    xd = jnp.where(neg, (1.0 - jnp.abs(y)) * jnp.where(x >= 0, 1.0, -1.0), x)
    yd = jnp.where(neg, (1.0 - jnp.abs(x)) * jnp.where(y >= 0, 1.0, -1.0), y)
    return normalize(jnp.stack([xd, yd, z], axis=-1))


def equal_area_square_to_sphere(p):
    """Low-distortion [0,1]^2 -> unit sphere mapping (Clarberg 2008).

    Reference analogue: EqualAreaSquareToSphere (src/pbrt/util/vecmath.h),
    used for octahedral environment maps.
    """
    u = 2.0 * p[..., 0] - 1.0
    v = 2.0 * p[..., 1] - 1.0
    up = jnp.abs(u)
    vp = jnp.abs(v)
    sd = 1.0 - (up + vp)
    d = jnp.abs(sd)
    r = 1.0 - d
    phi = jnp.where(r == 0.0, 1.0, (vp - up) / jnp.where(r == 0.0, 1.0, r) + 1.0) * (
        jnp.pi / 4.0
    )
    z = jnp.sign(sd) * (1.0 - r * r)
    cos_phi = jnp.sign(u) * jnp.cos(phi)
    sin_phi = jnp.sign(v) * jnp.sin(phi)
    s = r * safe_sqrt(2.0 - r * r)
    return jnp.stack([cos_phi * s, sin_phi * s, z], axis=-1)


def equal_area_sphere_to_square(d):
    """Inverse of equal_area_square_to_sphere."""
    x = jnp.abs(d[..., 0])
    y = jnp.abs(d[..., 1])
    z = jnp.abs(d[..., 2])
    r = safe_sqrt(1.0 - z)
    a = jnp.maximum(x, y)
    b = jnp.minimum(x, y)
    b = jnp.where(a == 0.0, 0.0, b / jnp.where(a == 0.0, 1.0, a))
    # atan(b) on [0,1] scaled to [0, pi/4]
    phi = jnp.arctan(b) * (2.0 / jnp.pi)
    phi = jnp.where(x < y, 1.0 - phi, phi)
    v_ = phi * r
    u_ = r - v_
    # southern hemisphere: fold
    south = d[..., 2] < 0.0
    u2 = jnp.where(south, 1.0 - v_, u_)
    v2 = jnp.where(south, 1.0 - u_, v_)
    # Zero components must keep the fold (sign(0) == 0 would collapse the
    # -z pole onto the +z center); treat +0 as positive like copysign.
    u2 = jnp.where(d[..., 0] >= 0.0, u2, -u2)
    v2 = jnp.where(d[..., 1] >= 0.0, v2, -v2)
    return jnp.stack([0.5 * (u2 + 1.0), 0.5 * (v2 + 1.0)], axis=-1)


# --- DirectionCone (vecmath.h:573-660) --------------------------------------


from .pytree import pytree as _pytree  # noqa: E402


@_pytree
class DirectionCone:
    """Cone of directions: axis w + cos of the spread half-angle.

    Reference analogue: DirectionCone (util/vecmath.h:573), used by light
    bounds (CompactLightBounds) and BoundSubtendedDirections. cos_theta = 1
    is a single direction; cos_theta = -1 the whole sphere; an EMPTY cone is
    encoded with cos_theta = +2 (matches the reference sentinel ordering:
    any union with it returns the other cone).
    """

    w: jnp.ndarray  # (..., 3) unit axis
    cos_theta: jnp.ndarray  # (...,)

    @staticmethod
    def entire_sphere():
        return DirectionCone(
            w=jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
            cos_theta=jnp.asarray(-1.0, jnp.float32),
        )

    @staticmethod
    def from_direction(w):
        w = jnp.asarray(w, jnp.float32)
        return DirectionCone(
            w=w, cos_theta=jnp.ones(w.shape[:-1], jnp.float32)
        )

    @property
    def is_empty(self):
        return self.cos_theta > 1.0

    def inside(self, v):
        """Is direction v within the cone? (vecmath.h Inside)."""
        return (~self.is_empty) & (
            jnp.sum(normalize(v) * self.w, axis=-1) >= self.cos_theta
        )


def bound_subtended_directions(lo, hi, p):
    """DirectionCone of directions from p toward the AABB [lo, hi]
    (vecmath.h BoundSubtendedDirections): the cone around the center
    direction subtending the bounding sphere; whole sphere when p is
    inside that sphere."""
    center = 0.5 * (jnp.asarray(lo) + jnp.asarray(hi))
    radius = 0.5 * jnp.sqrt(jnp.sum((jnp.asarray(hi) - jnp.asarray(lo)) ** 2, -1))
    to_c = center - p
    d2 = jnp.sum(to_c * to_c, axis=-1)
    inside_sphere = d2 < radius * radius
    sin2 = jnp.clip(radius * radius / jnp.maximum(d2, 1e-12), 0.0, 1.0)
    cos_theta = jnp.sqrt(1.0 - sin2)
    w = to_c / jnp.maximum(jnp.sqrt(d2), 1e-12)[..., None]
    return DirectionCone(
        w=jnp.where(inside_sphere[..., None], jnp.zeros_like(w).at[..., 2].set(1.0), w),
        cos_theta=jnp.where(inside_sphere, -1.0, cos_theta),
    )


def direction_cone_union(a: DirectionCone, b: DirectionCone) -> DirectionCone:
    """Smallest cone containing both (vecmath.h Union, vectorized and
    branch-free: all four cases — either empty, containment both ways, and
    the general merged cone — are computed and where-selected)."""
    ta = jnp.arccos(jnp.clip(a.cos_theta, -1.0, 1.0))
    tb = jnp.arccos(jnp.clip(b.cos_theta, -1.0, 1.0))
    td = jnp.arccos(jnp.clip(jnp.sum(a.w * b.w, axis=-1), -1.0, 1.0))
    # b inside a / a inside b.
    b_in_a = jnp.minimum(td + tb, jnp.pi) <= ta
    a_in_b = jnp.minimum(td + ta, jnp.pi) <= tb
    # General case: spread angle around the rotated center axis.
    theta_o = 0.5 * (ta + td + tb)
    whole = theta_o >= jnp.pi
    theta_r = jnp.clip(theta_o - ta, 0.0, jnp.pi)
    # Rotate a.w toward b.w by theta_r.
    axis = jnp.cross(a.w, b.w)
    alen = jnp.sqrt(jnp.sum(axis * axis, axis=-1))
    degenerate = alen < 1e-8
    axis_n = axis / jnp.maximum(alen, 1e-12)[..., None]
    c = jnp.cos(theta_r)[..., None]
    s = jnp.sin(theta_r)[..., None]
    w_rot = (
        a.w * c
        + jnp.cross(axis_n, a.w) * s
        + axis_n * jnp.sum(axis_n * a.w, -1, keepdims=True) * (1.0 - c)
    )
    w_gen = jnp.where(degenerate[..., None], a.w, w_rot)
    cos_gen = jnp.where(whole, -1.0, jnp.cos(theta_o))

    w = jnp.where(
        a.is_empty[..., None], b.w,
        jnp.where(
            b.is_empty[..., None], a.w,
            jnp.where(
                b_in_a[..., None], a.w,
                jnp.where(a_in_b[..., None], b.w, w_gen),
            ),
        ),
    )
    ct = jnp.where(
        a.is_empty, b.cos_theta,
        jnp.where(
            b.is_empty, a.cos_theta,
            jnp.where(
                b_in_a, a.cos_theta,
                jnp.where(a_in_b, b.cos_theta, cos_gen),
            ),
        ),
    )
    return DirectionCone(w=w, cos_theta=ct)

"""Homogeneous transforms (4x4 matrix + cached inverse).

Reference analogue: /root/reference/src/pbrt/util/transform.h (Transform at
:26, AnimatedTransform at :444). A Transform is a pytree of (m, m_inv); all
application functions are batched over leading axes of their point/vector
arguments, so one Transform applies to millions of rays in one fused op.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .pytree import pytree, static_field


@pytree
class Transform:
    m: jnp.ndarray  # (4, 4)
    m_inv: jnp.ndarray  # (4, 4)

    @staticmethod
    def identity() -> "Transform":
        eye = jnp.eye(4, dtype=jnp.float32)
        return Transform(m=eye, m_inv=eye)

    @staticmethod
    def from_matrix(m) -> "Transform":
        m = jnp.asarray(m, dtype=jnp.float32)
        return Transform(m=m, m_inv=jnp.linalg.inv(m))

    def inverse(self) -> "Transform":
        return Transform(m=self.m_inv, m_inv=self.m)

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(m=self.m @ other.m, m_inv=other.m_inv @ self.m_inv)

    # -- application (batched over leading axes) --

    def apply_point(self, p):
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3].T + self.m[3, 3]
        return r / w[..., None]

    def apply_vector(self, v):
        return v @ self.m[:3, :3].T

    def apply_normal(self, n):
        # Normals transform by the inverse transpose.
        return n @ self.m_inv[:3, :3]

    def apply_ray(self, o, d):
        return self.apply_point(o), self.apply_vector(d)

    def swaps_handedness(self):
        return jnp.linalg.det(self.m[:3, :3]) < 0.0


def translate(delta) -> Transform:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = delta
    mi = np.eye(4, dtype=np.float32)
    mi[:3, 3] = -np.asarray(delta)
    return Transform(m=jnp.asarray(m), m_inv=jnp.asarray(mi))


def scale(s) -> Transform:
    s = np.broadcast_to(np.asarray(s, dtype=np.float32), (3,))
    m = np.diag(np.append(s, 1.0)).astype(np.float32)
    mi = np.diag(np.append(1.0 / s, 1.0)).astype(np.float32)
    return Transform(m=jnp.asarray(m), m_inv=jnp.asarray(mi))


def rotate(axis, angle_deg: float) -> Transform:
    """Rotation about an arbitrary axis (Rodrigues), matching pbrt Rotate."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    theta = np.deg2rad(angle_deg)
    s, c = np.sin(theta), np.cos(theta)
    K = np.array(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]], dtype=np.float64
    )
    r = np.eye(3) + s * K + (1 - c) * (K @ K)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r.astype(np.float32)
    mi = np.eye(4, dtype=np.float32)
    mi[:3, :3] = r.T.astype(np.float32)
    return Transform(m=jnp.asarray(m), m_inv=jnp.asarray(mi))


def rotate_x(angle_deg: float) -> Transform:
    return rotate((1.0, 0.0, 0.0), angle_deg)


def rotate_y(angle_deg: float) -> Transform:
    return rotate((0.0, 1.0, 0.0), angle_deg)


def rotate_z(angle_deg: float) -> Transform:
    return rotate((0.0, 0.0, 1.0), angle_deg)


def look_at(eye, target, up) -> Transform:
    """Camera-to-world transform, pbrt LookAt convention (left-handed:
    camera looks down +z; src/pbrt/util/transform.cpp LookAt)."""
    eye = np.asarray(eye, dtype=np.float64)
    dir_ = np.asarray(target, dtype=np.float64) - eye
    dir_ = dir_ / np.linalg.norm(dir_)
    up_n = np.asarray(up, dtype=np.float64)
    up_n = up_n / np.linalg.norm(up_n)
    right = np.cross(up_n, dir_)
    nr = np.linalg.norm(right)
    if nr < 1e-8:
        raise ValueError("LookAt: up vector parallel to viewing direction")
    right = right / nr
    new_up = np.cross(dir_, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = dir_
    m[:3, 3] = eye
    return Transform.from_matrix(m)


def perspective(fov_deg: float, z_near: float = 1e-2, z_far: float = 1000.0) -> Transform:
    """Perspective projection, pbrt convention (camera space -> NDC depth)."""
    inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, z_far / (z_far - z_near), -z_far * z_near / (z_far - z_near)],
            [0, 0, 1, 0],
        ],
        dtype=np.float32,
    )
    s = np.diag([inv_tan, inv_tan, 1.0, 1.0]).astype(np.float32)
    return Transform.from_matrix(jnp.asarray(s @ persp))


# --- AnimatedTransform (util/transform.h:444, transform.cpp) ----------------


@pytree
class AnimatedTransform:
    """Two keyframed rigid transforms interpolated over [t0, t1].

    Reference analogue: AnimatedTransform (util/transform.h:444): each
    keyframe matrix is decomposed into translation T, rotation R
    (quaternion) and scale/shear S (transform.cpp Decompose); interpolation
    is lerp(T) + slerp(R) + lerp(S), recomposed per ray time. All pieces are
    precomputed host-side; `interpolate` is a batched jittable recompose —
    one (N, 3, 3) matmul chain per ray instead of pbrt's per-ray branch
    tree.
    """

    t_start: jnp.ndarray  # (3,) translation at t0
    t_end: jnp.ndarray  # (3,)
    q_start: jnp.ndarray  # (4,) rotation quaternion at t0
    q_end: jnp.ndarray  # (4,)
    s_start: jnp.ndarray  # (3, 3) scale/shear at t0
    s_end: jnp.ndarray  # (3, 3)
    time0: float = static_field(default=0.0)
    time1: float = static_field(default=1.0)

    @staticmethod
    def build(start: "Transform", end: "Transform", time0: float = 0.0,
              time1: float = 1.0) -> "AnimatedTransform":
        from .quaternion import quat_from_matrix, quat_to_matrix

        def decompose(m):
            m = np.asarray(m)
            t = m[:3, 3]
            a = m[:3, :3]
            # Polar decomposition by iterated averaging with the inverse
            # transpose (transform.cpp Decompose).
            r = a.copy()
            for _ in range(100):
                r_next = 0.5 * (r + np.linalg.inv(r.T))
                if np.abs(r_next - r).max() < 1e-7:
                    r = r_next
                    break
                r = r_next
            s = np.linalg.inv(r) @ a
            return t, r, s

        t0v, r0, s0 = decompose(start.m)
        t1v, r1, s1 = decompose(end.m)
        q0 = quat_from_matrix(jnp.asarray(r0, jnp.float32))
        q1 = quat_from_matrix(jnp.asarray(r1, jnp.float32))
        # Keep the short rotation path.
        q1 = jnp.where(jnp.sum(q0 * q1) < 0.0, -q1, q1)
        del quat_to_matrix
        return AnimatedTransform(
            t_start=jnp.asarray(t0v, jnp.float32),
            t_end=jnp.asarray(t1v, jnp.float32),
            q_start=q0, q_end=q1,
            s_start=jnp.asarray(s0, jnp.float32),
            s_end=jnp.asarray(s1, jnp.float32),
            time0=float(time0), time1=float(time1),
        )

    def interpolate_matrices(self, time):
        """(N,) times -> (N, 3, 3) linear parts + (N, 3) translations."""
        from .quaternion import quat_to_matrix, slerp

        dt = jnp.clip(
            (time - self.time0) / max(self.time1 - self.time0, 1e-9),
            0.0, 1.0,
        )
        trans = (
            (1.0 - dt)[..., None] * self.t_start[None]
            + dt[..., None] * self.t_end[None]
        )
        q = slerp(self.q_start[None], self.q_end[None], dt)
        r = quat_to_matrix(q)
        s = (
            (1.0 - dt)[..., None, None] * self.s_start[None]
            + dt[..., None, None] * self.s_end[None]
        )
        return jnp.einsum("nij,njk->nik", r, s, precision=jax.lax.Precision.HIGHEST), trans

    def apply_point(self, p, time):
        lin, tr = self.interpolate_matrices(time)
        return jnp.einsum("nij,nj->ni", lin, p, precision=jax.lax.Precision.HIGHEST) + tr

    def apply_vector(self, v, time):
        lin, _ = self.interpolate_matrices(time)
        return jnp.einsum("nij,nj->ni", lin, v, precision=jax.lax.Precision.HIGHEST)

    def apply_ray(self, o, d, time):
        return self.apply_point(o, time), self.apply_vector(d, time)

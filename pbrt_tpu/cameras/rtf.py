"""RTF camera: polynomial ray-transfer-function optics.

Reference analogue: the ISET fork's RTFCamera
(/root/reference/src/pbrt/cameras.h:1088-1143 + rtf/passnopass.h): instead of
tracing lens elements, a fitted polynomial maps (film position, pupil sample)
-> output ray, with pass/no-pass pupil predicates for vignetting. The whole
camera is a fused polynomial evaluation.

This build stores dense multivariate monomial coefficients and also provides
`fit_from_camera`, which fits the polynomial TO a lens camera by tracing a
training batch through the element stack and solving least squares — i.e. the
offline Zemax/MATLAB fitting pipeline the reference expects as input data can
be reproduced natively from any LensStack.

Input features: (x, y, u, v) = film point (mm) and pupil sample in [-1,1].
Outputs: (ox, oy, oz, dx, dy, dz) at the front vertex plane + validity.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.pytree import pytree, static_field
from ..core.sampling import sample_uniform_disk_concentric
from ..core.transform import Transform
from ..core.vecmath import normalize


def _monomial_powers(degree: int):
    powers = []
    for total in range(degree + 1):
        for px in range(total + 1):
            for py in range(total - px + 1):
                for pu in range(total - px - py + 1):
                    pv = total - px - py - pu
                    powers.append((px, py, pu, pv))
    return powers


@pytree
class RTFCamera:
    camera_to_world: Transform
    coeffs: jnp.ndarray  # (n_terms, 6) output coefficients
    powers: jnp.ndarray  # (n_terms, 4) monomial powers
    pupil_radius_mm: jnp.ndarray  # ()
    front_z_mm: jnp.ndarray  # () plane where output rays originate
    resolution: tuple = static_field()
    film_semi_x_mm: float = static_field(default=12.0)
    film_semi_y_mm: float = static_field(default=12.0)
    degree: int = static_field(default=3)

    def _features(self, x, y, u, v):
        feats = []
        for px, py, pu, pv in np.asarray(self.powers):
            feats.append((x ** int(px)) * (y ** int(py)) * (u ** int(pu)) * (v ** int(pv)))
        return jnp.stack(feats, axis=-1)  # (..., n_terms)

    def generate_rays(self, p_film, u_lens):
        """Returns (o_world, d_world, weight)."""
        nx, ny = self.resolution
        x = (0.5 - p_film[..., 0] / nx) * 2.0 * self.film_semi_x_mm
        y = (p_film[..., 1] / ny - 0.5) * 2.0 * self.film_semi_y_mm
        disk = sample_uniform_disk_concentric(u_lens)
        u, v = disk[..., 0], disk[..., 1]
        f = self._features(x, y, u, v)  # (..., T)
        out = f @ self.coeffs  # (..., 6)
        o = jnp.stack(
            [out[..., 0], out[..., 1],
             jnp.broadcast_to(self.front_z_mm, x.shape)],
            axis=-1,
        )
        d = normalize(out[..., 3:6])
        # Pass/no-pass pupil: unit-disk predicate (rtf/passnopass.h's
        # circle-intersection form reduces to this for a single pupil).
        w = ((u * u + v * v) <= 1.0).astype(jnp.float32)
        # Degenerate polynomial output (|d| ~ 0) is a no-pass.
        w = w * (jnp.sum(out[..., 3:6] ** 2, axis=-1) > 1e-8).astype(
            jnp.float32
        )
        o_w = self.camera_to_world.apply_point(o)
        d_w = normalize(self.camera_to_world.apply_vector(d))
        return o_w, d_w, w


def fit_from_camera(
    lens_camera, degree: int = 3, n_train: int = 4096, seed: int = 0
) -> RTFCamera:
    """Fit an RTFCamera to a RealisticCamera/HumanEyeCamera by tracing a
    training set through its lens stack and solving least squares."""
    r = np.random.default_rng(seed)
    nx, ny = lens_camera.resolution
    p_film = np.stack(
        [r.uniform(0, nx, n_train), r.uniform(0, ny, n_train)], axis=-1
    ).astype(np.float32)
    u_lens = r.uniform(0, 1, (n_train, 2)).astype(np.float32)

    # Trace in the CAMERA frame: identity transform clone.
    cam_local = lens_camera.replace(camera_to_world=Transform.identity())
    o_c, d_c, w = cam_local.generate_rays(
        jnp.asarray(p_film), jnp.asarray(u_lens)
    )
    o_c, d_c = np.asarray(o_c), np.asarray(d_c)
    valid = np.asarray(w) > 0.5

    # Features at the same parameterization the RTF camera will use.
    if hasattr(lens_camera, "film_diag_mm"):
        aspect = nx / ny
        h = lens_camera.film_diag_mm / np.sqrt(1 + aspect * aspect)
        semi_x, semi_y = aspect * h / 2, h / 2
    else:
        semi_x = semi_y = lens_camera.retina_semi_diam_mm
    x = (0.5 - p_film[:, 0] / nx) * 2 * semi_x
    y = (p_film[:, 1] / ny - 0.5) * 2 * semi_y
    disk = np.asarray(
        sample_uniform_disk_concentric(jnp.asarray(u_lens))
    )
    u, v = disk[:, 0], disk[:, 1]

    powers = _monomial_powers(degree)
    feats = np.stack(
        [
            (x ** px) * (y ** py) * (u ** pu) * (v ** pv)
            for px, py, pu, pv in powers
        ],
        axis=-1,
    )[valid]
    front_z = float(np.median(o_c[valid, 2]))
    targets = np.concatenate([o_c[valid], d_c[valid]], axis=-1)
    coeffs, *_ = np.linalg.lstsq(feats, targets, rcond=None)

    front_r = float(
        np.percentile(np.hypot(o_c[valid, 0], o_c[valid, 1]), 99)
    )
    return RTFCamera(
        camera_to_world=lens_camera.camera_to_world,
        coeffs=jnp.asarray(coeffs, jnp.float32),
        powers=jnp.asarray(np.asarray(powers), jnp.int32),
        pupil_radius_mm=jnp.asarray(front_r, jnp.float32),
        front_z_mm=jnp.asarray(front_z, jnp.float32),
        resolution=lens_camera.resolution,
        film_semi_x_mm=float(semi_x),
        film_semi_y_mm=float(semi_y),
        degree=degree,
    )

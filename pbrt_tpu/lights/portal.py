"""Portal-image infinite light.

Reference analogue: PortalImageInfiniteLight (/root/reference/src/pbrt/
lights.h:738, lights.cpp): an environment image reparametrized in "portal
direction space" — the (alpha, beta) = (atan(x/z), atan(y/z)) angles in the
portal's frame — so the set of directions from ANY shading point through the
rectangular portal is an axis-aligned WINDOW of the image plane. Sampling a
direction through the portal = sampling the windowed image distribution
(WindowedPiecewiseConstant2D over the luminance), which concentrates every
NEE sample on the portal instead of rejection-sampling the whole sphere.

Geometry conventions: the portal is a planar rectangle given by 4 corners
(counter-clockwise seen from the lit side); its frame (x, y, z) has z toward
the lit interior. Escaped-ray radiance is windowed by the ray origin's
portal bounds, matching the reference's Le.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import rgb2spec
from ..core.pytree import pytree
from ..core.sampling import WindowedPiecewiseConstant2D
from ..core.vecmath import normalize

_PI = float(np.pi)


@pytree
class PortalLight:
    corners: jnp.ndarray  # (4, 3) portal rectangle, CCW from the lit side
    frame: jnp.ndarray  # (3, 3) rows x, y, z (z = normal toward interior)
    coeffs: jnp.ndarray  # (H, W, 3) per-texel unbounded spectrum fits
    scale_tx: jnp.ndarray  # (H, W)
    dist: WindowedPiecewiseConstant2D
    strength: jnp.ndarray  # ()

    @staticmethod
    def build(latlong_rgb, corners, res: int = 128, strength: float = 1.0):
        """latlong_rgb: (h, w, 3) equirectangular environment radiance;
        corners: (4, 3) portal rectangle (CCW from the lit side)."""
        corners = np.asarray(corners, np.float64)
        x = corners[1] - corners[0]
        y = corners[3] - corners[0]
        xh = x / np.linalg.norm(x)
        z = np.cross(x, y)
        zh = z / np.linalg.norm(z)
        yh = np.cross(zh, xh)
        frame = np.stack([xh, yh, zh])  # world->portal rows

        # Resample the source into portal-direction space.
        u = (np.arange(res) + 0.5) / res
        uu, vv = np.meshgrid(u, u, indexing="xy")
        alpha = (uu - 0.5) * _PI
        beta = (vv - 0.5) * _PI
        wl = np.stack(
            [np.tan(alpha), np.tan(beta), np.ones_like(alpha)], axis=-1
        )
        wl /= np.linalg.norm(wl, axis=-1, keepdims=True)
        w_world = wl @ frame  # rows transpose: local -> world
        src = np.asarray(latlong_rgb, np.float32)
        sh, sw, _ = src.shape
        theta = np.arccos(np.clip(w_world[..., 2], -1, 1))
        phi = np.arctan2(w_world[..., 1], w_world[..., 0]) % (2 * np.pi)
        xi = np.clip((phi / (2 * np.pi) * sw).astype(int), 0, sw - 1)
        yi = np.clip((theta / np.pi * sh).astype(int), 0, sh - 1)
        img = src[yi, xi]  # (res, res, 3) portal-space radiance

        c, s = rgb2spec.fit_unbounded(jnp.asarray(img))
        lum = jnp.asarray(img.mean(-1))
        return PortalLight(
            corners=jnp.asarray(corners, jnp.float32),
            frame=jnp.asarray(frame, jnp.float32),
            coeffs=c,
            scale_tx=s,
            dist=WindowedPiecewiseConstant2D.build(lum),
            strength=jnp.asarray(strength, jnp.float32),
        )

    # -- direction <-> image mappings (lights.cpp ImageFromRender) ----------

    def dir_to_uv(self, w):
        wl = jnp.einsum("ij,...j->...i", self.frame, w, precision=jax.lax.Precision.HIGHEST)
        z = wl[..., 2]
        ok = z > 1e-6
        zs = jnp.where(ok, z, 1.0)
        alpha = jnp.arctan2(wl[..., 0], zs)
        beta = jnp.arctan2(wl[..., 1], zs)
        uv = jnp.stack(
            [alpha / _PI + 0.5, beta / _PI + 0.5], axis=-1
        )
        return uv, ok

    def uv_to_dir(self, uv):
        alpha = (uv[..., 0] - 0.5) * _PI
        beta = (uv[..., 1] - 0.5) * _PI
        wl = jnp.stack(
            [jnp.tan(alpha), jnp.tan(beta), jnp.ones_like(alpha)], axis=-1
        )
        wl = normalize(wl)
        return jnp.einsum(
            "ji,...j->...i", self.frame, wl, precision=jax.lax.Precision.HIGHEST
        )  # frame^T @ wl

    def _duv_dw(self, w):
        """Jacobian d(uv-area)/d(solid angle): pdf_dir = pdf_uv / this."""
        wl = jnp.einsum("ij,...j->...i", self.frame, w, precision=jax.lax.Precision.HIGHEST)
        x, y, z = wl[..., 0], wl[..., 1], jnp.maximum(wl[..., 2], 1e-6)
        return (_PI * _PI) * (z * z + x * x) * (z * z + y * y) / z

    def image_bounds(self, p):
        """Portal uv window seen from points p (lights.cpp ImageBounds)."""
        uv0, ok0 = self.dir_to_uv(normalize(self.corners[0][None] - p))
        uv2, ok2 = self.dir_to_uv(normalize(self.corners[2][None] - p))
        lo = jnp.minimum(uv0, uv2)
        hi = jnp.maximum(uv0, uv2)
        ok = ok0 & ok2
        b = jnp.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1)
        return jnp.where(ok[..., None], b, 0.0), ok

    def _texel(self, uv, lam):
        h, w = self.scale_tx.shape
        xi = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
        yi = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
        return (
            rgb2spec.eval_unbounded(
                self.coeffs[yi, xi], self.scale_tx[yi, xi], lam
            )
            * self.strength
        )

    # -- light interface ----------------------------------------------------

    def sample(self, u2, lam, p_ref):
        """NEE sample: (wi, L, pdf_solid_angle). Zero pdf when the point
        cannot see the portal (behind its plane)."""
        b, ok = self.image_bounds(p_ref)
        uv, pdf_uv = self.dist.sample(u2, b)
        wi = self.uv_to_dir(uv)
        pdf = jnp.where(
            ok & (pdf_uv > 0.0), pdf_uv / self._duv_dw(wi), 0.0
        )
        L = self._texel(uv, lam)
        return wi, jnp.where((pdf > 0.0)[..., None], L, 0.0), pdf

    def pdf_dir(self, d, p_ref):
        b, ok = self.image_bounds(p_ref)
        uv, okd = self.dir_to_uv(d)
        pdf_uv = self.dist.pdf(uv, b)
        return jnp.where(ok & okd, pdf_uv / self._duv_dw(d), 0.0)

    def radiance(self, d, lam, p_ref=None):
        """Escaped-ray radiance: the environment seen THROUGH the portal —
        zero for directions missing the origin's portal window."""
        uv, okd = self.dir_to_uv(d)
        if p_ref is not None:
            b, okp = self.image_bounds(p_ref)
            inside = (
                (uv[..., 0] >= b[..., 0]) & (uv[..., 0] <= b[..., 1])
                & (uv[..., 1] >= b[..., 2]) & (uv[..., 1] <= b[..., 3])
            )
            okd = okd & okp & inside
        return jnp.where(okd[..., None], self._texel(uv, lam), 0.0)

    @property
    def luminance(self):
        """Duck-type parity with EnvironmentMap (power heuristics)."""
        return self.dist.func

    @property
    def mean_power_proxy(self) -> float:
        return float(jnp.mean(self.dist.func))

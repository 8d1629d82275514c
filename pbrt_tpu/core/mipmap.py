"""MIP map: image pyramid with trilinear and EWA filtered lookups.

Reference analogue: MIPMap (/root/reference/src/pbrt/util/mipmap.h:34-87,
mipmap.cpp): a pyramid of progressively half-resolution levels, point /
bilinear / trilinear filters selected by a level-of-detail width, and EWA
(elliptically weighted average) anisotropic filtering driven by the two uv
screen-space differentials.

Layout: the pyramid is ONE flat (T, C) texel table plus static
per-level (offset, width, height) tuples, so a lookup with a *traced* level
is pure index arithmetic into a single array instead of a dynamic switch
over L differently-shaped buffers (XLA needs static shapes per operand; a
flat table keeps every lookup one fused gather). Downsampling uses a 2x2 box
filter (the reference resamples with a Lanczos-windowed sinc when sizes are
not powers of two; inputs here are padded up to powers of two first, where
the box filter is exact averaging).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .pytree import pytree, static_field


def _pow2_pad(img):
    """Pad (H, W, C) up to power-of-two dims by edge replication."""
    h, w = img.shape[:2]
    h2 = 1 << (h - 1).bit_length()
    w2 = 1 << (w - 1).bit_length()
    if (h2, w2) != (h, w):
        img = np.pad(img, ((0, h2 - h), (0, w2 - w), (0, 0)), mode="edge")
    return img


def build_pyramid(image) -> list:
    """Full chain of 2x box-filtered levels down to 1x1 (numpy, host-side)."""
    img = _pow2_pad(np.asarray(image, np.float32))
    levels = [img]
    while img.shape[0] > 1 or img.shape[1] > 1:
        if img.shape[0] > 1 and img.shape[1] > 1:
            nxt = 0.25 * (
                img[0::2, 0::2] + img[1::2, 0::2]
                + img[0::2, 1::2] + img[1::2, 1::2]
            )
        elif img.shape[0] > 1:
            nxt = 0.5 * (img[0::2] + img[1::2])
        else:
            nxt = 0.5 * (img[:, 0::2] + img[:, 1::2])
        levels.append(nxt.astype(np.float32))
        img = nxt
    return levels


@pytree
class MIPMap:
    """Flat-table mip pyramid for one image; see module docstring."""

    flat: jnp.ndarray  # (T, C) all levels concatenated row-major
    offsets: tuple = static_field()  # per-level texel offset
    widths: tuple = static_field()
    heights: tuple = static_field()
    wrap: str = static_field(default="repeat")  # repeat | clamp

    @staticmethod
    def build(image, wrap: str = "repeat") -> "MIPMap":
        levels = build_pyramid(image)
        offs, ws, hs = [], [], []
        o = 0
        for lv in levels:
            offs.append(o)
            hs.append(lv.shape[0])
            ws.append(lv.shape[1])
            o += lv.shape[0] * lv.shape[1]
        flat = np.concatenate([lv.reshape(-1, lv.shape[-1]) for lv in levels])
        return MIPMap(
            flat=jnp.asarray(flat),
            offsets=tuple(offs), widths=tuple(ws), heights=tuple(hs),
            wrap=wrap,
        )

    @property
    def n_levels(self) -> int:
        return len(self.offsets)

    def _wrap(self, i, n):
        if self.wrap == "repeat":
            return jnp.mod(i, n)
        return jnp.clip(i, 0, n - 1)

    def _texel(self, level_idx, x, y):
        """Fetch texels at a *traced* integer level via flat index math."""
        offs = jnp.asarray(self.offsets, jnp.int32)
        ws = jnp.asarray(self.widths, jnp.int32)
        hs = jnp.asarray(self.heights, jnp.int32)
        li = jnp.clip(level_idx, 0, self.n_levels - 1)
        off = jnp.take(offs, li)
        w = jnp.take(ws, li)
        h = jnp.take(hs, li)
        xx = self._wrap(x, w)
        yy = self._wrap(y, h)
        return jnp.take(self.flat, off + yy * w + xx, axis=0), w, h

    def _bilerp_level(self, level_idx, uv):
        """Bilinear lookup at a traced level (MIPMap::Bilerp)."""
        offs = jnp.asarray(self.offsets, jnp.int32)
        ws = jnp.asarray(self.widths, jnp.int32)
        hs = jnp.asarray(self.heights, jnp.int32)
        li = jnp.clip(level_idx, 0, self.n_levels - 1)
        off = jnp.take(offs, li)
        w = jnp.take(ws, li)
        h = jnp.take(hs, li)
        x = uv[..., 0] * w.astype(jnp.float32) - 0.5
        y = uv[..., 1] * h.astype(jnp.float32) - 0.5
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]

        def tx(xi, yi):
            return jnp.take(
                self.flat,
                off + self._wrap(yi, h) * w + self._wrap(xi, w),
                axis=0,
            )

        return (
            tx(x0, y0) * (1 - fx) * (1 - fy)
            + tx(x0 + 1, y0) * fx * (1 - fy)
            + tx(x0, y0 + 1) * (1 - fx) * fy
            + tx(x0 + 1, y0 + 1) * fx * fy
        )

    def lookup_trilinear(self, uv, width):
        """Isotropic filtered lookup (MIPMap::Filter, trilinear branch):
        width = max screen-space uv extent; blends the two pyramid levels
        whose texel spacing brackets it."""
        n = self.n_levels
        lod = n - 1 + jnp.log2(jnp.maximum(width, 1e-8))
        lod = jnp.clip(lod, 0.0, n - 1 - 1e-4)
        l0 = jnp.floor(lod).astype(jnp.int32)
        f = (lod - l0)[..., None]
        a = self._bilerp_level(l0, uv)
        b = self._bilerp_level(l0 + 1, uv)
        return a * (1 - f) + b * f

    def lookup_ewa(self, uv, duv0, duv1, max_aniso: float = 8.0,
                   window: int = 6):
        """EWA anisotropic lookup (MIPMap::EWA, mipmap.cpp): an elliptical
        Gaussian in uv whose axes are the two screen differentials. The
        level is chosen from the MINOR axis; the ellipse is scanned over a
        static (window x window) texel footprint at that level (the
        reference walks the exact ellipse bounding box; a fixed window keeps
        the kernel shape static — widths beyond it fall back to the
        clamped major axis, matching the reference's max-anisotropy clamp).
        """
        d0 = jnp.sqrt(jnp.sum(duv0 * duv0, axis=-1))
        d1 = jnp.sqrt(jnp.sum(duv1 * duv1, axis=-1))
        major = jnp.maximum(d0, d1)
        minor = jnp.minimum(d0, d1)
        swap = d1 > d0
        dmaj = jnp.where(swap[..., None], duv1, duv0)
        # Clamp eccentricity (mipmap.cpp: minor scaled up so
        # major/minor <= max_aniso).
        minor = jnp.maximum(minor, major / max_aniso)
        minor = jnp.maximum(minor, 1e-8)

        n = self.n_levels
        lod = jnp.clip(
            n - 1 + jnp.log2(minor), 0.0, n - 1 - 1e-4
        )
        li = jnp.floor(lod).astype(jnp.int32)
        ws = jnp.take(jnp.asarray(self.widths, jnp.int32), li)
        hs = jnp.take(jnp.asarray(self.heights, jnp.int32), li)
        wf = ws.astype(jnp.float32)
        hf = hs.astype(jnp.float32)

        # Ellipse coefficients in texel space of the chosen level
        # (mipmap.cpp EWA: A u^2 + B u v + C v^2 = F).
        d0t = duv0 * jnp.stack([wf, hf], -1)
        d1t = duv1 * jnp.stack([wf, hf], -1)
        A = d0t[..., 1] ** 2 + d1t[..., 1] ** 2 + 1.0
        B = -2.0 * (d0t[..., 0] * d0t[..., 1] + d1t[..., 0] * d1t[..., 1])
        C = d0t[..., 0] ** 2 + d1t[..., 0] ** 2 + 1.0
        invF = 1.0 / jnp.maximum(A * C - 0.25 * B * B, 1e-12)
        A, B, C = A * invF, B * invF, C * invF

        cx = uv[..., 0] * wf - 0.5
        cy = uv[..., 1] * hf - 0.5
        x0 = jnp.round(cx).astype(jnp.int32) - window // 2
        y0 = jnp.round(cy).astype(jnp.int32) - window // 2

        acc = jnp.zeros(uv.shape[:-1] + (self.flat.shape[-1],), jnp.float32)
        wsum = jnp.zeros(uv.shape[:-1], jnp.float32)
        for dy in range(window):
            for dx in range(window):
                xi = x0 + dx
                yi = y0 + dy
                du = xi.astype(jnp.float32) - cx
                dv = yi.astype(jnp.float32) - cy
                r2 = A * du * du + B * du * dv + C * dv * dv
                wgt = jnp.where(r2 < 1.0, jnp.exp(-2.0 * r2) - np.exp(-2.0), 0.0)
                tex, _, _ = self._texel(li, xi, yi)
                acc = acc + tex * wgt[..., None]
                wsum = wsum + wgt
        fallback = self._bilerp_level(li, uv)
        ok = wsum > 1e-8
        return jnp.where(
            ok[..., None], acc / jnp.maximum(wsum, 1e-8)[..., None], fallback
        )

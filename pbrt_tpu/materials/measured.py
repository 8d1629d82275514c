"""Measured (tabulated) isotropic BRDFs.

Reference analogue: MeasuredBxDF (/root/reference/src/pbrt/bxdfs.h:1155,
bxdfs.cpp) over the Dupuy-Jakob RGL data format. That format stores
NDF-warped spectra tables; this implementation keeps the *capability*
(render from measured reflectance data with no analytic model) with a
a batched representation: a dense isotropic half-angle table
f(theta_h, theta_d, phi_d) — the classic MERL parameterization the RGL
format itself is distilled from — holding per-cell RGB that is lifted to
spectra on evaluation via the renderer's sigmoid fits.

The half-angle grid uses the MERL convention of sqrt-warped theta_h (dense
near specular). Sampling uses the cosine hemisphere (the reference samples
a fitted proxy NDF; cosine keeps support full and the estimator unbiased —
documented variance-only divergence).

`bake_measured` converts ANY analytic BRDF into a table; the tests bake a
GGX conductor and gate the tabulated render against the analytic one, which
is the strongest data-free correctness check available in this sandbox (no
.bsdf assets ship with the reference checkout).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import rgb2spec
from ..core.pytree import pytree, static_field

N_TH = 32  # theta_h bins (sqrt warped)
N_TD = 32  # theta_d bins
N_PD = 16  # phi_d bins over [0, pi] (reciprocity folds the rest)


def _half_diff_angles(wo, wi):
    """(theta_h, theta_d, phi_d) of the half-angle parameterization."""
    h = wo + wi
    hn = h / jnp.maximum(
        jnp.sqrt(jnp.sum(h * h, axis=-1, keepdims=True)), 1e-9
    )
    th = jnp.arccos(jnp.clip(hn[..., 2], -1.0, 1.0))
    # Rotate wi into the frame where h is the pole to get the diff angles.
    cos_td = jnp.clip(jnp.sum(hn * wi, axis=-1), -1.0, 1.0)
    td = jnp.arccos(cos_td)
    # phi_d: azimuth of wi around h, measured from the plane containing z.
    z = jnp.asarray([0.0, 0.0, 1.0], wo.dtype)
    t = z - hn * hn[..., 2:3]
    t = t / jnp.maximum(
        jnp.sqrt(jnp.sum(t * t, axis=-1, keepdims=True)), 1e-9
    )
    b = jnp.cross(hn, t)
    wd = wi - hn * cos_td[..., None]
    pd = jnp.arctan2(
        jnp.sum(wd * b, axis=-1), jnp.sum(wd * t, axis=-1)
    )
    # Isotropic-material mirror symmetry: f(phi_d) = f(-phi_d), so fold
    # by |phi_d| (NOT a pi-shift, which lands mirrored pairs in unrelated
    # cells).
    pd = jnp.abs(pd)
    return th, td, jnp.minimum(pd, jnp.pi - 1e-6)


def _cell_coords(th, td, pd):
    """Continuous cell coordinates (cell centers at integer+0.5)."""
    x_h = jnp.sqrt(jnp.clip(th / (jnp.pi / 2), 0.0, 1.0 - 1e-6)) * N_TH
    x_d = jnp.clip(td / (jnp.pi / 2), 0.0, 1.0 - 1e-6) * N_TD
    x_p = jnp.clip(pd / jnp.pi, 0.0, 1.0 - 1e-6) * N_PD
    return x_h, x_d, x_p


def _cell_indices(th, td, pd):
    x_h, x_d, x_p = _cell_coords(th, td, pd)
    return (
        jnp.clip(x_h.astype(jnp.int32), 0, N_TH - 1),
        jnp.clip(x_d.astype(jnp.int32), 0, N_TD - 1),
        jnp.clip(x_p.astype(jnp.int32), 0, N_PD - 1),
    )


def trilinear_taps(th, td, pd):
    """8 (flat-cell-index, weight) taps for trilinear table filtering."""
    x_h, x_d, x_p = _cell_coords(th, td, pd)
    taps = []
    h0 = jnp.clip(jnp.floor(x_h - 0.5).astype(jnp.int32), 0, N_TH - 1)
    d0 = jnp.clip(jnp.floor(x_d - 0.5).astype(jnp.int32), 0, N_TD - 1)
    p0 = jnp.clip(jnp.floor(x_p - 0.5).astype(jnp.int32), 0, N_PD - 1)
    fh = jnp.clip(x_h - 0.5 - h0, 0.0, 1.0)
    fd = jnp.clip(x_d - 0.5 - d0, 0.0, 1.0)
    fp = jnp.clip(x_p - 0.5 - p0, 0.0, 1.0)
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                ih = jnp.minimum(h0 + a, N_TH - 1)
                idd = jnp.minimum(d0 + b, N_TD - 1)
                ip = jnp.minimum(p0 + c, N_PD - 1)
                w = (
                    (fh if a else 1.0 - fh)
                    * (fd if b else 1.0 - fd)
                    * (fp if c else 1.0 - fp)
                )
                taps.append(((ih * N_TD + idd) * N_PD + ip, w))
    return taps


@pytree
class MeasuredBRDF:
    coeffs: jnp.ndarray  # (N_TH, N_TD, N_PD, 3) sigmoid fits of f RGB
    scale: jnp.ndarray  # (N_TH, N_TD, N_PD) unbounded-spectrum scales

    @staticmethod
    def from_table(rgb_table) -> "MeasuredBRDF":
        """rgb_table: (N_TH, N_TD, N_PD, 3) BRDF values (1/sr units)."""
        t = jnp.asarray(rgb_table, jnp.float32)
        assert t.shape == (N_TH, N_TD, N_PD, 3), t.shape
        c, s = rgb2spec.fit_unbounded(t)
        return MeasuredBRDF(coeffs=c, scale=s)

    def f(self, wo, wi, lam):
        """Tabulated BRDF value at sampled wavelengths: (N, S)."""
        same = wo[..., 2] * wi[..., 2] > 0.0
        # Fold to the upper hemisphere (isotropic, reciprocal data).
        flip = wo[..., 2:3] < 0.0
        wo_u = jnp.where(flip, -wo, wo)
        wi_u = jnp.where(flip, -wi, wi)
        th, td, pd = _half_diff_angles(wo_u, wi_u)
        flat_c = self.coeffs.reshape(-1, 3)
        flat_s = self.scale.reshape(-1)
        val = 0.0
        for idx, w in trilinear_taps(th, td, pd):
            val = val + w[..., None] * rgb2spec.eval_unbounded(
                jnp.take(flat_c, idx, axis=0), jnp.take(flat_s, idx), lam
            )
        return jnp.where(same[..., None], val, 0.0)


def bake_measured(f_rgb_fn, n_quad: int = 64) -> np.ndarray:
    """Bake an analytic BRDF into the (N_TH, N_TD, N_PD, 3) table.

    f_rgb_fn(wo, wi) -> (..., 3) RGB BRDF values, local frame z-up. Each
    cell is evaluated at its center's reconstructed (wo, wi) pair."""
    # Cell centers of the sqrt-warped theta_h axis: lookup coordinate is
    # x = sqrt(th / (pi/2)) * N_TH, so center i sits at th = ((i+.5)/N)^2.
    th = (((np.arange(N_TH) + 0.5) / N_TH) ** 2) * (np.pi / 2)
    td = (np.arange(N_TD) + 0.5) / N_TD * (np.pi / 2)
    pd = (np.arange(N_PD) + 0.5) / N_PD * np.pi
    TH, TD, PD = np.meshgrid(th, td, pd, indexing="ij")
    # Reconstruct (wo, wi) from the half-diff angles: put h in the xz
    # plane; wi = rotate (sin td cos pd, sin td sin pd, cos td) from the
    # h-pole frame; wo mirrors wi about h.
    hvec = np.stack(
        [np.sin(TH), np.zeros_like(TH), np.cos(TH)], -1
    )
    t = np.stack([np.zeros_like(TH), np.zeros_like(TH), np.ones_like(TH)],
                 -1) - hvec * hvec[..., 2:3]
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-9)
    b = np.cross(hvec, t)
    wd = (
        np.sin(TD)[..., None]
        * (np.cos(PD)[..., None] * t + np.sin(PD)[..., None] * b)
    )
    wi = wd + np.cos(TD)[..., None] * hvec
    wo = 2.0 * np.sum(wi * hvec, -1, keepdims=True) * hvec - wi
    # Cells whose center reconstruction dips below the horizon still get
    # queried by valid grazing pairs (the MERL domain has invalid corners):
    # clamp to just-above-grazing rather than zeroing, so boundary lookups
    # see grazing data instead of black.
    for arr in (wi, wo):
        arr[..., 2] = np.maximum(arr[..., 2], 0.02)
        arr /= np.maximum(np.linalg.norm(arr, axis=-1, keepdims=True), 1e-9)
    wi_j = jnp.asarray(wi.reshape(-1, 3), jnp.float32)
    wo_j = jnp.asarray(wo.reshape(-1, 3), jnp.float32)
    vals = np.array(f_rgb_fn(wo_j, wi_j)).reshape(N_TH, N_TD, N_PD, 3)
    return np.clip(np.nan_to_num(vals), 0.0, None).astype(np.float32)

"""RGL (EPFL) measured-BRDF .bsdf loader.

Reference analogue: the tensor-file reader + MeasuredBxDFData::Create +
MeasuredBxDF::f (/root/reference/src/pbrt/bxdfs.cpp:740-1040). The format is
Dupuy & Jakob 2018 ("An Adaptive Parameterization for Efficient Material
Acquisition and Rendering"): a binary "tensor_file" container holding
theta_i/phi_i node arrays, ndf / sigma (projected area) grids, the vndf
marginal-conditional warp, and a 5D `spectra` tensor stored in the WARPED
unit square (so evaluation needs the inverse VNDF warp).

Design: the renderer's runtime measured-BRDF representation stays the
half-angle table of materials/measured.py (one trilinear-tap evaluation on
device). This module is host-side: it reads the tensor file, evaluates the
RGL parameterization exactly (numpy, including the piecewise-bilinear
marginal-conditional warp and its inverse), and bakes into that table via
bake_measured.
"""

from __future__ import annotations

import struct

import numpy as np

_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16, 5: np.uint32,
    6: np.int32, 7: np.uint64, 8: np.int64, 9: np.float16, 10: np.float32,
    11: np.float64,
}


def read_tensor_file(path: str) -> dict:
    """Parse a Dupuy-Jakob tensor container into {name: ndarray}."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:12] != b"tensor_file\x00":
        raise ValueError(f"not a tensor file: {path}")
    if raw[12] != 1 or raw[13] != 0:
        raise ValueError(f"unsupported tensor-file version in {path}")
    (n_fields,) = struct.unpack_from("<I", raw, 14)
    off = 18
    fields = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", raw, off)
        off += 2
        name = raw[off : off + name_len].decode()
        off += name_len
        ndim, dtype = struct.unpack_from("<HB", raw, off)
        off += 3
        (data_off,) = struct.unpack_from("<Q", raw, off)
        off += 8
        shape = struct.unpack_from(f"<{ndim}Q", raw, off)
        off += 8 * ndim
        if dtype not in _DTYPES:
            raise ValueError(f"{path}: field {name}: bad dtype {dtype}")
        dt = _DTYPES[dtype]
        count = int(np.prod(shape)) if ndim else 1
        arr = np.frombuffer(raw, dt, count, data_off).reshape(shape)
        fields[name] = arr
    return fields


_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def write_tensor_file(path: str, fields: dict) -> None:
    """Write {name: ndarray} as a Dupuy-Jakob tensor container (the inverse
    of read_tensor_file; useful for baking/synthesizing .bsdf assets)."""
    names = list(fields)
    header_size = 18
    for name in names:
        arr = np.asarray(fields[name])
        header_size += 2 + len(name.encode()) + 3 + 8 + 8 * arr.ndim
    out = [b"tensor_file\x00", bytes([1, 0]), struct.pack("<I", len(names))]
    data_off = header_size
    blobs = []
    for name in names:
        arr = np.ascontiguousarray(fields[name])
        code = _DTYPE_CODES[arr.dtype]
        nb = name.encode()
        out.append(struct.pack("<H", len(nb)))
        out.append(nb)
        out.append(struct.pack("<HBQ", arr.ndim, code, data_off))
        out.append(struct.pack(f"<{arr.ndim}Q", *arr.shape))
        blobs.append(arr.tobytes())
        data_off += arr.nbytes
    with open(path, "wb") as f:
        for b in out:
            f.write(b)
        for b in blobs:
            f.write(b)


class Marginal2D:
    """Piecewise-bilinear 2D distribution with up to 3 conditioning
    parameter axes (the PiecewiseLinear2D<N> of bxdfs.cpp / the powitacq
    Warp2D of Dupuy-Jakob 2018).

    values: (*param_sizes, ny, nx) node grid; the density between nodes is
    bilinear; x, y live in [0, 1] with nodes at i/(n-1). Parameter axes
    interpolate the grids multilinearly at the query's parameter values.
    """

    def __init__(self, values: np.ndarray, param_nodes=()):
        self.values = np.asarray(values, np.float64)
        self.param_nodes = [np.asarray(p, np.float64) for p in param_nodes]
        assert self.values.ndim == 2 + len(self.param_nodes)

    # -- parameter blending --------------------------------------------------

    def _blend(self, params):
        """Multilinear blend of grids at per-query parameter values.

        params: list of (N,) arrays. Returns (N, ny, nx)."""
        vals = self.values
        if not self.param_nodes:
            return vals[None]
        n = params[0].shape[0]
        out = None
        # Enumerate corner combinations of the param hypercube.
        idxw = []
        for nodes, p in zip(self.param_nodes, params):
            i = np.clip(np.searchsorted(nodes, p, "right") - 1, 0,
                        max(len(nodes) - 2, 0))
            if len(nodes) > 1:
                w = (p - nodes[i]) / (nodes[i + 1] - nodes[i])
                w = np.clip(w, 0.0, 1.0)
            else:
                w = np.zeros_like(p)
            idxw.append((i, w))
        k = len(idxw)
        for corner in range(1 << k):
            w_tot = np.ones(n)
            idx = []
            for d in range(k):
                i, w = idxw[d]
                hi = (corner >> d) & 1
                if len(self.param_nodes[d]) > 1:
                    idx.append(np.minimum(i + hi,
                                          len(self.param_nodes[d]) - 1))
                    w_tot = w_tot * (w if hi else 1.0 - w)
                else:
                    idx.append(i)
                    if hi:
                        w_tot = w_tot * 0.0
            g = vals[tuple(idx)]  # (N, ny, nx)
            out = g * w_tot[:, None, None] if out is None else (
                out + g * w_tot[:, None, None]
            )
        return out

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, x, y, params=()):
        """Raw bilinear interpolation of the node grid at (x, y) in [0,1]^2
        (normalize=false path of PiecewiseLinear2D::Evaluate)."""
        g = self._blend(list(params))  # (N, ny, nx)
        ny, nx = g.shape[-2:]
        fx = np.clip(np.asarray(x) * (nx - 1), 0, nx - 1 - 1e-9)
        fy = np.clip(np.asarray(y) * (ny - 1), 0, ny - 1 - 1e-9)
        ix = fx.astype(np.int64)
        iy = fy.astype(np.int64)
        tx = fx - ix
        ty = fy - iy
        r = np.arange(g.shape[0])
        v00 = g[r, iy, ix]
        v01 = g[r, iy, ix + 1]
        v10 = g[r, iy + 1, ix]
        v11 = g[r, iy + 1, ix + 1]
        return ((v00 * (1 - tx) + v01 * tx) * (1 - ty)
                + (v10 * (1 - tx) + v11 * tx) * ty)

    @staticmethod
    def _cdfs(g):
        """Per-query conditional/marginal cell-integral CDFs.

        g: (N, ny, nx) node values. cond[..., y, j] = integral of row y over
        x in [0, j/(nx-1)]; marg[..., i] = integral over y in [0, i/(ny-1)]
        of the row integrals."""
        cell = 0.5 * (g[..., :-1] + g[..., 1:])  # (N, ny, nx-1)
        cond = np.concatenate(
            [np.zeros(g.shape[:-1] + (1,)), np.cumsum(cell, -1)], -1
        )
        row_int = cond[..., -1]  # (N, ny)
        rcell = 0.5 * (row_int[..., :-1] + row_int[..., 1:])
        marg = np.concatenate(
            [np.zeros(row_int.shape[:-1] + (1,)), np.cumsum(rcell, -1)], -1
        )
        return cond, row_int, marg

    def invert(self, x, y, params=()):
        """Position (x, y) -> warp-input sample (u1, u2)
        (PiecewiseLinear2D::Invert). Linear-density CDF within each cell."""
        g = self._blend(list(params))
        ny, nx = g.shape[-2:]
        cond, row_int, marg = self._cdfs(g)
        total = np.maximum(marg[..., -1], 1e-12)
        fy = np.clip(np.asarray(y) * (ny - 1), 0, ny - 1 - 1e-9)
        iy = fy.astype(np.int64)
        ty = fy - iy
        r = np.arange(g.shape[0])
        r0 = row_int[r, iy]
        r1 = row_int[r, iy + 1]
        u2 = (marg[r, iy]
              + ty * r0 + 0.5 * ty * ty * (r1 - r0)) / total
        # Conditional row at this y (lerped between node rows). crow/grow
        # are PER-QUERY rows — index them with the query counter, not the
        # grid-batch counter r (length 1 when there are no param axes).
        crow = cond[r, iy] * (1 - ty)[:, None] + cond[r, iy + 1] * ty[:, None]
        grow = g[r, iy] * (1 - ty)[:, None] + g[r, iy + 1] * ty[:, None]
        rq = np.arange(crow.shape[0])
        rtot = np.maximum(crow[..., -1], 1e-12)
        fx = np.clip(np.asarray(x) * (nx - 1), 0, nx - 1 - 1e-9)
        ix = fx.astype(np.int64)
        tx = fx - ix
        c0 = grow[rq, ix]
        c1 = grow[rq, ix + 1]
        u1 = (crow[rq, ix] + tx * c0 + 0.5 * tx * tx * (c1 - c0)) / rtot
        return np.clip(u1, 0.0, 1.0), np.clip(u2, 0.0, 1.0)

    def sample(self, u1, u2, params=()):
        """Warp uniform (u1, u2) -> position (x, y); inverse of invert."""
        g = self._blend(list(params))
        ny, nx = g.shape[-2:]
        cond, row_int, marg = self._cdfs(g)
        total = np.maximum(marg[..., -1], 1e-12)
        r = np.arange(g.shape[0])
        # Invert the marginal CDF over y.
        target = np.asarray(u2) * total
        iy = np.clip(
            np.maximum(
                (marg <= target[:, None]).sum(-1) - 1, 0
            ), 0, ny - 2,
        )
        res = target - marg[r, iy]
        r0 = np.maximum(row_int[r, iy], 0.0)
        r1 = np.maximum(row_int[r, iy + 1], 0.0)
        ty = _solve_linear_cdf(res, r0, r1)
        y = (iy + ty) / (ny - 1)
        # Conditional over x at the sampled y (crow/grow are per-query).
        crow = cond[r, iy] * (1 - ty)[:, None] + cond[r, iy + 1] * ty[:, None]
        grow = g[r, iy] * (1 - ty)[:, None] + g[r, iy + 1] * ty[:, None]
        rq = np.arange(crow.shape[0])
        rtot = np.maximum(crow[..., -1], 1e-12)
        targx = np.asarray(u1) * rtot
        ix = np.clip(
            np.maximum((crow <= targx[:, None]).sum(-1) - 1, 0), 0, nx - 2
        )
        resx = targx - crow[rq, ix]
        c0 = np.maximum(grow[rq, ix], 0.0)
        c1 = np.maximum(grow[rq, ix + 1], 0.0)
        tx = _solve_linear_cdf(resx, c0, c1)
        x = (ix + tx) / (nx - 1)
        return x, y


def _solve_linear_cdf(res, v0, v1):
    """Solve res = v0 t + (v1 - v0) t^2 / 2 for t in [0, 1]."""
    d = v1 - v0
    stable = np.abs(d) > 1e-9 * np.maximum(v0, 1e-12)
    disc = np.maximum(v0 * v0 + 2.0 * d * res, 0.0)
    t_quad = (np.sqrt(disc) - v0) / np.where(stable, d, 1.0)
    t_lin = res / np.maximum(v0, 1e-12)
    return np.clip(np.where(stable, t_quad, t_lin), 0.0, 1.0)


# -- RGL BRDF evaluation ------------------------------------------------------


def _theta2u(theta):
    return np.sqrt(np.maximum(theta, 0.0) * (2.0 / np.pi))


def _phi2u(phi):
    return phi / (2.0 * np.pi) + 0.5


class RGLBrdf:
    """Loaded .bsdf data + exact evaluation (MeasuredBxDF::f)."""

    def __init__(self, fields: dict):
        self.theta_i = np.asarray(fields["theta_i"], np.float64)
        self.phi_i = np.asarray(fields["phi_i"], np.float64)
        self.wavelengths = np.asarray(fields["wavelengths"], np.float64)
        self.isotropic = self.phi_i.shape[0] <= 2
        pn = (self.phi_i, self.theta_i)
        self.ndf = Marginal2D(fields["ndf"])
        self.sigma = Marginal2D(fields["sigma"])
        self.vndf = Marginal2D(fields["vndf"], pn)
        self.spectra = Marginal2D(
            fields["spectra"], pn + (self.wavelengths,)
        )

    @staticmethod
    def load(path: str) -> "RGLBrdf":
        return RGLBrdf(read_tensor_file(path))

    def f(self, wo, wi, lam):
        """BRDF values: wo, wi (N, 3) z-up local; lam (L,) nm -> (N, L).

        MeasuredBxDF::f (bxdfs.cpp:1004-1039): invert the VNDF warp at the
        half vector, evaluate the warped spectra tensor, multiply
        ndf / (4 sigma(wo) cos_i).
        """
        wo = np.asarray(wo, np.float64)
        wi = np.asarray(wi, np.float64)
        wm = wo + wi
        wm /= np.maximum(np.linalg.norm(wm, axis=-1, keepdims=True), 1e-12)
        theta_o = np.arccos(np.clip(wo[..., 2], -1, 1))
        phi_o = np.arctan2(wo[..., 1], wo[..., 0])
        theta_m = np.arccos(np.clip(wm[..., 2], -1, 1))
        phi_m = np.arctan2(wm[..., 1], wm[..., 0])
        u_wm_x = _theta2u(theta_m)
        u_wm_y = _phi2u(phi_m - phi_o if self.isotropic else phi_m)
        u_wm_y = u_wm_y - np.floor(u_wm_y)
        ui_x, ui_y = self.vndf.invert(u_wm_x, u_wm_y, (phi_o, theta_o))
        n = wo.shape[0]
        out = np.zeros((n, len(lam)))
        for j, lm in enumerate(np.asarray(lam, np.float64)):
            out[:, j] = self.spectra.evaluate(
                ui_x, ui_y, (phi_o, theta_o, np.full(n, lm))
            )
        ndf_v = self.ndf.evaluate(u_wm_x, u_wm_y)
        sig_v = self.sigma.evaluate(_theta2u(theta_o), _phi2u(phi_o))
        denom = 4.0 * np.maximum(sig_v, 1e-12) * np.maximum(wi[..., 2], 1e-4)
        return np.maximum(out * (ndf_v / denom)[:, None], 0.0)

    def f_rgb(self, wo, wi):
        """CIE-integrated RGB reflectance (for bake_measured)."""
        from ..core import cie
        from ..core.colorspace import SRGB

        lam = np.linspace(
            max(400.0, float(self.wavelengths.min())),
            min(700.0, float(self.wavelengths.max())),
            16,
        )
        spec = self.f(np.asarray(wo), np.asarray(wi), lam)  # (N, L)
        xyz = cie.cie_xyz_np(lam)  # (L, 3)
        y_int = np.maximum(np.trapezoid(xyz[:, 1], lam), 1e-9)
        out_xyz = np.stack(
            [np.trapezoid(spec * xyz[None, :, k], lam, axis=1) / y_int
             for k in range(3)], -1,
        )
        return np.clip(out_xyz @ SRGB.rgb_from_xyz.T, 0.0, None)


def bake_rgl(path: str) -> np.ndarray:
    """Load a .bsdf file and bake it into the renderer's half-angle
    measured table (materials/measured.py bake_measured)."""
    from .measured import bake_measured

    brdf = RGLBrdf.load(path)
    return bake_measured(lambda wo, wi: brdf.f_rgb(wo, wi))

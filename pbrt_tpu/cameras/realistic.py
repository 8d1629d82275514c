"""Realistic (lens-stack) and Omni cameras.

Reference analogue: RealisticCamera (/root/reference/src/pbrt/cameras.h:485,
full element-by-element lens tracing with exit-pupil precomputation) and the
ISET OmniCamera (:853-1086): conic/aspheric surfaces, microlens arrays
(cameras.cpp:3153-3330 MicrolensIndex/SampleMicrolensPupil/
TraceFullLensSystemFromFilm), and HURB diffraction at the stop
(cameras.cpp:2742 diffractHURB; enabled by `diffraction`).

Design: GenerateRay = sample a point on the rear element disk (or the
film point's microlens window), build the film->rear ray, then trace the
whole batch through the stack(s) with scans. Rays clipped by apertures
return weight 0 (vignetting) instead of resampling — the film accumulates
weighted samples, so the estimator matches pbrt's exit-pupil-area weighting
up to normalization. HURB noise is derived statelessly from the film/pupil
sample bits, keeping renders replayable.
"""

from __future__ import annotations

import json

import numpy as np
import jax.numpy as jnp

from ..core.pytree import pytree, static_field
from ..core.rng import pcg4d
from ..core.sampling import sample_uniform_disk_concentric
from ..core.transform import Transform
from ..core.vecmath import normalize
from .lens import LensStack, trace_through_stack


@pytree
class MicrolensArray:
    """A dims[0] x dims[1] grid of identical small lens stacks covering the
    film's physical extent at `offset_from_sensor` mm in front of it
    (OmniCamera::MicrolensData, cameras.h:880). `stack` holds one microlens
    with vertex z measured from the sensor plane (offset already applied);
    `offsets` optionally decenters each lens (mm in film space)."""

    stack: LensStack
    dims: tuple = static_field()  # (mx, my)
    offset_from_sensor: float = static_field(default=0.001)
    offsets: object = None  # (mx*my, 2) or None
    sim_radius: int = static_field(default=0)


@pytree
class RealisticCamera:
    camera_to_world: Transform
    lens: LensStack
    resolution: tuple = static_field()
    film_diag_mm: float = static_field(default=35.0)
    # Distance film -> rear element vertex is lens.vertex_z[0]; the rear
    # aperture radius bounds the sampled pupil disk.
    rear_radius_scale: float = static_field(default=1.0)
    shutter_open: float = static_field(default=0.0)
    shutter_close: float = static_field(default=1.0)
    # Exit-pupil bounds per film-radius segment: (S, 4) [x0, x1, y0, y1]
    # rear-element-plane rectangles (RealisticCamera::ComputeExitPupilBounds,
    # cameras.h:544). None -> sample the full rear disk.
    pupil_bounds: object = None
    # Optional MicrolensArray between sensor and main stack (OmniCamera).
    microlens: object = None
    # HURB diffraction at the aperture stop (OmniCamera diffractionEnabled).
    diffraction: bool = static_field(default=False)

    @staticmethod
    def create(camera_to_world, lens, resolution, film_diag_mm=35.0,
               exit_pupil=True, n_pupil_segments=32):
        cam = RealisticCamera(
            camera_to_world=camera_to_world, lens=lens,
            resolution=resolution, film_diag_mm=film_diag_mm,
        )
        if exit_pupil:
            cam = cam.replace(pupil_bounds=compute_exit_pupil_bounds(
                lens, film_diag_mm, n_segments=n_pupil_segments,
            ))
        return cam

    def _film_extent(self):
        nx, ny = self.resolution
        aspect = nx / ny
        diag = self.film_diag_mm
        h = diag / np.sqrt(1.0 + aspect * aspect)
        w = aspect * h
        return w, h

    def _hurb_noise(self, p_film, u_lens):
        """Stateless (N, 2) standard normals for HURB, hashed from the
        film/pupil sample bits (replayable, no RNG state threading)."""
        import jax

        bits = lambda x: jax.lax.bitcast_convert_type(
            x.astype(jnp.float32), jnp.uint32
        )
        h0, h1, _, _ = pcg4d(bits(p_film[..., 0]), bits(p_film[..., 1]),
                             bits(u_lens[..., 0]), bits(u_lens[..., 1]))
        u0 = (h0 >> 8).astype(jnp.float32) * (1.0 / (1 << 24))
        u1 = (h1 >> 8).astype(jnp.float32) * (1.0 / (1 << 24))
        r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u0, 1e-12)))
        ang = 2.0 * jnp.pi * u1
        return jnp.stack([r * jnp.cos(ang), r * jnp.sin(ang)], axis=-1)

    def generate_rays(self, p_film, u_lens, wavelength_nm=None):
        """p_film: (N, 2) raster coords; u_lens: (N, 2) pupil samples.

        Returns (o_world, d_world, weight) — weight 0 marks vignetted rays.
        All lens math is in millimetres in the camera frame (film at z=0,
        scene toward +z); output is in world units (the camera_to_world
        transform carries the mm -> scene-unit scale). wavelength_nm (scalar
        or per-ray) feeds HURB diffraction when `diffraction` is set.
        """
        nx, ny = self.resolution
        w, h = self._film_extent()
        # Film point (note image is inverted through the lens; flip to keep
        # the final image upright, as pbrt does).
        fx = (0.5 - p_film[..., 0] / nx) * w
        fy = (p_film[..., 1] / ny - 0.5) * h
        o = jnp.stack([fx, fy, jnp.zeros_like(fx)], axis=-1)
        rear_z = self.lens.vertex_z[0]
        rear_r = (
            jnp.sqrt(self.lens.aperture2[0]) * self.rear_radius_scale
        )
        hurb = (self._hurb_noise(p_film, u_lens)
                if self.diffraction else None)
        wl = 550.0 if wavelength_nm is None else wavelength_nm
        if self.microlens is not None:
            return self._generate_rays_microlens(
                o, fx, fy, u_lens, w, h, rear_r, hurb, wl
            )
        if self.pupil_bounds is None:
            # Full rear-disk sampling (most samples vignette through
            # multi-element stops; kept as the fallback path).
            p_disk = sample_uniform_disk_concentric(u_lens) * rear_r
            px, py = p_disk[..., 0], p_disk[..., 1]
            w_pupil = jnp.ones_like(fx)
        else:
            # SampleExitPupil (cameras.h:551): pick the precomputed pupil
            # rectangle for this film radius, sample uniformly inside it,
            # and rotate into the film point's azimuthal frame. The weight
            # ratio area_bounds/area_disk keeps the estimator's expectation
            # identical to full-disk sampling while concentrating samples
            # on the non-vignetted window.
            from ..core.gather import gather_rows

            nseg = self.pupil_bounds.shape[0]
            r_film = jnp.sqrt(fx * fx + fy * fy)
            r_max = 0.5 * self.film_diag_mm
            seg = jnp.clip(
                (r_film / r_max * nseg).astype(jnp.int32), 0, nseg - 1
            )
            b = gather_rows(self.pupil_bounds, seg)  # (N, 4)
            bx = b[..., 0] + u_lens[..., 0] * (b[..., 1] - b[..., 0])
            by = b[..., 2] + u_lens[..., 1] * (b[..., 3] - b[..., 2])
            area = jnp.maximum(
                (b[..., 1] - b[..., 0]) * (b[..., 3] - b[..., 2]), 0.0
            )
            safe_r = jnp.maximum(r_film, 1e-8)
            cos_p = jnp.where(r_film > 1e-8, fx / safe_r, 1.0)
            sin_p = jnp.where(r_film > 1e-8, fy / safe_r, 0.0)
            px = cos_p * bx - sin_p * by
            py = sin_p * bx + cos_p * by
            w_pupil = area / jnp.maximum(np.pi * rear_r * rear_r, 1e-12)
        target = jnp.stack(
            [px, py, jnp.broadcast_to(rear_z, fx.shape)], axis=-1
        )
        d = normalize(target - o)
        o_out, d_out, valid = trace_through_stack(
            self.lens, o, d, hurb_noise=hurb, wavelength_nm=wl
        )
        o_w = self.camera_to_world.apply_point(o_out)
        d_w = normalize(self.camera_to_world.apply_vector(d_out))
        return o_w, d_w, valid.astype(jnp.float32) * w_pupil

    def _generate_rays_microlens(self, o, fx, fy, u_lens, w, h, rear_r,
                                 hurb, wl):
        """Two-stage trace through the microlens array then the main stack
        (OmniCamera::SampleMicrolensPupil + TraceFullLensSystemFromFilm,
        cameras.cpp:3167/3296): sample a target uniformly over the film
        point's (2R+1)-cell microlens window, identify the hit lens from the
        sampled point, and trace film -> that (decentered) microlens ->
        main lens."""
        ml = self.microlens
        mx, my = ml.dims
        # Film point's cell in lens-grid space (MicrolensIndex).
        gx = (fx + 0.5 * w) / w * mx
        gy = (fy + 0.5 * h) / h * my
        r_sim = float(ml.sim_radius)
        diam = 2.0 * r_sim + 1.0
        sx_cell = jnp.floor(gx) - r_sim + u_lens[..., 0] * diam
        sy_cell = jnp.floor(gy) - r_sim + u_lens[..., 1] * diam
        # Physical sample point on the microlens plane.
        sx = sx_cell / mx * w - 0.5 * w
        sy = sy_cell / my * h - 0.5 * h
        # The lens actually covering the sampled point.
        cx_i = jnp.clip(jnp.floor(sx_cell).astype(jnp.int32), 0, mx - 1)
        cy_i = jnp.clip(jnp.floor(sy_cell).astype(jnp.int32), 0, my - 1)
        cx = (cx_i.astype(jnp.float32) + 0.5) / mx * w - 0.5 * w
        cy = (cy_i.astype(jnp.float32) + 0.5) / my * h - 0.5 * h
        if ml.offsets is not None:
            from ..core.gather import gather_rows

            off = gather_rows(ml.offsets, cy_i * mx + cx_i)
            cx = cx + off[..., 0]
            cy = cy + off[..., 1]
        target = jnp.stack(
            [sx, sy, jnp.full_like(sx, ml.offset_from_sensor)], axis=-1
        )
        d = normalize(target - o)
        # Stage 1: through this ray's microlens, traced in the lens' local
        # (decentered) frame.
        center = jnp.stack([cx, cy, jnp.zeros_like(cx)], axis=-1)
        o1, d1, v1 = trace_through_stack(ml.stack, o - center, d)
        # Stage 2: through the main stack.
        o2, d2, v2 = trace_through_stack(
            self.lens, o1 + center, d1, hurb_noise=hurb, wavelength_nm=wl
        )
        window_area = (diam / mx * w) * (diam / my * h)
        w_pupil = window_area / jnp.maximum(np.pi * rear_r * rear_r, 1e-12)
        o_w = self.camera_to_world.apply_point(o2)
        d_w = normalize(self.camera_to_world.apply_vector(d2))
        return o_w, d_w, (v1 & v2).astype(jnp.float32) * w_pupil


def compute_exit_pupil_bounds(lens: LensStack, film_diag_mm: float,
                              n_segments: int = 32, n_grid: int = 48):
    """Per-film-radius-segment bounding rectangles of the non-vignetted
    rear-element window (RealisticCamera::ComputeExitPupilBounds,
    cameras.h:544): trace a grid of candidate pupil points from the outer
    radius of each segment, keep the bbox of survivors, padded by one grid
    cell. Host-side, one vectorized trace for all segments."""
    rear_z = float(lens.vertex_z[0])
    rear_r = float(np.sqrt(lens.aperture2[0]))
    r_max = 0.5 * film_diag_mm
    s = np.arange(n_segments)
    # Sample the segment's outer edge (conservative for the whole segment).
    film_x = (s + 1.0) / n_segments * r_max
    g = (np.arange(n_grid) + 0.5) / n_grid * 2.0 - 1.0
    px, py = np.meshgrid(g * rear_r, g * rear_r, indexing="ij")
    o = np.zeros((n_segments, n_grid, n_grid, 3), np.float32)
    o[..., 0] = film_x[:, None, None]
    tgt = np.zeros_like(o)
    tgt[..., 0] = px[None]
    tgt[..., 1] = py[None]
    tgt[..., 2] = rear_z
    o_j = jnp.asarray(o.reshape(-1, 3))
    d_j = normalize(jnp.asarray(tgt.reshape(-1, 3)) - o_j)
    _, _, valid = trace_through_stack(lens, o_j, d_j)
    valid = np.asarray(valid).reshape(n_segments, n_grid, n_grid)
    pad = 2.0 * rear_r / n_grid
    bounds = np.zeros((n_segments, 4), np.float32)
    for i in range(n_segments):
        m = valid[i]
        if not m.any():
            # Nothing survives (fully vignetted segment): degenerate box.
            bounds[i] = (0.0, 0.0, 0.0, 0.0)
            continue
        xs = px[m]
        ys = py[m]
        bounds[i] = (
            xs.min() - pad, xs.max() + pad, ys.min() - pad, ys.max() + pad
        )
    return jnp.asarray(bounds)


def _scalar(v, default=0.0):
    """JSON scalar-or-[x,y] field -> float (x component, as OmniCamera's
    toVec2 path does for the isotropic case)."""
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return float(v[0]) if v else default
    return float(v)


def _ior_at(v, wavelength_nm=550.0):
    """JSON ior field: number, or spectral table [[wavelengths],[values]]
    (OmniCamera's toIORSpectrum) -> IOR at wavelength_nm."""
    if v is None:
        return 1.0
    if isinstance(v, (int, float)):
        return float(v) if v != 0 else 1.0
    wl = np.asarray(v[0], np.float64)
    n = np.asarray(v[1], np.float64)
    out = float(np.interp(wavelength_nm, wl, n))
    return out if out != 0 else 1.0


def _rows_from_json_surfaces(surfaces, wavelength_nm=550.0):
    rows, conics, asps = [], [], []
    max_k = 1
    for s in surfaces:
        rows.append([
            _scalar(s.get("radius")),
            _scalar(s.get("thickness")),
            _ior_at(s.get("ior"), wavelength_nm),
            2.0 * _scalar(s.get("semi_aperture")),
        ])
        conics.append(_scalar(s.get("conic_constant")))
        a = s.get("aspheric_coefficients") or []
        asps.append([float(x) for x in a])
        max_k = max(max_k, len(a))
    asp_arr = np.zeros((len(asps), max_k))
    for i, a in enumerate(asps):
        asp_arr[i, : len(a)] = a
    return (np.asarray(rows, np.float64), np.asarray(conics, np.float64),
            asp_arr)


def load_lens_json(path: str, wavelength_nm: float = 550.0,
                   microlens_sensor_offset_mm: float = 1.0,
                   sim_radius: int = 0):
    """Parse an omni-style .json lens description (OmniCamera::Create,
    cameras.cpp: surfaces with radius/thickness/ior/semi_aperture/
    conic_constant/aspheric_coefficients + optional microlens block).

    Units stay in mm (the reference converts to meters; our lens space is
    mm). Spectral IOR tables are evaluated at wavelength_nm. Returns
    (LensStack, MicrolensArray | None); microlens local stacks put their
    rear vertex at the sensor-offset plane.
    """
    with open(path) as f:
        j = json.load(f)
    surfaces = j.get("surfaces")
    if not surfaces:
        raise ValueError(f"no surfaces in lens json: {path}")
    rows, conics, asp = _rows_from_json_surfaces(surfaces, wavelength_nm)
    stack = LensStack.from_pbrt_elements(rows, conic=conics, aspheric=asp)
    micro = None
    mj = j.get("microlens")
    if mj:
        mdims = mj.get("dimensions")
        mrows, mconics, masp = _rows_from_json_surfaces(
            mj["surfaces"], wavelength_nm
        )
        mstack = LensStack.from_pbrt_elements(
            mrows, conic=mconics, aspheric=masp
        )
        # Rebase: rear microlens vertex sits at the sensor-offset plane.
        vz = mstack.vertex_z
        mstack = mstack.replace(
            vertex_z=vz - vz.min() + microlens_sensor_offset_mm
        )
        offsets = mj.get("offsets") or None
        if offsets:
            offsets = jnp.asarray(np.asarray(offsets, np.float32))
        micro = MicrolensArray(
            stack=mstack,
            dims=(int(mdims[0]), int(mdims[1])),
            offset_from_sensor=float(microlens_sensor_offset_mm),
            offsets=offsets,
            sim_radius=int(sim_radius),
        )
    return stack, micro


def biconvex_singlet(
    focal_mm: float = 50.0, aperture_mm: float = 12.5, eta: float = 1.5,
    film_distance_mm: float | None = None,
) -> LensStack:
    """A symmetric thin biconvex lens with the requested focal length
    (lensmaker's equation), for tests and as a default lens."""
    # 1/f = (n-1) (1/R1 - 1/R2) with R2 = -R1 -> R = 2 (n-1) f.
    r = 2.0 * (eta - 1.0) * focal_mm
    fd = film_distance_mm if film_distance_mm is not None else focal_mm
    thick = 2.0
    # Conicoid sign convention (lens.py): local z = rho^2/(2R), so R > 0
    # recedes toward the scene (convex toward the film) and R < 0 is convex
    # toward the scene. Biconvex = (+R film side, -R scene side).
    return LensStack.build(
        [
            # film -> scene ordering; rear surface first.
            {"z": fd, "radius": r, "conic": 0.0, "aperture": aperture_mm,
             "eta_before": 1.0, "eta_after": eta},
            {"z": fd + thick, "radius": -r, "conic": 0.0,
             "aperture": aperture_mm, "eta_before": eta, "eta_after": 1.0},
        ]
    )


def omni_camera(
    camera_to_world, resolution, lens: LensStack, film_diag_mm: float = 35.0,
    microlens: MicrolensArray | None = None, diffraction: bool = False,
) -> RealisticCamera:
    """OmniCamera = RealisticCamera over a conic/aspheric lens stack, plus
    the ISET extensions: microlens arrays and HURB diffraction."""
    return RealisticCamera(
        camera_to_world=camera_to_world,
        lens=lens,
        resolution=resolution,
        film_diag_mm=film_diag_mm,
        microlens=microlens,
        diffraction=diffraction,
    )

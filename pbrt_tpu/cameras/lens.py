"""Lens-stack ray tracing: conic interfaces traced with a lax.scan.

Reference analogue: RealisticCamera's element-by-element lens tracing
(/root/reference/src/pbrt/cameras.h:485-604, TraceLensesFromFilm) and the
conic/aspheric surfaces of OmniCamera/HumanEyeCamera (:607-1086).
Design: the element list is a small SOA of per-surface parameters; a batched
scan advances ALL rays through one surface at a time (closed-form conicoid
intersection + Snell refraction), with a validity mask instead of early
returns.

Conventions (pbrt lens files): the stack is listed front-to-back; tracing
from the film moves toward the front. We store surfaces back-to-front with
z positions precomputed; rays start at the film plane z = 0 pointing -z
... here +z toward the scene with surfaces at increasing z.

Surface model: conicoid with curvature radius R and conic constant Q:
    r^2 - 2 R z + (1 + Q) z^2 = 0    (z measured from the surface vertex)
R == 0 denotes a planar surface (aperture stop). Optional even-asphere
polynomial terms (sum_i a_i r^(4+2i), the OmniCamera aspheric_coefficients)
are handled by Newton-refining the conic hit against the sag function.

HURB diffraction (Freniere et al. 1999; OmniCamera/HumanEyeCamera
diffractHURB, cameras.cpp:2092/2742): at the aperture stop, rays are
deflected by zero-mean Gaussian angles whose sigmas grow as the ray passes
closer to the stop edge — sigma = atan(lambda / (1.41 * d_edge * 2 pi)) per
axis, evaluated in the radial (S) and tangential (L) edge-distance frame.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.pytree import pytree, static_field
from ..core.vecmath import normalize, refract

_EPS = 1e-9


@pytree
class LensStack:
    """Per-surface arrays, ordered along +z (film at z=0, scene beyond)."""

    vertex_z: jnp.ndarray  # (E,) z of each surface vertex
    radius: jnp.ndarray  # (E,) curvature radius (0 = planar)
    conic: jnp.ndarray  # (E,) conic constant Q
    aperture2: jnp.ndarray  # (E,) squared aperture radius
    eta_after: jnp.ndarray  # (E,) IOR of the medium after (z >) the surface
    eta_before: jnp.ndarray  # (E,) IOR before the surface
    # Even-asphere coefficients a_i (E, K): extra sag sum_i a_i r^(4+2i)
    # on top of the conicoid (OmniCamera aspheric_coefficients).
    aspheric: object = None
    has_aspheric: bool = static_field(default=False)

    @staticmethod
    def from_pbrt_elements(rows, eta_scene: float = 1.0,
                           conic=None, aspheric=None) -> "LensStack":
        """rows: pbrt lens-file rows [curvature_radius, thickness, eta,
        aperture_diameter], listed FRONT (scene side) to BACK (film side),
        thickness = distance to the next surface toward the film
        (pbrt .dat convention, cameras.h RealisticCamera::Create).

        Returns a stack ordered film -> scene with z positions accumulated.
        """
        rows = np.asarray(rows, np.float64)
        n = rows.shape[0]
        # Walk front->back accumulating z, then flip so film is at z=0.
        z = 0.0
        zs = []
        for i in range(n):
            zs.append(z)
            z += rows[i, 1]
        total = z
        vertex_z = total - np.asarray(zs)  # distance from film plane
        # eta listed per row = IOR of the medium BEHIND the surface (toward
        # film). After flipping to film->scene order:
        order = np.argsort(vertex_z)
        vz = vertex_z[order]
        radius = rows[order, 0]
        # Build per-surface before/after IORs walking film->scene.
        eta_rows = rows[:, 2].copy()
        eta_rows[eta_rows == 0] = 1.0
        eta_behind = eta_rows[order]  # medium between this surface and next
        eta_before = eta_behind  # medium on the film side of the surface
        eta_after = np.append(eta_behind[1:], eta_scene)
        ap = rows[order, 3] / 2.0
        conic_arr = (np.zeros((n,)) if conic is None
                     else np.asarray(conic, np.float64)[order])
        asp = None
        has_asp = False
        if aspheric is not None:
            asp_np = np.asarray(aspheric, np.float64)[order]
            has_asp = bool(np.any(asp_np != 0.0))
            asp = jnp.asarray(asp_np, jnp.float32) if has_asp else None
        return LensStack(
            vertex_z=jnp.asarray(vz, jnp.float32),
            radius=jnp.asarray(radius, jnp.float32),
            conic=jnp.asarray(conic_arr, jnp.float32),
            aperture2=jnp.asarray(ap * ap, jnp.float32),
            eta_after=jnp.asarray(eta_after, jnp.float32),
            eta_before=jnp.asarray(eta_before, jnp.float32),
            aspheric=asp,
            has_aspheric=has_asp,
        )

    @staticmethod
    def build(surfaces) -> "LensStack":
        """surfaces: list of dicts (ordered film -> scene) with keys
        z, radius, conic, aperture, eta_before, eta_after."""
        g = lambda k, d=0.0: jnp.asarray(
            [s.get(k, d) for s in surfaces], jnp.float32
        )
        ap = g("aperture", 1e3)
        return LensStack(
            vertex_z=g("z"),
            radius=g("radius"),
            conic=g("conic"),
            aperture2=ap * ap,
            eta_after=g("eta_after", 1.0),
            eta_before=g("eta_before", 1.0),
        )

    @property
    def n_surfaces(self) -> int:
        return self.vertex_z.shape[0]


def _intersect_conicoid(o, d, vz, radius, conic):
    """Ray vs conicoid surface with vertex at z = vz on the z axis.

    Returns (t, valid). Handles planar (radius == 0) surfaces.
    """
    oz = o[..., 2] - vz
    # Planar case.
    t_plane = jnp.where(jnp.abs(d[..., 2]) > _EPS, -oz / d[..., 2], -1.0)
    planar = radius == 0.0
    # Conicoid: r^2 - 2 R z + (1+Q) z^2 = 0 with r^2 = x^2 + y^2.
    k = 1.0 + conic
    ox, oy = o[..., 0], o[..., 1]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = dx * dx + dy * dy + k * dz * dz
    b = 2.0 * (ox * dx + oy * dy + k * oz * dz - radius * dz)
    c = ox * ox + oy * oy + k * oz * oz - 2.0 * radius * oz
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
    t0 = jnp.where(jnp.abs(a) > _EPS, q / jnp.where(jnp.abs(a) > _EPS, a, 1.0), -1.0)
    t1 = jnp.where(jnp.abs(q) > _EPS, c / jnp.where(jnp.abs(q) > _EPS, q, 1.0), -1.0)
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)

    # Accept the nearest forward root that lies on the vertex-side cap
    # (|z_local| <= |R|); the far branch of the conicoid is not lens glass.
    def root_ok(t):
        zl = oz + t * dz
        return (t > 1e-5) & (jnp.abs(zl) <= jnp.abs(radius) * 1.0001)

    ok_lo = root_ok(tlo)
    ok_hi = root_ok(thi)
    t_conic = jnp.where(ok_lo, tlo, jnp.where(ok_hi, thi, -1.0))
    t = jnp.where(planar, t_plane, t_conic)
    valid = (t > _EPS) & jnp.where(planar, True, disc >= 0.0)
    return t, valid


def _sag(r2, radius, conic, asp):
    """Surface sag z(r^2): conicoid + even-asphere polynomial terms.

    Conicoid solved for z: z = r^2 / (R + sqrt(R^2 - (1+Q) r^2)) — the
    standard optical sag form, identical to the implicit conicoid used by
    _intersect_conicoid on the vertex-side branch.
    """
    k = 1.0 + conic
    s = jnp.sqrt(jnp.maximum(radius * radius - k * r2, 1e-12))
    denom = radius + jnp.sign(radius) * s
    z = r2 / jnp.where(jnp.abs(denom) > _EPS, denom, 1.0)
    if asp is not None:
        # sum_i a_i r^(4 + 2i) = sum_i a_i (r^2)^(2+i)
        pw = r2 * r2
        for i in range(asp.shape[0]):
            z = z + asp[i] * pw
            pw = pw * r2
    return z


def _sag_prime(r2, radius, conic, asp):
    """d sag / d(r^2)."""
    k = 1.0 + conic
    s = jnp.sqrt(jnp.maximum(radius * radius - k * r2, 1e-12))
    denom = radius + jnp.sign(radius) * s
    denom = jnp.where(jnp.abs(denom) > _EPS, denom, 1.0)
    dz = (denom + r2 * jnp.sign(radius) * k / (2.0 * s)) / (denom * denom)
    if asp is not None:
        pw = r2
        for i in range(asp.shape[0]):
            dz = dz + asp[i] * (2.0 + i) * pw
            pw = pw * r2
    return dz


def _refine_aspheric(o, d, t, vz, radius, conic, asp, iters: int = 5):
    """Newton-refine the conic hit against the full (conic + polynomial)
    sag: solve z_ray(t) = sag(r^2(t)) (the role of the reference's iterative
    aspheric intersection in OmniCamera::TraceLensesFromFilm)."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2] - vz
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    for _ in range(iters):
        x = ox + t * dx
        y = oy + t * dy
        r2 = x * x + y * y
        f = oz + t * dz - _sag(r2, radius, conic, asp)
        fp = dz - _sag_prime(r2, radius, conic, asp) * 2.0 * (x * dx + y * dy)
        t = t - f / jnp.where(jnp.abs(fp) > _EPS, fp, 1.0)
    return t


def _aspheric_normal(p, vz, radius, conic, asp):
    """Gradient of z - sag(r^2): (-sag' 2x, -sag' 2y, 1), oriented -z."""
    r2 = p[..., 0] ** 2 + p[..., 1] ** 2
    sp = _sag_prime(r2, radius, conic, asp)
    n = jnp.stack(
        [-2.0 * sp * p[..., 0], -2.0 * sp * p[..., 1], jnp.ones_like(r2)],
        axis=-1,
    )
    n = normalize(n)
    return jnp.where((n[..., 2] > 0.0)[..., None], -n, n)


def _hurb_deflect(p, d, aperture_r, wavelength_mm, noise):
    """Heisenberg-uncertainty ray bending at an aperture stop.

    Behavioral analogue of diffractHURB (cameras.cpp:2092-2167 HumanEye,
    :2742-2822 Omni): Gaussian deviations of the azimuth/elevation angles in
    the (S = radial toward nearest edge, L = tangential, U = +z) frame, with
    sigma_i = atan(lambda / (1.41 * dist_to_edge_i * 2 pi)). noise: (N, 2)
    standard normals; all lengths in mm (wavelength_mm = lambda_nm * 1e-6).
    """
    px, py = p[..., 0], p[..., 1]
    dist = jnp.sqrt(px * px + py * py)
    safe = jnp.maximum(dist, 1e-8)
    cs = jnp.where(dist > 1e-8, px / safe, 1.0)
    sn = jnp.where(dist > 1e-8, py / safe, 0.0)
    # S = radial (shortest way to the edge), L = tangential, U = +z.
    d_edge_s = jnp.maximum(aperture_r - dist, 1e-7)
    d_edge_l = jnp.sqrt(jnp.maximum(aperture_r**2 - dist**2, 1e-14))
    two_pi = 2.0 * jnp.pi
    sigma_s = jnp.arctan(wavelength_mm / (1.41 * d_edge_s * two_pi))
    sigma_l = jnp.arctan(wavelength_mm / (1.41 * d_edge_l * two_pi))
    proj_s = d[..., 0] * cs + d[..., 1] * sn
    proj_l = -d[..., 0] * sn + d[..., 1] * cs
    proj_u = d[..., 2]
    theta_a = jnp.arctan2(proj_s, proj_u) + noise[..., 0] * sigma_s
    theta_e = (
        jnp.arctan2(proj_l, jnp.sqrt(proj_s**2 + proj_u**2))
        + noise[..., 1] * sigma_l
    )
    new_l = jnp.sin(theta_e)
    new_su = jnp.cos(theta_e)
    new_s = new_su * jnp.sin(theta_a)
    new_u = new_su * jnp.cos(theta_a)
    return normalize(jnp.stack(
        [new_s * cs - new_l * sn, new_s * sn + new_l * cs, new_u], axis=-1
    ))


def _conicoid_normal(p, vz, radius, conic):
    """Gradient of the conicoid implicit function, oriented toward -z side.

    Planar surfaces (radius == 0) get the axial normal — the conicoid
    gradient degenerates to an in-plane vector there, which matters for
    planar REFRACTING faces (e.g. plano-convex microlens exits).
    """
    z = p[..., 2] - vz
    k = 1.0 + conic
    nz = jnp.where(radius == 0.0, -1.0, 2.0 * k * z - 2.0 * radius)
    zero = jnp.where(radius == 0.0, 0.0, 2.0)
    n = jnp.stack(
        [zero * p[..., 0], zero * p[..., 1], nz],
        axis=-1,
    )
    n = normalize(n)
    # Orient consistently toward the film side (-z) so refract() receives
    # eta_after/eta_before with the normal on the incident side regardless of
    # the surface's curvature sign.
    return jnp.where((n[..., 2] > 0.0)[..., None], -n, n)


def trace_through_stack(stack: LensStack, o, d, eta_start=1.0,
                        hurb_noise=None, wavelength_nm=550.0):
    """Trace rays (film side, traveling +z) through all surfaces.

    o, d: (N, 3). Returns (o_out, d_out, valid). Uses a scan over surfaces;
    invalid rays (aperture clip, TIR, miss) carry valid=False.

    hurb_noise: optional (N, 2) standard normals enabling HURB diffraction
    at planar aperture-stop surfaces (see _hurb_deflect); wavelength_nm may
    be a scalar or a per-ray (N,) array.
    """
    n_s = stack.n_surfaces
    wl_mm = jnp.asarray(wavelength_nm, jnp.float32) * 1e-6

    def body(carry, i):
        o, d, valid = carry
        vz = stack.vertex_z[i]
        radius = stack.radius[i]
        conic = stack.conic[i]
        t, ok = _intersect_conicoid(o, d, vz, radius, conic)
        if stack.has_aspheric:
            asp = stack.aspheric[i]
            t_ref = _refine_aspheric(o, d, t, vz, radius, conic, asp)
            # Refine only where aspherics are active and on curved glass.
            use = (jnp.abs(asp).sum() > 0.0) & (radius != 0.0)
            t = jnp.where(use, t_ref, t)
        p = o + t[..., None] * d
        r2 = p[..., 0] ** 2 + p[..., 1] ** 2
        ok = ok & (r2 <= stack.aperture2[i])
        is_stop = (radius == 0.0) & (stack.eta_before[i] == stack.eta_after[i])
        if stack.has_aspheric:
            asp = stack.aspheric[i]
            nrm = jnp.where(
                ((jnp.abs(asp).sum() > 0.0) & (radius != 0.0))[..., None],
                _aspheric_normal(p, vz, radius, conic, asp),
                _conicoid_normal(p, vz, radius, conic),
            )
        else:
            nrm = _conicoid_normal(p, vz, radius, conic)
        eta_rel = stack.eta_after[i] / stack.eta_before[i]
        # refract() flips the normal as needed; wi points backward from p.
        wi = -d
        v_ok, wt, _ = refract(wi, nrm, eta_rel)
        d_pass = d
        if hurb_noise is not None:
            d_hurb = _hurb_deflect(p, d, jnp.sqrt(stack.aperture2[i]),
                                   wl_mm, hurb_noise)
            d_pass = jnp.where(is_stop, d_hurb, d)
        new_d = jnp.where(is_stop, d_pass, wt)
        refr_ok = jnp.where(is_stop, True, v_ok)
        new_valid = valid & ok & refr_ok
        o_new = jnp.where(new_valid[..., None], p, o)
        d_new = jnp.where(new_valid[..., None], normalize(new_d), d)
        return (o_new, d_new, new_valid), None

    valid0 = jnp.ones(o.shape[:-1], bool)
    (o_out, d_out, valid), _ = jax.lax.scan(
        body, (o, d, valid0), jnp.arange(n_s)
    )
    return o_out, d_out, valid


def load_lens_file(path: str, eta_scene: float = 1.0) -> LensStack:
    """Parse a pbrt .dat lens description file.

    Format (cameras.cpp RealisticCamera::Create): whitespace-separated rows
    `curvature_radius thickness eta aperture_diameter`, front (scene side)
    first, '#' comments. Distances in mm; eta 0 means air; radius 0 marks
    the aperture stop plane.
    """
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) != 4:
                raise ValueError(f"bad lens row: {line!r}")
            rows.append(vals)
    if not rows:
        raise ValueError(f"empty lens file: {path}")
    return LensStack.from_pbrt_elements(np.asarray(rows, np.float64),
                                        eta_scene=eta_scene)

"""Flat material parameter arrays.

One row per scene material; `kind` is the dispatch tag. RGB parameters are
stored as fitted sigmoid-polynomial coefficients (core.rgb2spec) so spectral
evaluation at sampled wavelengths is a fused polynomial, not a table gather.

Reference analogue: the 12 material classes of
/root/reference/src/pbrt/materials.h; conductor spectral eta/k presets play
the role of pbrt's named metal spectra (spectrum.cpp metal IOR tables),
fitted here from their commonly used RGB projections.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import rgb2spec
from ..core.gather import gather_rows
from ..core.pytree import pytree, static_field

MAT_DIFFUSE = 0
MAT_CONDUCTOR = 1
MAT_DIELECTRIC = 2
MAT_THINDIELECTRIC = 3
MAT_COATEDDIFFUSE = 4
MAT_COATEDCONDUCTOR = 5
MAT_DIFFUSETRANS = 6
MAT_HAIR = 7
MAT_SUBSURFACE = 8
MAT_MEASURED = 9
MAT_MIX = 10
MAT_RETRO = 11
# Material-less boundary (pbrt Material "" / "none"): rays pass straight
# through, only switching media (interface.h MediumInterface shapes).
MAT_INTERFACE = 12
# NormalizedFresnelBxDF (bxdfs.h:1206): the BSSRDF Sw lobe; set per-lane by
# the subsurface transport (models/path.py) and by the MAT_SUBSURFACE remap
# in materials/bxdf.py — not a parser-level material kind.
MAT_NORMFRESNEL = 13

# RGB projections of measured metal IOR spectra (eta, k) — standard values
# used across renderers for Cu/Au/Ag/Al.
CONDUCTOR_PRESETS = {
    "Cu": ((0.2004, 0.9240, 1.1022), (3.9129, 2.4476, 2.1422)),
    "Au": ((0.1431, 0.3749, 1.4424), (3.9831, 2.3857, 1.6032)),
    "Ag": ((0.1553, 0.1163, 0.1381), (4.8284, 3.1222, 2.1469)),
    "Al": ((1.3450, 0.9650, 0.6170), (7.4746, 6.3995, 5.3031)),
}


def _measured_stack(tables):
    from .measured import N_PD, N_TD, N_TH, MeasuredBRDF

    if not tables:
        return dict(
            measured_coeffs=jnp.zeros((0, N_TH, N_TD, N_PD, 3), jnp.float32),
            measured_scale=jnp.zeros((0, N_TH, N_TD, N_PD), jnp.float32),
        )
    ms = [MeasuredBRDF.from_table(t) for t in tables]
    return dict(
        measured_coeffs=jnp.stack([m.coeffs for m in ms]),
        measured_scale=jnp.stack([m.scale for m in ms]),
    )


@pytree
class MaterialBuffers:
    kind: jnp.ndarray  # (M,) int32 dispatch tag
    albedo_coeffs: jnp.ndarray  # (M, 3) sigmoid coeffs of reflectance
    roughness: jnp.ndarray  # (M,) user roughness (alpha = sqrt(roughness))
    eta: jnp.ndarray  # (M,) dielectric IOR
    cond_eta_coeffs: jnp.ndarray  # (M, 3) conductor eta spectrum fit
    cond_eta_scale: jnp.ndarray  # (M,)
    cond_k_coeffs: jnp.ndarray  # (M, 3) conductor k spectrum fit
    cond_k_scale: jnp.ndarray  # (M,)
    albedo_tex: jnp.ndarray  # (M,) texture id for albedo, -1 = constant
    coat_roughness: jnp.ndarray  # (M,) coating GGX roughness (coated kinds); hair beta_n
    trans_coeffs: jnp.ndarray  # (M, 3) transmittance sigmoid coeffs (diffusetrans)
    hair_sigma_coeffs: jnp.ndarray  # (M, 3) hair sigma_a unbounded-spectrum fit
    hair_sigma_scale: jnp.ndarray  # (M,)
    hair_alpha: jnp.ndarray  # (M,) hair cuticle tilt, degrees
    thickness: jnp.ndarray  # (M,) coat layer optical thickness (coated kinds)
    ss_mfp_coeffs: jnp.ndarray  # (M, 3) subsurface mean-free-path fit
    ss_mfp_scale: jnp.ndarray  # (M,)
    measured_idx: jnp.ndarray  # (M,) index into the measured-table stack, -1
    mix_m0: jnp.ndarray  # (M,) first sub-material id (mix kinds)
    mix_m1: jnp.ndarray  # (M,) second sub-material id
    mix_amount: jnp.ndarray  # (M,) probability of picking m0
    # Stacked measured-BRDF tables (materials/measured.py): per-cell
    # unbounded-spectrum fits, (Mm, N_TH, N_TD, N_PD, 3) / (Mm, ...).
    measured_coeffs: jnp.ndarray
    measured_scale: jnp.ndarray
    # Per-material MediumInterface (media.h:55-80): index into the scene's
    # MediumStack for the medium on each side of surfaces using this
    # material. -2 = no interface (crossing keeps the ray's medium),
    # -1 = vacuum, >= 0 = stack index.
    med_inside: jnp.ndarray  # (M,) int32
    med_outside: jnp.ndarray  # (M,) int32
    any_conductor: bool = static_field(default=False)
    any_dielectric: bool = static_field(default=False)
    any_thin: bool = static_field(default=False)
    any_coated: bool = static_field(default=False)
    any_diffusetrans: bool = static_field(default=False)
    any_hair: bool = static_field(default=False)
    any_subsurface: bool = static_field(default=False)
    any_measured: bool = static_field(default=False)
    any_mix: bool = static_field(default=False)
    any_retro: bool = static_field(default=False)
    any_interface_mat: bool = static_field(default=False)

    @staticmethod
    def build(materials) -> "MaterialBuffers":
        """materials: list of dicts with keys kind, albedo (rgb), roughness,
        eta, conductor ("Cu"/"Au"/"Ag"/"Al" or (eta_rgb, k_rgb) pair)."""
        kinds, albedos, rough, eta, texids = [], [], [], [], []
        coat_rough = []
        transs = []
        c_eta, c_k = [], []
        hair_sig, hair_alpha = [], []
        thicks = []
        ss_mfp = []
        meas_idx, meas_tables = [], []
        mix_m0, mix_m1, mix_amount = [], [], []
        for m in materials:
            kinds.append(m.get("kind", MAT_DIFFUSE))
            albedos.append(m.get("albedo", (0.5, 0.5, 0.5)))
            rough.append(m.get("roughness", 0.0))
            eta.append(m.get("eta", 1.5))
            texids.append(m.get("albedo_texture", -1))
            coat_rough.append(m.get("coat_roughness", 0.05))
            transs.append(m.get("transmittance", (0.25, 0.25, 0.25)))
            cond = m.get("conductor", "Cu")
            if isinstance(cond, str):
                cond = CONDUCTOR_PRESETS[cond]
            c_eta.append(cond[0])
            c_k.append(cond[1])
            # Default sigma_a ~ brown hair (eumelanin 1.3, materials.cpp:153).
            hair_sig.append(m.get("hair_sigma_a", (0.5447, 0.9061, 1.781)))
            hair_alpha.append(m.get("hair_alpha", 2.0))
            thicks.append(m.get("thickness", 0.01))
            ss_mfp.append(m.get("mfp", (1.0, 1.0, 1.0)))
            if m.get("measured_table") is not None:
                meas_idx.append(len(meas_tables))
                meas_tables.append(m["measured_table"])
            else:
                meas_idx.append(-1)
            mix_m0.append(m.get("mix_m0", 0))
            mix_m1.append(m.get("mix_m1", 0))
            mix_amount.append(m.get("mix_amount", 0.5))
        med_in = [m.get("med_inside", -2) for m in materials]
        med_out = [m.get("med_outside", -2) for m in materials]
        coeffs = rgb2spec.fit_albedo(jnp.asarray(albedos, jnp.float32))
        ce, ces = rgb2spec.fit_unbounded(jnp.asarray(c_eta, jnp.float32))
        ck, cks = rgb2spec.fit_unbounded(jnp.asarray(c_k, jnp.float32))
        hs, hss = rgb2spec.fit_unbounded(jnp.asarray(hair_sig, jnp.float32))
        kinds_arr = jnp.asarray(kinds, jnp.int32)
        return MaterialBuffers(
            kind=kinds_arr,
            albedo_coeffs=coeffs,
            roughness=jnp.asarray(rough, jnp.float32),
            eta=jnp.asarray(eta, jnp.float32),
            cond_eta_coeffs=ce,
            cond_eta_scale=ces,
            cond_k_coeffs=ck,
            cond_k_scale=cks,
            albedo_tex=jnp.asarray(texids, jnp.int32),
            coat_roughness=jnp.asarray(coat_rough, jnp.float32),
            trans_coeffs=rgb2spec.fit_albedo(
                jnp.asarray(transs, jnp.float32)
            ),
            hair_sigma_coeffs=hs,
            hair_sigma_scale=hss,
            hair_alpha=jnp.asarray(hair_alpha, jnp.float32),
            thickness=jnp.asarray(thicks, jnp.float32),
            ss_mfp_coeffs=(lambda cs: cs[0])(
                rgb2spec.fit_unbounded(jnp.asarray(ss_mfp, jnp.float32))
            ),
            ss_mfp_scale=rgb2spec.fit_unbounded(
                jnp.asarray(ss_mfp, jnp.float32)
            )[1],
            any_conductor=any(
                k in (MAT_CONDUCTOR, MAT_COATEDCONDUCTOR) for k in kinds
            ),
            any_dielectric=any(k == MAT_DIELECTRIC for k in kinds),
            any_thin=any(k == MAT_THINDIELECTRIC for k in kinds),
            any_coated=any(
                k in (MAT_COATEDDIFFUSE, MAT_COATEDCONDUCTOR) for k in kinds
            ),
            any_diffusetrans=any(k == MAT_DIFFUSETRANS for k in kinds),
            any_hair=any(k == MAT_HAIR for k in kinds),
            any_subsurface=any(k == MAT_SUBSURFACE for k in kinds),
            any_measured=any(k == MAT_MEASURED for k in kinds),
            any_mix=any(k == MAT_MIX for k in kinds),
            any_retro=any(k == MAT_RETRO for k in kinds),
            any_interface_mat=any(k == MAT_INTERFACE for k in kinds),
            measured_idx=jnp.asarray(meas_idx, jnp.int32),
            mix_m0=jnp.asarray(mix_m0, jnp.int32),
            mix_m1=jnp.asarray(mix_m1, jnp.int32),
            mix_amount=jnp.asarray(mix_amount, jnp.float32),
            med_inside=jnp.asarray(med_in, jnp.int32),
            med_outside=jnp.asarray(med_out, jnp.int32),
            **_measured_stack(meas_tables),
        )

    def gather(self, mat_idx):
        """Per-ray material parameters.

        All fields are packed into one (M, 14) matrix so a single row
        gather serves every parameter. Packing happens inside gather so
        gradients still flow to the individual field arrays.
        """
        f32 = jnp.float32
        packed = jnp.concatenate(
            [
                self.kind.astype(f32)[:, None],
                self.albedo_coeffs,
                self.roughness[:, None],
                self.eta[:, None],
                self.cond_eta_coeffs,
                self.cond_eta_scale[:, None],
                self.cond_k_coeffs,
                self.cond_k_scale[:, None],
                self.albedo_tex.astype(f32)[:, None],
                self.coat_roughness[:, None],
                self.trans_coeffs,
                self.hair_sigma_coeffs,
                self.hair_sigma_scale[:, None],
                self.hair_alpha[:, None],
                self.thickness[:, None],
                self.ss_mfp_coeffs,
                self.ss_mfp_scale[:, None],
                self.measured_idx.astype(f32)[:, None],
            ],
            axis=1,
        )
        g = gather_rows(packed, mat_idx)  # (N, 24)
        return {
            "kind": jnp.round(g[:, 0]).astype(jnp.int32),
            "albedo_coeffs": g[:, 1:4],
            "roughness": g[:, 4],
            "eta": g[:, 5],
            "cond_eta_coeffs": g[:, 6:9],
            "cond_eta_scale": g[:, 9],
            "cond_k_coeffs": g[:, 10:13],
            "cond_k_scale": g[:, 13],
            "albedo_tex": jnp.round(g[:, 14]).astype(jnp.int32),
            "coat_roughness": g[:, 15],
            "trans_coeffs": g[:, 16:19],
            "hair_sigma_coeffs": g[:, 19:22],
            "hair_sigma_scale": g[:, 22],
            "hair_alpha": g[:, 23],
            "thickness": g[:, 24],
            "ss_mfp_coeffs": g[:, 25:28],
            "ss_mfp_scale": g[:, 28],
            "measured_idx": jnp.round(g[:, 29]).astype(jnp.int32),
            "measured_coeffs": self.measured_coeffs,
            "measured_scale": self.measured_scale,
            "any_conductor": self.any_conductor,
            "any_dielectric": self.any_dielectric,
            "any_thin": self.any_thin,
            "any_coated": self.any_coated,
            "any_diffusetrans": self.any_diffusetrans,
            "any_hair": self.any_hair,
            "any_subsurface": self.any_subsurface,
            "any_measured": self.any_measured,
            "any_mix": self.any_mix,
            "any_retro": self.any_retro,
            "any_interface_mat": self.any_interface_mat,
        }

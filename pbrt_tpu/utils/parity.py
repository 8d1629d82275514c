"""Forward-parity gate against the reference renderer's golden images.

The golden images in tests/goldens/*_ref.pfm were rendered by the reference
(scienstanford/pbrt-v4) at 4096 spp with --seed 1 (regenerate with
scripts/make_goldens.sh). A case parses the IDENTICAL .pbrt file through
our parser, renders it with the matching integrator, and gates on relative
mean-brightness error, MSE, AND a per-pixel gate: both images are 4x4
box-downsampled (averaging out residual MC noise) and the 95th percentile
of per-cell relative error must stay under the bound.

tests/test_reference_parity.py and chip_smoke.py both call `check_case`.
"""

from __future__ import annotations

import os

import numpy as np

GOLDENS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "tests", "goldens",
)

# (scene, our spp, max relative mean error, max MSE, q95 per-pixel rel)
CASES = [
    # box: indirect-dominated (one-sided light shining at the ceiling);
    # 512 spp leaves firefly variance, so the MSE bound is looser.
    ("box", 512, 0.04, 0.035, 0.6),
    ("spheres", 384, 0.035, 1e-4, 0.15),
    ("spot", 256, 0.035, 5e-4, 0.15),
    # fog: homogeneous interior medium via per-shape MediumInterface
    # (VolPath + interface-aware shadow transmittance).
    ("fog", 192, 0.06, 5e-5, 0.15),
    ("conductor", 384, 0.05, 2e-3, 0.2),
    ("dielectric", 384, 0.05, 2e-3, 0.25),
    ("texture", 256, 0.04, 1e-3, 0.15),
    ("imagetex", 256, 0.04, 1e-3, 0.15),
    ("envmap", 256, 0.05, 2e-3, 0.35),
    ("plymesh", 256, 0.04, 1e-3, 0.15),
]
CASE_BY_NAME = {c[0]: c for c in CASES}


def _downsample(img, f=4):
    h, w, c = img.shape
    return img[: h // f * f, : w // f * f].reshape(
        h // f, f, w // f, f, c
    ).mean(axis=(1, 3))


def gate(img, ref, name, rel_tol, mse_tol, q95_tol=None) -> dict:
    """Assert `img` matches the golden `ref`; returns the measured errors."""
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    rel = abs(img.mean() - ref.mean()) / ref.mean()
    mse = float(np.mean((img - ref) ** 2))
    assert rel < rel_tol, (
        f"{name}: mean {img.mean():.4f} vs ref {ref.mean():.4f} "
        f"(rel {rel:.3f})"
    )
    assert mse < mse_tol, f"{name}: MSE {mse:.6f} vs golden"
    out = {"rel": float(rel), "mse": mse}
    if q95_tol is not None:
        a = _downsample(img)
        b = _downsample(ref)
        cell_rel = np.abs(a - b) / (np.abs(b) + 0.05 * ref.mean())
        q95 = float(np.quantile(cell_rel, 0.95))
        assert q95 < q95_tol, f"{name}: q95 per-cell rel err {q95:.3f}"
        out["q95"] = q95
    return out


def golden_path(name: str) -> str:
    return os.path.join(GOLDENS, f"{name}_ref.pfm")


def check_case(name: str) -> dict:
    """Parse `<name>.pbrt`, render it at the table's spp, and gate it
    against its golden; returns the measured errors."""
    from ..io.image import read_pfm
    from ..io.parser import load_pbrt
    from ..render import render

    _, spp, rel_tol, mse_tol, q95_tol = CASE_BY_NAME[name]
    scene, camera, settings = load_pbrt(
        os.path.join(GOLDENS, f"{name}.pbrt")
    )
    img = np.asarray(
        render(
            scene, camera, settings["integrator"],
            spp=spp, samples_per_pass=8, sampler_kind="independent",
        )
    )
    return gate(img, read_pfm(golden_path(name)), name, rel_tol, mse_tol,
                q95_tol)

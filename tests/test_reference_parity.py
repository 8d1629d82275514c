"""Forward-parity gate vs the actual reference renderer (BASELINE.md north
star: "forward allclose vs pbrt CPU").

The golden images in tests/goldens/*_ref.pfm were rendered by the reference
(scienstanford/pbrt-v4) built headless via scripts/build_reference.sh, at
4096 spp with --seed 1 (regenerate with scripts/make_goldens.sh). The gate
itself (case table, mean/MSE/per-pixel bounds) lives in
pbrt_tpu/utils/parity.py, shared with chip_smoke.py.

These gates caught real transport bugs when first enabled (shadow rays
self-occluding on the sampled light's plane; dielectric eta not inverting
on exit) — keep them tight.

Coverage (round-5 extension): diffuse box, spheres, spotlight, fog medium,
rough+smooth conductor, rough+thin dielectric, procedural textures, image
texture, ImageInfinite env map, PLY mesh, BDPT, SPPM, MLT.
"""

import os

import numpy as np
import pytest

from pbrt_tpu.io.image import read_pfm
from pbrt_tpu.io.parser import load_pbrt
from pbrt_tpu.utils.parity import CASES, GOLDENS, check_case, gate

# Specialty-integrator cases: estimator families differ more between the
# implementations (start-up bias, stratification), so the gates are mean +
# MSE only.
MC_CASES = [
    ("bdpt", 256, 0.06, 0.02),
    ("sppm", 512, 0.10, 0.03),
    ("mlt", 1024, 0.10, 0.03),
]


@pytest.mark.parametrize("name,spp,rel_tol,mse_tol,q95_tol", CASES)
def test_matches_reference_render(name, spp, rel_tol, mse_tol, q95_tol):
    golden = os.path.join(GOLDENS, f"{name}_ref.pfm")
    if not os.path.exists(golden):
        pytest.skip(f"golden {name}_ref.pfm not rendered in this sandbox")
    check_case(name)


@pytest.mark.parametrize("name,spp,rel_tol,mse_tol", MC_CASES)
def test_matches_reference_mc(name, spp, rel_tol, mse_tol):
    golden = os.path.join(GOLDENS, f"{name}_ref.pfm")
    if not os.path.exists(golden):
        pytest.skip(f"golden {name}_ref.pfm not rendered in this sandbox")
    scene, camera, settings = load_pbrt(
        os.path.join(GOLDENS, f"{name}.pbrt")
    )
    integ = settings["integrator"]
    kind = type(integ).__name__
    if kind == "MLTIntegrator":
        from pbrt_tpu.models.mlt import render_mlt

        img = render_mlt(
            scene, camera, max_depth=integ.base.max_depth, seed=1,
            mutations_per_pixel=spp, n_chains=integ.n_chains,
            sigma=integ.sigma, p_large=integ.p_large,
        )
    elif kind == "SPPMIntegrator":
        img = integ.render(scene, camera, n_iterations=64, seed=1)
    elif kind == "BDPTIntegrator":
        from pbrt_tpu.models.bdpt import render_bdpt

        img = render_bdpt(
            scene, camera, spp=spp, max_depth=integ.max_depth, seed=1
        )
    else:
        pytest.fail(f"unexpected integrator {kind} for {name}")
    img = np.asarray(img)
    ref = read_pfm(golden)
    gate(img, ref, name, rel_tol, mse_tol)

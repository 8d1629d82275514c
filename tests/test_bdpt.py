"""BDPT correctness gates.

Modeled on the reference's analytic render tests
(/root/reference/src/pbrt/cpu/integrators_test.cpp:274-435): BDPT must
converge to the same image as the unidirectional Path integrator. Also
checks the per-strategy decomposition: with MIS disabled every (s, t)
strategy class is an independent unbiased estimator of its path-length
class, so class sums must match across strategies.
"""

import numpy as np
import jax.numpy as jnp

from pbrt_tpu.models.bdpt import BDPTIntegrator, render_bdpt
from pbrt_tpu.models.path import PathIntegrator
from pbrt_tpu.render import render
from pbrt_tpu.scenes.cornell import cornell_box


def test_bdpt_matches_path_cornell():
    """Mean image value of BDPT vs Path on the Cornell box, the reference's
    +-0.025 CheckSceneAverage gate scaled to the scene's mean radiance."""
    scene, camera = cornell_box(resolution=(10, 10))
    img_p = np.asarray(
        render(scene, camera, PathIntegrator(max_depth=3), spp=80, seed=1)
    )
    img_b = np.asarray(render_bdpt(scene, camera, spp=80, max_depth=3, seed=2))
    mp, mb = img_p.mean(), img_b.mean()
    assert abs(mp - mb) < 0.025, (mp, mb)


def test_bdpt_strategy_classes_consistent():
    """With MIS off, each (s, t) strategy with s + t = k vertices estimates
    the same transport integral; compare the 3-vertex strategies (0,3) and
    (1,2) against each other (both = one-bounce direct lighting).

    Runs in a SUBPROCESS: the eager (unjitted) per-strategy accumulation
    creates tens of thousands of small XLA executables, and this
    environment's XLA CPU client segfaults on a later large compile after
    that much churn (seen as a backend_compile_and_load SIGSEGV in
    unrelated tests). Process isolation contains the damage.
    """
    import subprocess
    import sys

    script = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from pbrt_tpu.core import spectrum
from pbrt_tpu.films.rgb import spectrum_to_rgb
from pbrt_tpu.models.bdpt import BDPTIntegrator
from pbrt_tpu.samplers.samplers import Sampler
from pbrt_tpu.scenes.cornell import cornell_box

scene, camera = cornell_box(resolution=(10, 10))
nx, ny = camera.resolution
pixel = jnp.arange(nx * ny, dtype=jnp.int32)
sink = {}
integ = BDPTIntegrator(max_depth=2, debug_sink=sink, disable_mis=True)
sampler = Sampler.create("independent", spp=64, seed=3, nx=nx)
acc = {}
spp = 64
for s in range(spp):
    u = sampler.get_1d(pixel, s, 4)
    wl = spectrum.sample_visible(u)
    _L, _splat, _ = integ.trace(scene, camera, wl, pixel, jnp.int32(s), sampler)
    for k, v in sink.items():
        acc[k] = acc.get(k, 0.0) + float(np.asarray(spectrum_to_rgb(v, wl)).mean())
a = acc[(0, 3)] / spp
b = acc[(1, 2)] / spp
assert abs(a - b) < 0.35 * max(a, b), (a, b)
print("strategies agree:", a, b)
"""
    r = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=1200,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "strategies agree" in r.stdout


def test_bdpt_specular_smoke():
    """Specular Cornell variant (glass sphere + copper): finite image with
    nonzero caustic-capable splat energy."""
    scene, camera = cornell_box(resolution=(12, 12), variant="specular")
    img = np.asarray(render_bdpt(scene, camera, spp=8, max_depth=3, seed=5))
    assert np.all(np.isfinite(img))
    assert img.mean() > 0.01

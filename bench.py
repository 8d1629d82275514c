#!/usr/bin/env python
"""Benchmark: BASELINE.json configs on one GPU.

Headline (the ONE JSON line's "value"): Cornell box (config 1) forward
render throughput at 8 hero-wavelength lanes, Mrays/s/chip, counting live
closest-hit + shadow-ray queries (the quantity the reference's wavefront
kernels dispatch per bounce). vs_baseline is against the 50 Mrays/s/chip
north star (BASELINE.md).

Secondary metrics ride in "extra": config 1 at the 32-lane library default,
config 1 forward+backward (jax.value_and_grad over albedo + emission — the
north star is "fwd+bwd >= 50"), and forward numbers for config 2
(killeroo-class 122k-tri mesh, sweep intersector), config 3 (1024-light
hall, power light sampler) and config 4 (procedural cloud, VolPath + DDA
majorants). Each mode runs in its own child process (the spectral lane
width is fixed at import), one at a time; the parent never imports JAX.
A mode that fails or times out fails the run: the record names it and the
exit code is non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

MODE_TIMEOUT_S = 600.0


def _setup_jax():
    import jax

    from pbrt_tpu.utils import compile_cache

    compile_cache.enable()
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench: needs a GPU, JAX backend is {jax.default_backend()!r}"
        )
    return jax


def _timed_passes(render_pass, scene, n_passes):
    """Warm up once, then time n_passes passes ending in block_until_ready.
    Returns (Mrays/s, rays counted)."""
    import jax

    _, nrays = render_pass(scene, 0)
    jax.block_until_ready(nrays)
    t0 = time.perf_counter()
    rays = []
    for p in range(n_passes):
        rays.append(render_pass(scene, p)[1])
    jax.block_until_ready(rays)
    dt = time.perf_counter() - t0
    total = float(sum(float(r) for r in rays))
    return total / dt / 1e6


def _forward(scene, camera, integrator, spp, samples_per_pass):
    """Forward throughput of spp samples in passes of samples_per_pass."""
    jax = _setup_jax()
    import jax.numpy as jnp

    from pbrt_tpu.films.rgb import spectrum_to_rgb
    from pbrt_tpu.render import camera_rays

    nx, ny = camera.resolution
    npix = nx * ny
    pixel = jnp.arange(npix, dtype=jnp.int32)
    k = samples_per_pass
    pixel_b = jnp.tile(pixel, (k,))

    @jax.jit
    def render_pass(scene, pass_idx):
        sample_b = jnp.repeat(
            pass_idx * k + jnp.arange(k, dtype=jnp.int32), npix)
        o, d, wl = camera_rays(camera, pixel_b, sample_b, jnp.int32(0))
        radiance, stats = integrator.trace_with_stats(
            scene, o, d, wl, pixel_b, sample_b, jnp.int32(0)
        )
        rgb = spectrum_to_rgb(radiance, wl)
        img = jnp.mean(rgb.reshape(k, ny, nx, 3), axis=0)
        return img, stats["rays"]

    return _timed_passes(render_pass, scene, max(1, spp // k))


def _mode_cornell():
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.scenes.cornell import cornell_box

    _setup_jax()
    scene, camera = cornell_box(resolution=(256, 256))
    # No Russian roulette inside the fixed-depth loop: killed rays free no
    # kernel time in the masked-lockstep design.
    integrator = PathIntegrator(max_depth=5, rr_start_depth=5)
    return _forward(scene.with_accel(), camera, integrator, 128, 64)


def _mode_cornell_fwdbwd(res=256, spp=64, samples_per_pass=2, max_depth=5):
    """Forward+backward: value_and_grad over albedo coeffs + light scale.

    Mrays/s counts the FORWARD rays dispatched per pass divided by the
    full fwd+bwd wall time (the reference-style accounting for training
    throughput).
    """
    jax = _setup_jax()
    import jax.numpy as jnp

    from pbrt_tpu.films.rgb import spectrum_to_rgb
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.render import camera_rays
    from pbrt_tpu.scenes.cornell import cornell_box

    scene, camera = cornell_box(resolution=(res, res))
    scene = scene.with_accel()
    integrator = PathIntegrator(max_depth=max_depth, rr_start_depth=max_depth)
    nx, ny = camera.resolution
    npix = nx * ny
    pixel = jnp.arange(npix, dtype=jnp.int32)
    k = samples_per_pass
    pixel_b = jnp.tile(pixel, (k,))
    target = jnp.full((npix * k, 3), 0.25, jnp.float32)

    @jax.jit
    def count_pass(scene):
        sample_b = jnp.repeat(jnp.arange(k, dtype=jnp.int32), npix)
        o, d, wl = camera_rays(camera, pixel_b, sample_b, jnp.int32(0))
        _, stats = integrator.trace_with_stats(
            scene, o, d, wl, pixel_b, sample_b, jnp.int32(0)
        )
        return stats["rays"]

    @jax.jit
    def grad_pass(scene, pass_idx):
        def loss_fn(albedo_coeffs, area_scale):
            s = scene.replace(
                materials=scene.materials.replace(
                    albedo_coeffs=albedo_coeffs),
                lights=scene.lights.replace(area_scale=area_scale),
            )
            sample_b = jnp.repeat(
                pass_idx * k + jnp.arange(k, dtype=jnp.int32), npix)
            o, d, wl = camera_rays(camera, pixel_b, sample_b, jnp.int32(0))
            radiance = integrator.trace(
                s, o, d, wl, pixel_b, sample_b, jnp.int32(0))
            rgb = spectrum_to_rgb(radiance, wl)
            return jnp.mean((rgb - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            scene.materials.albedo_coeffs, scene.lights.area_scale)
        return grads, loss

    nrays_pass = float(count_pass(scene))

    def timed(scene, p):
        grads, loss = grad_pass(scene, jnp.int32(p))
        return grads, loss * 0.0 + nrays_pass

    return _timed_passes(timed, scene, spp // samples_per_pass)


def _mode_killeroo():
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.scenes.meshes import killeroo_class_scene

    _setup_jax()
    scene, camera = killeroo_class_scene(resolution=(512, 512))
    return _forward(scene, camera, PathIntegrator(max_depth=5,
                                                  rr_start_depth=5), 8, 4)


def _mode_manylight():
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.scenes.manylight import manylight_scene

    _setup_jax()
    scene, camera = manylight_scene(resolution=(256, 256))
    return _forward(scene, camera, PathIntegrator(max_depth=4,
                                                  rr_start_depth=4), 16, 8)


def _mode_cloud():
    from pbrt_tpu.models.volpath import VolPathIntegrator
    from pbrt_tpu.scenes.cloud import cloud_scene

    _setup_jax()
    scene, camera = cloud_scene(resolution=(128, 128))
    return _forward(scene, camera,
                    VolPathIntegrator(max_depth=6, use_dda=True), 16, 8)


# (mode, spectral lanes, record key); the first is the headline.
PLAN = [
    ("cornell", 8, "cornell_fwd_8lane"),
    ("cornell_fwdbwd", 8, "cornell_fwdbwd_8lane"),
    ("killeroo", 8, "killeroo_fwd"),
    ("manylight", 8, "manylight_fwd"),
    ("cloud", 8, "cloud_fwd"),
    ("cornell", 32, "cornell_fwd_32lane"),
]
MODES = {
    "cornell": _mode_cornell,
    "cornell_fwdbwd": _mode_cornell_fwdbwd,
    "killeroo": _mode_killeroo,
    "manylight": _mode_manylight,
    "cloud": _mode_cloud,
}


def worker(mode: str) -> None:
    """Measure one mode in-process; print one RESULT line."""
    import jax

    mrays = MODES[mode]()
    dev = jax.devices()[0]
    print("RESULT " + json.dumps({
        "mode": mode, "mrays": mrays, "platform": dev.platform,
        "kind": dev.device_kind, "count": len(jax.devices()),
    }), flush=True)


def _run_child(mode: str, lanes: int):
    """Run one measurement child. Returns (result dict or None, error)."""
    env = dict(os.environ, PBRT_TPU_NSPECTRUM=str(lanes))
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", mode],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            timeout=MODE_TIMEOUT_S, env=env,
        )
    except subprocess.TimeoutExpired:
        return None, f"timed out after {MODE_TIMEOUT_S:.0f}s"
    for line in proc.stdout.decode("utf-8", "replace").splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):]), None
    tail = proc.stderr.decode("utf-8", "replace").strip().splitlines()[-3:]
    return None, f"rc={proc.returncode}: " + " | ".join(tail)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def main() -> int:
    results, errors = {}, {}
    device = None
    for mode, lanes, key in PLAN:
        res, err = _run_child(mode, lanes)
        if res is None:
            errors[key] = err
            continue
        results[key] = res["mrays"]
        device = {k: res[k] for k in ("platform", "kind", "count")}
    headline = results.get(PLAN[0][2], 0.0)
    record = {
        "metric": "cornell_forward_throughput",
        "value": headline,
        "unit": "Mrays/s/chip",
        "vs_baseline": headline / 50.0,
        "extra": {k: v for k, v in results.items() if k != PLAN[0][2]},
        "device": device,
        "card": _card(),
    }
    if errors:
        record["error"] = "; ".join(f"{k}: {v}" for k, v in errors.items())
    print(json.dumps(record), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker(sys.argv[sys.argv.index("--worker") + 1])
    else:
        sys.exit(main())

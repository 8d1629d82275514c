#!/usr/bin/env python
"""Bring-up check of the renderer on one NVIDIA GPU.

    python chip_smoke.py            # phases 0-2 on one card
    python chip_smoke.py --multi    # phase 3 only, on four cards
    python chip_smoke.py --rehearse # phases 0-2 at toy sizes on any backend

Phase 0 names the device and the card. Phase 1 compiles each Pallas
traversal kernel for the card and compares it, at real widths, with the
dense reference (accel/dense.py). Phase 2 drives the main path: the
reference-parity scenes through the .pbrt parser, the furnace oracle,
full-width forward renders, and one value_and_grad step checked against
central finite differences. Phase 3 (--multi) renders tile- and
spp-sharded and takes a training step on a four-card mesh and on one card
of the same machine, and compares them.

Everything runs in this one process (a second JAX process on the card would
fail for want of memory). The last line of standard output is one JSON
object; it is printed only when every phase passed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def card_info() -> str:
    """Name and power limit of the card, read without JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


class Phase:
    """Times a phase and reports wall time and peak device memory."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        state = "FAILED" if exc[0] else "ok"
        log(f"   {self.name}: {state} wall={dt:.2f}s "
            f"peak_bytes_in_use={peak_bytes()}")
        return False


def compile_and_run(name, fn, *args):
    """AOT-compile `fn`, print compile time and memory analysis, run once."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    t_run = time.perf_counter() - t0
    log(f"   {name}: compile={t_compile:.2f}s run={t_run:.3f}s "
        f"memory_analysis={compiled.memory_analysis()}")
    return out


# ---- phase 1: kernels against the dense reference ------------------------


def phase_kernels(small: bool):
    import jax.numpy as jnp
    import numpy as np

    from pbrt_tpu.io.parser import load_pbrt_string
    from pbrt_tpu.render import camera_rays
    from pbrt_tpu.scenes.cornell import cornell_box
    from pbrt_tpu.scenes.meshes import killeroo_class_scene
    from pbrt_tpu.shapes.geometry import GeometryBuffers
    from pbrt_tpu.utils import hitcheck

    def cam(camera, spp=1):
        nx, ny = camera.resolution
        pixel = jnp.tile(jnp.arange(nx * ny, dtype=jnp.int32), (spp,))
        sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), nx * ny)
        o, d, _ = camera_rays(camera, pixel, sample, jnp.int32(0))
        return o, d

    big = 1 << (12 if small else 20)
    with Phase("kernel: brute force, Cornell box"):
        side = int(np.sqrt(big))
        scene, camera = cornell_box(resolution=(side, side))
        scene = scene.with_accel()
        assert scene.small is not None
        hitcheck.check_accel("cornell", scene, scene.geom, cam(camera), 1 << 17,
                             run=compile_and_run, log=log)
    with Phase("kernel: brute force, 1024-triangle soup"):
        tris, mat, light = hitcheck.soup(1024, seed=0)
        geom = GeometryBuffers.build(tri_verts=tris, tri_mat=mat,
                                     tri_light=light)
        scene, _ = cornell_box(resolution=(8, 8))
        scene = scene.replace(geom=geom).with_accel(threshold=1024)
        assert scene.small is not None and scene.small.n_tris == 1024
        rays = hitcheck.look_rays(big, (0, 0, -6), (-1.5,) * 3, (1.5,) * 3)
        hitcheck.check_accel("soup1024", scene, geom, rays, 1 << 17,
                             run=compile_and_run, log=log)
    with Phase("kernel: sweep, killeroo-class mesh"):
        res = 64 if small else 512
        scene, camera = killeroo_class_scene(resolution=(res, res))
        assert scene.sweep is not None
        log(f"   triangles={scene.geom.num_triangles} "
            f"clusters={scene.sweep.n_clusters}")
        hitcheck.check_accel("killeroo", scene, scene.geom, cam(camera),
                             1 << 16, run=compile_and_run, log=log)
    with Phase("kernel: sweep, instanced icospheres via the parser"):
        n_inst = 64 if small else 1000
        si, _, _ = load_pbrt_string(hitcheck.instanced_pbrt(n_inst, seed=4))
        sf, _, _ = load_pbrt_string(
            hitcheck.instanced_pbrt(n_inst, seed=4, flatten=True))
        assert si.sweep is not None and si.sweep.instanced
        n_proto = si.geom.num_triangles
        assert sf.geom.num_triangles == n_inst * n_proto
        log(f"   instances={n_inst} prototype triangles={n_proto} "
            f"flattened triangles={sf.geom.num_triangles}")
        side = 20.0
        rays = hitcheck.look_rays(1 << (12 if small else 18), (0, 0, -60),
                                  (-side,) * 3, (side,) * 3, seed=5)
        hitcheck.check_accel(
            "instanced", si, sf.geom, rays, 1 << 16,
            ref_prim=lambda p, v: np.where(v, p % n_proto, -1),
            run=compile_and_run, log=log,
        )


# ---- phase 2: the main path ----------------------------------------------


def render_case(name, scene, camera, integrator, spp, samples_per_pass,
                **kw):
    import numpy as np

    from pbrt_tpu.render import render

    def f(scene):
        return render(scene, camera, integrator, spp=spp,
                      samples_per_pass=samples_per_pass, **kw)

    img = np.asarray(compile_and_run(name, f, scene))
    nx, ny = camera.resolution
    assert img.shape == (ny, nx, 3), img.shape
    assert np.isfinite(img).all(), f"{name}: non-finite pixels"
    assert img.mean() > 1e-3, f"{name}: black image ({img.mean()})"
    log(f"   {name}: shape={img.shape} mean={img.mean():.5f} "
        f"min={img.min():.5f} max={img.max():.5f}")
    return img


def phase_main(small: bool):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pbrt_tpu.films.rgb import spectrum_to_rgb
    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.models.volpath import VolPathIntegrator
    from pbrt_tpu.render import camera_rays
    from pbrt_tpu.scenes.analytic import furnace_sphere_scene
    from pbrt_tpu.scenes.cloud import cloud_scene
    from pbrt_tpu.scenes.cornell import cornell_box
    from pbrt_tpu.scenes.manylight import manylight_scene
    from pbrt_tpu.scenes.meshes import killeroo_class_scene
    from pbrt_tpu.utils import parity

    if not small:
        for name in ("box", "plymesh", "envmap", "fog"):
            with Phase(f"parity: {name}"):
                log(f"   {name}: {parity.check_case(name)}")

    with Phase("furnace oracle"):
        res = 8 if small else 128
        scene, camera = furnace_sphere_scene(albedo=0.5, intensity=np.pi,
                                             resolution=(res, res))
        integ = PathIntegrator(max_depth=16, rr_start_depth=100)
        npix = res * res
        spp = 4

        def mean_l(scene):
            pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (spp,))
            sample = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), npix)
            o, d, wl = camera_rays(camera, pixel, sample, jnp.int32(0))
            return jnp.mean(integ.trace(scene, o, d, wl, pixel, sample,
                                        jnp.int32(0)))

        mean = float(compile_and_run("furnace", mean_l, scene))
        log(f"   furnace mean radiance={mean:.5f} (expect 1.0 +- 0.025)")
        assert abs(mean - 1.0) < 0.025, mean

    r = (lambda full, tiny: tiny if small else full)
    with Phase("render: Cornell box"):
        scene, camera = cornell_box(resolution=(r(256, 16),) * 2)
        render_case("cornell", scene.with_accel(), camera,
                    PathIntegrator(max_depth=5), spp=r(64, 4),
                    samples_per_pass=r(16, 2))
    with Phase("render: killeroo-class mesh"):
        scene, camera = killeroo_class_scene(resolution=(r(512, 16),) * 2)
        render_case("killeroo", scene, camera, PathIntegrator(max_depth=5),
                    spp=r(8, 2), samples_per_pass=r(4, 2))
    with Phase("render: many lights"):
        scene, camera = manylight_scene(resolution=(r(256, 16),) * 2)
        render_case("manylight", scene, camera, PathIntegrator(max_depth=4),
                    spp=r(16, 2), samples_per_pass=r(8, 2))
    with Phase("render: cloud, VolPath with DDA"):
        scene, camera = cloud_scene(resolution=(r(256, 16),) * 2)
        render_case("cloud", scene, camera,
                    VolPathIntegrator(max_depth=6, use_dda=True),
                    spp=r(16, 2), samples_per_pass=r(8, 2))

    with Phase("value_and_grad step vs finite differences"):
        res = r(256, 8)
        scene, camera = cornell_box(resolution=(res, res))
        scene = scene.with_accel()
        integ = PathIntegrator(max_depth=5, rr_start_depth=5)
        npix = res * res
        k = 2
        pixel = jnp.tile(jnp.arange(npix, dtype=jnp.int32), (k,))
        sample = jnp.repeat(jnp.arange(k, dtype=jnp.int32), npix)
        target = jnp.full((npix * k, 3), 0.25, jnp.float32)

        def loss_fn(albedo_coeffs, area_scale):
            s = scene.replace(
                materials=scene.materials.replace(
                    albedo_coeffs=albedo_coeffs),
                lights=scene.lights.replace(area_scale=area_scale),
            )
            o, d, wl = camera_rays(camera, pixel, sample, jnp.int32(0))
            rgb = spectrum_to_rgb(
                integ.trace(s, o, d, wl, pixel, sample, jnp.int32(0)), wl)
            return jnp.mean((rgb - target) ** 2)

        ac = scene.materials.albedo_coeffs
        ls = scene.lights.area_scale
        loss, (g_ac, g_ls) = compile_and_run(
            "value_and_grad",
            jax.value_and_grad(loss_fn, argnums=(0, 1)), ac, ls)
        g_ac, g_ls = np.asarray(g_ac), np.asarray(g_ls)
        assert np.isfinite(float(loss))
        assert np.isfinite(g_ac).all() and np.isfinite(g_ls).all()
        loss_j = jax.jit(loss_fn)
        # Albedo: top-3 coefficients, central differences, rtol 0.05 (the
        # tolerance of tests/test_gradients.py).
        eps = 1e-2
        t0 = np.asarray(ac)
        for i in np.argsort(-np.abs(g_ac.ravel()))[:3]:
            tp, tm = t0.ravel().copy(), t0.ravel().copy()
            tp[i] += eps
            tm[i] -= eps
            fd = (float(loss_j(jnp.asarray(tp.reshape(t0.shape)), ls))
                  - float(loss_j(jnp.asarray(tm.reshape(t0.shape)), ls))
                  ) / (2 * eps)
            ad = float(g_ac.ravel()[i])
            log(f"   d loss / d albedo[{i}]: ad={ad:.6e} fd={fd:.6e}")
            assert abs(fd - ad) <= 0.05 * max(abs(fd), abs(ad), 1e-6)
        # Emission: the summed light-scale gradient, rtol 0.03.
        eps = 0.1
        fd = (float(loss_j(ac, ls + eps)) - float(loss_j(ac, ls - eps))) \
            / (2 * eps)
        log(f"   d loss / d area_scale: ad={g_ls.sum():.6e} fd={fd:.6e}")
        assert abs(g_ls.sum() - fd) <= 0.03 * max(abs(fd), 1e-6)
        log(f"   loss={float(loss):.6f}")


# ---- phase 3: four cards -------------------------------------------------


def phase_multi(small: bool):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pbrt_tpu.models.path import PathIntegrator
    from pbrt_tpu.parallel.mesh import make_mesh
    from pbrt_tpu.parallel.render import (
        render_spp_sharded, render_tile_sharded,
    )
    from pbrt_tpu.parallel.train import training_step
    from pbrt_tpu.scenes.cornell import cornell_box

    n = len(jax.devices())
    assert n >= 4, f"--multi needs four devices, found {n}"
    mesh4, mesh1 = make_mesh(4), make_mesh(1)
    res = 32 if small else 256
    scene, camera = cornell_box(resolution=(res, res))
    scene = scene.with_accel()
    integ = PathIntegrator(max_depth=5)
    spp = 8

    def on_devices(x):
        return sorted({d.id for d in x.sharding.device_set})

    failures = []

    def sub(name, fn):
        """Run every comparison and report each, then fail if any did."""
        try:
            with Phase(name):
                fn()
        except AssertionError as e:
            failures.append(f"{name}: {e}")

    def tiles():
        # The default tile size does not follow the device count: every
        # tile runs the same per-device program, so the images must agree
        # bit for bit.
        t0 = time.perf_counter()
        img4 = render_tile_sharded(scene, camera, integ, mesh4, spp=spp)
        img4.block_until_ready()
        log(f"   4 cards: {time.perf_counter() - t0:.2f}s "
            f"devices={on_devices(img4)}")
        t0 = time.perf_counter()
        img1 = render_tile_sharded(scene, camera, integ, mesh1, spp=spp)
        img1.block_until_ready()
        log(f"   1 card:  {time.perf_counter() - t0:.2f}s")
        a, b = np.asarray(img4), np.asarray(img1)
        log(f"   mean={a.mean():.5f} bitwise equal: {np.array_equal(a, b)} "
            f"max abs diff={np.abs(a - b).max():.3e}")
        assert len(on_devices(img4)) == 4, on_devices(img4)
        assert np.isfinite(a).all() and a.mean() > 1e-3
        assert np.array_equal(a, b), "tile-sharded images differ"

    def spps():
        t0 = time.perf_counter()
        img4 = render_spp_sharded(scene, camera, integ, mesh4, spp=spp)
        img4.block_until_ready()
        log(f"   4 cards: {time.perf_counter() - t0:.2f}s")
        t0 = time.perf_counter()
        img1 = render_spp_sharded(scene, camera, integ, mesh1, spp=spp)
        img1.block_until_ready()
        log(f"   1 card:  {time.perf_counter() - t0:.2f}s")
        a, b = np.asarray(img4), np.asarray(img1)
        log(f"   mean={a.mean():.5f} "
            f"max rel diff={np.abs(a - b).max() / np.abs(b).max():.3e}")
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    def train():
        npix = res * res
        pixel = jnp.arange(npix, dtype=jnp.int32)
        target = jnp.full((npix, 3), 0.25, jnp.float32)
        t0 = time.perf_counter()
        loss4, new4 = training_step(mesh4, scene, camera, integ, pixel,
                                    target)
        loss4.block_until_ready()
        log(f"   4 cards: {time.perf_counter() - t0:.2f}s albedo on "
            f"devices={on_devices(new4.materials.albedo_coeffs)}")
        t0 = time.perf_counter()
        loss1, new1 = training_step(mesh1, scene, camera, integ, pixel,
                                    target)
        loss1.block_until_ready()
        log(f"   1 card:  {time.perf_counter() - t0:.2f}s")
        log(f"   loss 4 cards={float(loss4):.8f} 1 card={float(loss1):.8f}")
        np.testing.assert_allclose(float(loss4), float(loss1), rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(new4.materials.albedo_coeffs),
            np.asarray(new1.materials.albedo_coeffs), rtol=1e-5, atol=1e-6)

    sub("multi: tile-sharded render", tiles)
    sub("multi: spp-sharded render", spps)
    sub("multi: training step", train)
    assert not failures, failures


def main(argv) -> int:
    multi = "--multi" in argv
    rehearse = "--rehearse" in argv
    if not os.path.isdir(os.path.join(HERE, "pbrt_tpu")):
        print("chip_smoke: the pbrt_tpu package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    card = card_info()
    import jax

    from pbrt_tpu.utils import compile_cache

    log(f"== device\n   jax {jax.__version__} devices={jax.devices()}")
    if jax.default_backend() != "gpu" and not rehearse:
        print(f"chip_smoke: JAX backend is {jax.default_backend()!r}, "
              "not a GPU", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    log(f"   device_kind={dev.device_kind}")
    log(f"   compile cache: {compile_cache.enable()}")
    t_all = time.perf_counter()
    if multi:
        phase_multi(rehearse)
    else:
        phase_kernels(rehearse)
        phase_main(rehearse)
    log(f"== all phases passed in {time.perf_counter() - t_all:.1f}s")
    log(f"card: {card}")
    result = {"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if multi else len(jax.devices()),
    }}
    if rehearse:
        log(f"rehearsal (not a chip result): {json.dumps(result)}")
        return 0
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

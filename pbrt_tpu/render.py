"""Render orchestration: camera sample generation -> integrator -> film.

Reference analogue: ImageTileIntegrator::Render + EvaluatePixelSample
(/root/reference/src/pbrt/cpu/integrators.cpp:67-288) and the wavefront
Render() loop (wavefront/integrator.cpp:290-493). The reference parallelizes
with tiles/queues; here one jitted function evaluates a whole *sample wave*
(every pixel x samples_per_pass samples) as a single batched program, and a
fori_loop runs waves so compile happens once and memory stays bounded at
O(pixels x samples_per_pass) in-flight rays — the batched version of the 1M-sample
in-flight cap (wavefront/integrator.cpp:227-236).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .cameras.perspective import PerspectiveCamera
from .core import spectrum
from .films.rgb import RGBFilm, spectrum_to_rgb
from .models.path import PathIntegrator
from .scene import Scene


def camera_rays_full(camera, pixel, sample_idx, sampler, jitter: bool = True,
                     filt=None):
    """Generate primary rays + wavelengths + camera weight for pixel ids.

    Works with every camera family: pinhole-style cameras return (o, d) from
    generate_rays; lens cameras (Realistic/Omni/HumanEye/RTF) additionally
    return a per-ray weight (0 = vignetted). sampler: a samplers.Sampler or
    an int seed (-> independent). filt: optional filters.Filter for
    importance-sampled reconstruction (box jitter otherwise).
    """
    from .samplers.samplers import as_sampler

    sampler = as_sampler(sampler)
    nx, ny = camera.resolution
    jx, jy = sampler.get_2d(pixel, sample_idx, 0)
    w_filter = None
    if not jitter:
        jx = jnp.full_like(jx, 0.5)
        jy = jnp.full_like(jy, 0.5)
    elif filt is not None and filt.kind != "box":
        fs = filt.sample(jnp.stack([jx, jy], axis=-1))
        jx = 0.5 + fs.p[..., 0]
        jy = 0.5 + fs.p[..., 1]
        w_filter = fs.weight
    px = (pixel % nx).astype(jnp.float32) + jx
    py = (pixel // nx).astype(jnp.float32) + jy
    p_film = jnp.stack([px, py], axis=-1)
    ul0, ul1 = sampler.get_2d(pixel, sample_idx, 2)
    kw = {}
    if getattr(camera, "motion", None) is not None:
        # Shutter-time sample (dim 5) drives camera motion blur.
        u_t = sampler.get_1d(pixel, sample_idx, 5)
        kw["time"] = camera.sample_time(u_t)
    u_wl = sampler.get_1d(pixel, sample_idx, 4)
    wl = spectrum.sample_visible(u_wl)
    if getattr(camera, "diffraction", False):
        # HURB needs the hero wavelength inside the lens trace.
        kw["wavelength_nm"] = wl.hero
    out = camera.generate_rays(p_film, jnp.stack([ul0, ul1], axis=-1), **kw)
    if len(out) == 3:
        o, d, w = out
    else:
        o, d = out
        w = jnp.ones_like(px)
    if w_filter is not None:
        w = w * w_filter
    return o, d, wl, w


def camera_rays(camera, pixel, sample_idx, sampler, jitter: bool = True):
    """Back-compat 3-tuple variant (weight dropped)."""
    o, d, wl, _ = camera_rays_full(camera, pixel, sample_idx, sampler, jitter)
    return o, d, wl


@functools.partial(
    jax.jit,
    static_argnames=(
        "integrator", "spp", "samples_per_pass", "jitter", "sampler_kind",
        "total_spp", "filter_kind",
    ),
)
def render(
    scene: Scene,
    camera: PerspectiveCamera,
    integrator: PathIntegrator,
    spp: int = 16,
    seed: int = 0,
    samples_per_pass: int = 1,
    jitter: bool = True,
    sampler_kind: str = "independent",
    sample_offset: int = 0,
    total_spp: int | None = None,
    filter_kind: str = "box",
) -> jnp.ndarray:
    """Render and return the developed linear-RGB image (ny, nx, 3).

    sample_offset/total_spp support chunked rendering (render_chunked): this
    call covers sample indices [sample_offset, sample_offset + spp) of a
    total_spp-sample render.
    """
    from .samplers.samplers import Sampler

    res_nx, res_ny = camera.resolution
    sampler = Sampler(
        seed=jnp.asarray(seed, jnp.int32),
        kind=sampler_kind,
        spp=total_spp or spp,
        nx=res_nx,
        log2_res=max(1, (max(res_nx, res_ny) - 1).bit_length()),
    )
    filt = None
    if filter_kind != "box":
        from .filters.filters import Filter

        filt = Filter.create(filter_kind)
    nx, ny = camera.resolution
    npix = nx * ny
    pixel = jnp.arange(npix, dtype=jnp.int32)
    assert spp % samples_per_pass == 0, "spp must divide by samples_per_pass"
    n_passes = spp // samples_per_pass

    k = samples_per_pass
    pixel_b = jnp.tile(pixel, (k,))  # (k*npix,)

    def one_pass(pass_idx, film: RGBFilm) -> RGBFilm:
        sample_b = jnp.repeat(
            sample_offset + pass_idx * k + jnp.arange(k, dtype=jnp.int32),
            npix,
        )
        o, d, wl, w = camera_rays_full(
            camera, pixel_b, sample_b, sampler, jitter, filt
        )
        radiance = integrator.trace(
            scene, o, d, wl, pixel_b, sample_b, sampler
        )
        rgb = spectrum_to_rgb(radiance, wl) * w[:, None]  # (k*npix, 3)
        # NaN/Inf sample quarantine: drop non-finite samples (value AND
        # weight), as the reference does per-sample in Film::AddSample
        # (cpu/integrators.cpp:264-274) — one bad ray must not poison its
        # pixel forever.
        finite = jnp.all(jnp.isfinite(rgb), axis=-1)
        rgb = jnp.where(finite[:, None], rgb, 0.0)
        rgb_img = jnp.sum(rgb.reshape(k, ny, nx, 3), axis=0) / k
        w_img = jnp.mean(finite.astype(rgb.dtype).reshape(k, ny, nx), axis=0)
        rgb_img = jnp.where(
            w_img[..., None] > 0.0,
            rgb_img / jnp.maximum(w_img, 1e-12)[..., None],
            0.0,
        )
        return film.add_sample_image(rgb_img, w_img)

    film = RGBFilm.zeros((nx, ny))
    film = jax.lax.fori_loop(0, n_passes, one_pass, film)
    return film.image()


def render_chunked(
    scene: Scene,
    camera,
    integrator,
    spp: int = 64,
    seed: int = 0,
    samples_per_pass: int = 4,
    chunk_spp: int = 8,
    **kw,
) -> jnp.ndarray:
    """render() split into multiple device calls of chunk_spp each.

    Large single XLA programs can exceed device watchdog limits (and hold the
    chip for minutes); chunking keeps each call short while sample indices
    continue across chunks, so the result equals one big render.
    """
    chunk_spp = max(samples_per_pass, chunk_spp - chunk_spp % samples_per_pass)
    imgs = []
    done = 0
    import math

    while done < spp:
        cur = min(chunk_spp, spp - done)
        imgs.append(
            render(
                scene, camera, integrator,
                spp=cur,
                seed=seed,
                # Tail chunks may not divide by samples_per_pass; shrink to
                # the gcd so render()'s divisibility invariant always holds.
                samples_per_pass=math.gcd(samples_per_pass, cur),
                sample_offset=done,
                total_spp=spp,
                **kw,
            )
            * cur
        )
        done += cur
    return sum(imgs) / spp

"""Sharded rendering strategies over a device mesh.

Two data-parallel decompositions (SURVEY.md section 5.8 green-field design):
  * tile-sharded  — pixels split across devices; film shards concatenate with
    no cross-device traffic (the common forward-render mode).
  * spp-sharded   — every device renders all pixels at a sample-index subset;
    film accumulators reduce with an explicit psum over the mesh (the mode
    whose reduction overlaps gradient all-reduce in training, and the
    checkpoint/resume boundary: each wave is a film delta).

Both are bitwise deterministic: sample values derive from (pixel, sample,
dim) hashes, so the result is independent of the device layout, and the film
reduction order is fixed by the mesh axis order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..films.rgb import spectrum_to_rgb
from ..render import camera_rays_full


# Pixels per device per dispatch. Fixed, whatever the mesh size: every tile
# runs the same per-device program, and the compiled program may round
# differently at another batch shape, so a tile size that followed the
# device count would give an image that depends on the device layout.
TILE_PIXELS = 16384


def render_tile_sharded(scene, camera, integrator, mesh: Mesh, spp: int = 4,
                        seed: int = 0):
    """Pixels sharded over mesh axis 'data'. Returns (ny, nx, 3) image.

    The image is cut into tiles of TILE_PIXELS (or the whole image, if it is
    smaller), and each dispatch hands one tile to every device of the mesh.
    Each device traces its tile under shard_map: the traversal kernels
    (opaque custom calls to the partitioner) run on local rays and no data
    crosses devices. The pixel range is padded to whole dispatches with
    copies of the last pixel, whose results are dropped, so a tile holds the
    same pixels on one device or many and the image is bitwise the same."""
    from jax import shard_map

    nx, ny = camera.resolution
    npix = nx * ny
    n_dev = mesh.devices.size
    tile = min(TILE_PIXELS, npix)
    per_dispatch = tile * n_dev
    n_dispatch = -(-npix // per_dispatch)

    scene = jax.device_put(scene, NamedSharding(mesh, P()))

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(), P("data")),
        out_specs=P("data"), check_vma=False,
    )
    def run(scene, pixel):
        acc = jnp.zeros((pixel.shape[0], 3), jnp.float32)

        def body(s, acc):
            o, d, wl, w = camera_rays_full(
                camera, pixel, s, jnp.int32(seed)
            )
            L = integrator.trace(scene, o, d, wl, pixel, s, jnp.int32(seed))
            return acc + spectrum_to_rgb(L, wl) * w[:, None]

        acc = jax.lax.fori_loop(0, spp, body, acc)
        return acc / spp

    run = jax.jit(run)
    sharding = NamedSharding(mesh, P("data"))
    parts = []
    for k in range(n_dispatch):
        pixel = jnp.minimum(
            jnp.arange(k * per_dispatch, (k + 1) * per_dispatch,
                       dtype=jnp.int32), npix - 1)
        parts.append(run(scene, jax.device_put(pixel, sharding)))
    img = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    return img[:npix].reshape(ny, nx, 3)


def render_spp_sharded(scene, camera, integrator, mesh: Mesh, spp: int = 8,
                       seed: int = 0):
    """Sample indices sharded; film reduced with an explicit psum."""
    from jax import shard_map

    nx, ny = camera.resolution
    npix = nx * ny
    n_dev = mesh.devices.size
    assert spp % n_dev == 0
    per_dev = spp // n_dev

    samples = jnp.arange(spp, dtype=jnp.int32)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P("data")),
        out_specs=P(),
        # The integrator's scan carries start as replicated constants and
        # become device-varying through the loop; skip the static vma check.
        check_vma=False,
    )
    def run(scene, my_samples):
        pixel = jnp.arange(npix, dtype=jnp.int32)
        acc = jnp.zeros((npix, 3), jnp.float32)

        def body(i, acc):
            s = my_samples[i]
            o, d, wl, w = camera_rays_full(
                camera, pixel, s, jnp.int32(seed)
            )
            L = integrator.trace(scene, o, d, wl, pixel, s, jnp.int32(seed))
            return acc + spectrum_to_rgb(L, wl) * w[:, None]

        acc = jax.lax.fori_loop(0, per_dev, body, acc)
        # Film reduction across the mesh (the psum that overlaps the
        # backward gradient all-reduce in training).
        return jax.lax.psum(acc, "data")

    img = jax.jit(run)(scene, samples)
    return (img / spp).reshape(ny, nx, 3)

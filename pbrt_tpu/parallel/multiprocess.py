"""Multi-process (multi-host) rendering and training over jax.distributed.

The reference has no distributed backend (SURVEY.md section 5.8 green-field
design); this module is the pbrt_tpu answer to the 1 -> 4 host scaling north
star (BASELINE.md). One process per host calls `init_multiprocess`, after
which `jax.devices()` spans every host's chips and the same mesh/sharding
code used single-process (parallel/mesh.py, parallel/render.py) runs
globally: pixels shard across hosts, the film psum and the gradient psum
ride the collectives XLA inserts.

Without a multi-host cluster this is validated exactly as SURVEY.md section 4
prescribes: spawn N local processes with CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=K``) and a local
coordinator (tests/test_multiprocess.py + parallel/mp_worker.py). The film
is bitwise identical across process counts because sample values derive
from (pixel, sample, dim) hashes and the film reduction order is fixed by
the mesh axis order, not the process layout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_multiprocess(coordinator_address: str, num_processes: int,
                      process_id: int) -> None:
    """Join the jax.distributed cluster (one call per process, pre-backend).

    On a real pod slice each host passes its rank; in the CPU simulation the
    test harness passes a localhost coordinator. Must run before any JAX
    backend initialization.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "data") -> Mesh:
    """Mesh over ALL processes' devices (host-major order)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def _replicated(tree, mesh: Mesh):
    """Build globally-replicated arrays from process-local (identical) data."""
    sharding = NamedSharding(mesh, P())

    def leaf(x):
        if not hasattr(x, "shape"):
            return x
        arr = np.asarray(x)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    return jax.tree_util.tree_map(leaf, tree)


def _sharded_arange(n: int, mesh: Mesh, axis: str):
    """Global arange(n) sharded over the mesh axis."""
    full = np.arange(n, dtype=np.int32)
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_callback(
        (n,), sharding, lambda idx: full[idx]
    )


def render_multiprocess(scene, camera, integrator, mesh: Mesh | None = None,
                        spp: int = 4, seed: int = 0) -> np.ndarray:
    """Pixel-sharded render over the global (multi-process) mesh.

    Returns the full (ny, nx, 3) image as numpy ON EVERY PROCESS (an
    all-gather of film shards — the multi-host film merge).
    """
    from jax.experimental import multihost_utils

    from ..films.rgb import spectrum_to_rgb
    from ..render import camera_rays_full

    if mesh is None:
        mesh = global_mesh()
    nx, ny = camera.resolution
    npix = nx * ny
    n_dev = mesh.devices.size
    assert npix % n_dev == 0, (npix, n_dev)

    pixel = _sharded_arange(npix, mesh, "data")
    scene_g = _replicated(scene, mesh)

    @jax.jit
    def run(scene, pixel):
        acc = jnp.zeros((pixel.shape[0], 3), jnp.float32)

        def body(s, acc):
            o, d, wl, w = camera_rays_full(camera, pixel, s, jnp.int32(seed))
            L = integrator.trace(scene, o, d, wl, pixel, s, jnp.int32(seed))
            return acc + spectrum_to_rgb(L, wl) * w[:, None]

        return jax.lax.fori_loop(0, spp, body, acc) / spp

    img = run(scene_g, pixel)
    full = multihost_utils.process_allgather(img, tiled=True)
    return np.asarray(full).reshape(ny, nx, 3)


def train_step_multiprocess(scene, camera, integrator, target_rgb,
                            mesh: Mesh | None = None, spp: int = 1,
                            seed: int = 0):
    """One pixel-sharded loss+grad step over the global mesh.

    Gradients for the replicated parameters (albedo coefficients, light
    emission scale) reduce across every host's shard — XLA inserts the
    cross-process psum. Returns (loss, grads) replicated on all processes
    as numpy.
    """
    from ..films.rgb import spectrum_to_rgb
    from ..render import camera_rays_full

    if mesh is None:
        mesh = global_mesh()
    nx, ny = camera.resolution
    npix = nx * ny
    assert npix % mesh.devices.size == 0

    pixel = _sharded_arange(npix, mesh, "data")
    scene_g = _replicated(scene, mesh)
    target = np.asarray(target_rgb, np.float32).reshape(npix, 3)
    sharding = NamedSharding(mesh, P("data"))
    target_g = jax.make_array_from_callback(
        (npix, 3), sharding, lambda idx: target[idx]
    )

    # Pin replicated outputs: loss and the parameter grads psum across the
    # mesh, so every process holds the full value in its local shard — no
    # host-side allgather needed afterwards.
    @functools.partial(
        jax.jit, out_shardings=NamedSharding(mesh, P()))
    def step(scene, pixel, target):
        def loss_fn(albedo_coeffs, area_scale):
            s = scene.replace(
                materials=scene.materials.replace(albedo_coeffs=albedo_coeffs),
                lights=scene.lights.replace(area_scale=area_scale),
            )
            acc = jnp.zeros((pixel.shape[0], 3), jnp.float32)

            def body(si, acc):
                o, d, wl, w = camera_rays_full(
                    camera, pixel, si, jnp.int32(seed))
                L = integrator.trace(s, o, d, wl, pixel, si, jnp.int32(seed))
                return acc + spectrum_to_rgb(L, wl) * w[:, None]

            rgb = jax.lax.fori_loop(0, spp, body, acc) / spp
            # Mean over the GLOBAL pixel set: the factor npix is global, so
            # the grad psum across processes is exactly the multi-host
            # gradient all-reduce.
            return jnp.sum((rgb - target) ** 2) / (npix * 3)

        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            scene.materials.albedo_coeffs, scene.lights.area_scale
        )
        return loss, grads

    loss, grads = step(scene_g, pixel, target_g)

    def local(x):
        # Replicated global array: the process-local shard IS the full value.
        return np.asarray(x.addressable_shards[0].data)

    return float(local(loss)), {
        "albedo_coeffs": local(grads[0]),
        "area_scale": local(grads[1]),
    }

"""Differentiable rendering: sharded forward + gradient all-reduce.

The inverse-rendering "training step" of BASELINE.json: render a pixel-sharded
image batch, compare against a target, and reverse-mode differentiate the loss
with respect to continuous scene parameters (albedo sigmoid coefficients,
light emission scales). Pixels are sharded over the mesh's data axis under
shard_map and scene parameters are replicated; the loss and the parameter
gradients are averaged across devices with pmean.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..cameras.perspective import PerspectiveCamera
from ..films.rgb import spectrum_to_rgb
from ..models.path import PathIntegrator
from ..render import camera_rays
from ..scene import Scene


def _render_pixels(scene: Scene, camera, integrator, pixel, sample_idx, seed):
    o, d, wl = camera_rays(camera, pixel, sample_idx, seed)
    radiance = integrator.trace(scene, o, d, wl, pixel, sample_idx, seed)
    return spectrum_to_rgb(radiance, wl)  # (N, 3)


DEFAULT_TRAINABLE = ("materials.albedo_coeffs", "lights.area_scale")


def _get_path(scene, path):
    obj = scene
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _set_paths(scene, updates):
    """Return scene with dotted-path leaves replaced (depth-2 paths)."""
    by_child = {}
    for path, value in updates.items():
        child, leaf = path.split(".", 1)
        by_child.setdefault(child, {})[leaf] = value
    reps = {}
    for child, leaves in by_child.items():
        reps[child] = getattr(scene, child).replace(**leaves)
    return scene.replace(**reps)


def render_loss_and_grad(
    scene: Scene,
    camera: PerspectiveCamera,
    integrator: PathIntegrator,
    pixel,
    target_rgb,
    sample_idx,
    seed,
    trainable=DEFAULT_TRAINABLE,
):
    """L2 image loss + gradients wrt an arbitrary trainable-leaf set.

    trainable: tuple of dotted scene paths ("materials.albedo_coeffs",
    "materials.roughness", "lights.area_scale", "textures.img_flat",
    "medium.sigma_a_scale", ...). Differentiates through shading and
    emission; geometry/discrete events are detached (SURVEY.md section 7
    design stance). Returns (loss, {path: grad}).
    """
    params = {p: _get_path(scene, p) for p in trainable}

    def loss_fn(params):
        s = _set_paths(scene, params)
        rgb = _render_pixels(s, camera, integrator, pixel, sample_idx, seed)
        return jnp.mean((rgb - target_rgb) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return loss, grads


def training_step(
    mesh,
    scene: Scene,
    camera: PerspectiveCamera,
    integrator: PathIntegrator,
    pixel,
    target_rgb,
    sample_idx=0,
    seed=0,
    lr: float = 1e-2,
    trainable=DEFAULT_TRAINABLE,
):
    """One sharded SGD step on scene parameters. Returns (loss, new_scene).

    pixel/target_rgb are sharded over the mesh's data axis; scene is
    replicated. Each device differentiates the mean loss of its own pixels
    (shard_map: the traversal kernels run on local rays), and pmean over
    the mesh gives the global mean loss and gradient, since shards are
    equal. `trainable` selects the updated leaves (dotted scene paths, see
    render_loss_and_grad).
    """
    from jax import shard_map

    data_sharding = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P("data"), P("data"), P(), P()),
        out_specs=(P(), P()), check_vma=False,
    )
    def local_loss_and_grad(scene, camera, integrator, pixel, target_rgb,
                            sample_idx, seed):
        loss, grads = render_loss_and_grad(
            scene, camera, integrator, pixel, target_rgb, sample_idx, seed,
            trainable=trainable,
        )
        return jax.lax.pmean((loss, grads), "data")

    @functools.partial(jax.jit, out_shardings=(repl, repl))
    def step(scene, camera, integrator, pixel, target_rgb, sample_idx, seed):
        loss, grads = local_loss_and_grad(
            scene, camera, integrator, pixel, target_rgb, sample_idx, seed
        )
        new_scene = _set_paths(
            scene,
            {
                p: _get_path(scene, p) - lr * grads[p]
                for p in trainable
            },
        )
        return loss, new_scene

    pixel = jax.device_put(pixel, data_sharding)
    target_rgb = jax.device_put(target_rgb, data_sharding)
    scene = jax.device_put(scene, repl)
    return step(
        scene, camera, integrator, pixel, target_rgb,
        jnp.asarray(sample_idx, jnp.int32), jnp.asarray(seed, jnp.int32),
    )

"""Scene container: the device-resident, fully-traceable scene description.

Reference analogue: BasicScene after CreateMaterials/CreateLights/
CreateAggregate (/root/reference/src/pbrt/scene.h:260-380) — but as one jax
pytree of flat arrays, so an entire scene is an argument to a jitted render
function and every continuous parameter (albedo, emission, vertex positions)
is differentiable.
"""

from __future__ import annotations

from typing import Optional

from .core.pytree import pytree
from .lights.buffers import LightBuffers
from .materials.buffers import MaterialBuffers
from .media.medium import MediumBuffers
from .shapes.geometry import GeometryBuffers


@pytree
class Scene:
    geom: GeometryBuffers
    materials: MaterialBuffers
    lights: LightBuffers
    # Scene-level participating medium (None == vacuum everywhere).
    medium: Optional[MediumBuffers] = None
    # Shape-bounded interior media (media.MediumStack); rays switch via
    # per-material med_inside/med_outside on transmission (the per-shape
    # MediumInterface tier; media.h:55-80).
    media_stack: Optional[object] = None
    # Optional texture tables (textures.TextureBuffers).
    textures: Optional[object] = None
    # At most one triangle accelerator (accel/api.py dispatch); with none,
    # triangles go to the dense tester (accel/dense.py).
    # Optional triangle BVH (accel.bvh.BVH), jnp per-ray-stack traversal.
    bvh: Optional[object] = None
    # Optional Pallas brute-force small-scene intersector
    # (ops.smallscene.SmallTriAccel) — used up to the size threshold.
    small: Optional[object] = None
    # Optional SAH kd-tree (accel.kdtree.KdTree) — pbrt's alternate
    # aggregate (KdTreeAggregate), kept for parity.
    kdtree: Optional[object] = None
    # Optional candidate-sweep accelerator (ops.sweep.SweepAccel) —
    # XLA-side per-tile candidate culling + t-ordered Pallas sweep; the
    # only accelerator supporting object instancing.
    sweep: Optional[object] = None
    # Animated instances (accel.instances.AnimatedInstances): TRS-
    # keyframed TransformedPrimitives handled in a separate per-instance
    # pass (accel/api.py). None = no motion-blurred instances.
    anim: Optional[object] = None

    def with_accel(self, threshold: int = 512) -> "Scene":
        """Attach the triangle intersector fitting the scene size.

        Up to `threshold` triangles the brute-force kernel
        (ops/smallscene.py), above it the candidate-sweep kernel
        (ops/sweep.py); threshold=0 attaches the sweep kernel whatever the
        size. The default is the crossover on render passes on an H100
        (tools/profile_accel.py --part crossover): brute force is faster at
        512 triangles, the sweep kernel from 768 up.
        """
        import numpy as np

        if self.geom.num_triangles == 0:
            return self
        if self.geom.num_triangles <= threshold:
            from .ops.smallscene import build_smallscene

            return self.replace(
                small=build_smallscene(
                    np.asarray(self.geom.tri_verts),
                    np.asarray(self.geom.tri_mat),
                    np.asarray(self.geom.tri_light),
                )
            )
        from .ops.sweep import build_sweep

        return self.replace(
            sweep=build_sweep(np.asarray(self.geom.tri_verts))
        )

    def with_kdtree(self, max_prims: int = 4) -> "Scene":
        """Attach the SAH kd-tree aggregate (KdTreeAggregate analogue)."""
        import numpy as np

        from .accel.kdtree import build_kdtree

        if self.geom.num_triangles == 0:
            return self
        return self.replace(
            kdtree=build_kdtree(
                np.asarray(self.geom.tri_verts), max_prims=max_prims
            )
        )

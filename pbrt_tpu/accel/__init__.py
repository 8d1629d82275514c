"""Ray-scene acceleration.

Reference analogue: /root/reference/src/pbrt/cpu/aggregates.h/.cpp (BVH +
kd-tree) and the OptiX GAS/IAS path (gpu/aggregate.*). Tiers:
  * dense:  brute-force all-primitives tests, blocked with lax.scan; the
    reference oracle every other tier is tested against.
  * ops/smallscene.py, ops/sweep.py: the Pallas kernels the GPU runs
    (dispatch in api.py).
  * bvh / kdtree: host-built flattened trees with vectorized stack
    traversal.
"""

from .dense import intersect_closest, intersect_any  # noqa: F401

"""Geometric primitives: batched intersection and area sampling.

Reference analogue: /root/reference/src/pbrt/shapes.h/.cpp (3,110 LoC) and the
Shape interface (base/shape.h:32). Design: shapes live in flat arrays
(all triangles in one (T,3,3) tensor, all spheres in one (S,4) tensor); a
ray-vs-shape test is a broadcasted jnp expression over (rays x shapes) blocks
rather than a per-object virtual call.
"""

from .geometry import GeometryBuffers, Interaction, make_quad, make_box  # noqa: F401

"""Materials and BxDFs.

Reference analogue: /root/reference/src/pbrt/materials.h (12 materials),
bxdfs.h (11 BxDFs), base/material.h:36. Design: material parameters live
in flat per-material arrays (MaterialBuffers); BxDF evaluation is branchless —
each BxDF family evaluates for all rays and a tag mask selects, replacing the
reference's TaggedPointer::Dispatch (util/taggedptr.h:22-60).
"""

from .buffers import (  # noqa: F401
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_DIFFUSE,
    MAT_THINDIELECTRIC,
    MaterialBuffers,
)
from . import bxdf, scattering  # noqa: F401

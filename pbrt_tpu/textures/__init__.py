"""Textures: spatially varying material parameters.

Reference analogue: /root/reference/src/pbrt/textures.h/.cpp (28 variants over
FloatTexture/SpectrumTexture, base/texture.h:27,72). Design: texture
evaluation is a branchless pass over the shading batch keyed by per-material
texture ids; image texels carry pre-fitted sigmoid spectra so a lookup is a
(coeffs, scale) fetch, not an RGB conversion.
"""

from .buffers import TEX_CHECKER, TEX_IMAGE, TEX_MARBLE, TextureBuffers, evaluate_albedo_coeffs  # noqa: F401

"""Samplers: per-(pixel, sample, dimension) point generation.

Reference analogue: the 9 sampler variants of
/root/reference/src/pbrt/samplers.h (base/sampler.h:39). As SURVEY.md section
2.2 notes, every pbrt QMC sampler except MLT is a pure function of
(pixel, sampleIndex, dimension, seed) — exactly the stateless signature a
batched renderer wants. No dimension counter state exists here: integrator call sites pass
explicit dimension indices.
"""

from .samplers import Sampler  # noqa: F401

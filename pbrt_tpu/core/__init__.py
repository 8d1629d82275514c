"""Foundation layer: math, spectra, color, sampling, RNG, transforms.

Counterpart of the reference's src/pbrt/util/ (SURVEY.md section 2.1).
Everything here is pure jax.numpy on batched arrays; no Python-level loops over
rays or wavelengths.
"""

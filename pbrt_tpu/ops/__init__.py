"""Pallas kernels (Triton on the GPU) for the renderer's hot paths."""

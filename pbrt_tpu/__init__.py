"""pbrt_tpu — a differentiable spectral path tracer in JAX.

A from-scratch JAX/XLA/Pallas renderer with the capabilities of
scienstanford/pbrt-v4 (the ISET fork of pbrt-v4): hero-wavelength spectral
Monte Carlo rendering, wavefront execution over sharded device meshes, and
reverse-mode differentiability of scene parameters.

Design stance (vs the C++/CUDA reference):
  * tagged-pointer dispatch      -> masked branchless kernels / tag-sorted queues
  * pointer BVH + stack traversal-> flattened int32 BVH tensors, vectorized traversal
  * recursion over bounces       -> lax.scan with fixed-size carried ray state
  * pstd::optional               -> validity masks
  * CUDA unified memory / NCCL   -> jax.sharding Mesh + XLA collectives (psum)

Subpackage map (mirrors SURVEY.md section 2 of the reference analysis):
  core/      foundation: spectra, color, sampling, RNG, transforms  (ref: src/pbrt/util/)
  shapes/    geometric primitives + area sampling                   (ref: src/pbrt/shapes.*)
  accel/     BVH build (host) + traversal (device)                  (ref: src/pbrt/cpu/aggregates.*)
  cameras/   camera models                                          (ref: src/pbrt/cameras.*)
  films/     film + pixel sensor + AOVs                             (ref: src/pbrt/film.*)
  filters/   reconstruction filters                                 (ref: src/pbrt/filters.*)
  lights/    light variants + many-light samplers                   (ref: src/pbrt/lights.*, lightsamplers.*)
  samplers/  QMC / independent samplers                             (ref: src/pbrt/samplers.*)
  materials/ materials + BxDFs                                      (ref: src/pbrt/materials.*, bxdfs.*)
  textures/  texture evaluation                                     (ref: src/pbrt/textures.*)
  media/     participating media + majorant iteration               (ref: src/pbrt/media.*)
  models/    integrators (the renderer's "model families")          (ref: src/pbrt/cpu/integrators.*, wavefront/)
  ops/       Pallas kernels (Triton on the GPU) for the hot paths
  parallel/  mesh/sharding policy, film reduction, multi-host       (green-field; ref has none)
  io/        .pbrt scene parsing, image I/O (EXR/PFM/PNG)           (ref: src/pbrt/parser.*, util/image.*)
  utils/     logging, stats, progress
"""

__version__ = "0.1.0"

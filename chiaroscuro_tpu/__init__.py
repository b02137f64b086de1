"""chiaroscuro_tpu — a differentiable Monte-Carlo path tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the reference
CPU path tracer (Domingo1337/Chiaroscuro-RayTracer): .rtc scene configs, OBJ/MTL
ingest, kd-tree/BVH-accelerated ray casting, next-event estimation, cosine-weighted
diffuse BRDF sampling with Russian-roulette termination, progressive accumulation,
exrdisplay-style tone mapping, and EXR/HDR/PNG export — re-designed for an
accelerator:

- wavefront path tracing (``lax.scan`` over bounce depth, active-ray masks)
  instead of per-pixel recursion (reference ``src/rayTracer.cpp:76-135``)
- SoA scene arrays as a differentiable pytree instead of heap-allocated BRDF
  objects (reference ``src/rayTracer.cpp:159-166``)
- counter-based ``jax.random`` sampling keyed on global (pixel, sample, bounce)
  so renders are bitwise invariant to sharding (reference used per-OpenMP-thread
  mutable RNG streams)
- screen-tile sharding over a ``jax.sharding.Mesh`` via ``shard_map`` instead of
  ``#pragma omp parallel for`` over rows (reference ``src/rayTracer.cpp:55``)
- a Pallas (Triton) kernel for the hot ray-triangle intersection loop
  instead of recursive C++ kd-tree traversal (reference
  ``src/kdtree.cpp:210-344``)

Package layout:
  scene/     .rtc config, OBJ/MTL/texture ingest, SceneArrays pytree   (ref L0/L1)
  sampling/  counter-based PRNG streams + importance samplers          (ref C12/C6)
  geometry/  camera ray generation, Moller-Trumbore intersection        (ref C5/C7)
  accel/     BVH build (host) + traversal (device)                      (ref C5)
  ops/       Pallas GPU kernel for intersection                         (ref C5 hot loops)
  render/    wavefront integrator, tone map, image I/O, renderer API    (ref C7)
  parallel/  device-mesh sharding, multi-host collectives               (ref OpenMP row loop)
  utils/     timing, checkpointing of accumulation state
  preview/   progressive viewer analog of the OpenGL preview            (ref C9)
"""

__version__ = "0.1.0"

from chiaroscuro_tpu.scene.config import RenderConfig  # noqa: F401
from chiaroscuro_tpu.scene.scene_arrays import SceneArrays  # noqa: F401

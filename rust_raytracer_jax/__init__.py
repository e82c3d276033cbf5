"""rust_raytracer_jax — a differentiable path tracing framework in JAX.

A JAX/XLA/Pallas design with the full capability surface of the reference
CPU ray tracer (teofum/rust_raytracer): stratified sampling, BVH-
accelerated meshes, lambertian/metal/dielectric/glossy/emissive/isotropic
materials, NEE light-biased scatter PDFs, procedural + image textures with
normal maps, constant-density volumes, ACES tonemapping, a scene DSL, and
multi-device rendering via jax.sharding.

Layer map:
  core/      batched vector math, counter-based RNG, AABB slabs
  ops/       device kernels: intersection, BVH traversal, shading, textures,
             light PDFs, tonemapping
  scene/     host-side scene graph + compiler -> flat SoA device arrays,
             OBJ loader, scene DSL, BVH builder
  render/    camera, wavefront integrator, film/output
  parallel/  device mesh + shard_map sample/tile sharding
  models/    built-in scene registry (golden_monkey, cornell, ...)
  utils/     config merge + CLI, logging, profiling, checkpointing
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax


def compilation_cache_dir() -> str:
    """Where XLA's persistent compilation cache lives: the directory named by
    JAX_COMPILATION_CACHE_DIR if that is set, else `<checkout>/.jax_cache`.
    A fixed path: the cache key includes it, so a moving path never hits."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


# Integrator graphs are large, so cross-process cache hits matter.
_jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

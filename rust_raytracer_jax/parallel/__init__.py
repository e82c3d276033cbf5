# Submodules imported directly (rust_raytracer_jax.parallel.mesh, ...).

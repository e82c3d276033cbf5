# Submodules imported directly (rust_raytracer_jax.utils.assets, ...).

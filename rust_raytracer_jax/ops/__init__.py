# Submodules are imported directly (rust_raytracer_jax.ops.intersect, ...);
# kept lazy here to avoid ops <-> scene import cycles.

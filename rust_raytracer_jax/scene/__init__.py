# Submodules are imported directly (rust_raytracer_jax.scene.compiler, ...);
# kept lazy here to avoid ops <-> scene import cycles.

"""Subprocess body for tests/test_grad.py: float64 finite-difference vs
jax.grad of pixel radiance w.r.t. scene parameters.  Runs in its own
process so x64 mode never leaks into the f32 test suite.

Prints one JSON line: [{"name":..., "analytic":..., "fd":...}, ...].
"""
import dataclasses
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)
jax.config.update(
    "jax_compilation_cache_dir",
    os.path.join(os.path.dirname(__file__), os.pardir, ".jax_cache"),
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from rust_raytracer_jax.core import rng as vrng  # noqa: E402
from rust_raytracer_jax.render import integrator  # noqa: E402
from rust_raytracer_jax.render.camera import Camera  # noqa: E402
from rust_raytracer_jax.scene import compiler as sc  # noqa: E402
from rust_raytracer_jax.scene import graph as g  # noqa: E402

DEPTH = 3
N = 256  # 16x16 pixels x 1 spp


def main():
    # diffuse ball on a diffuse floor lit by an emissive quad + dim sky:
    # exercises NEE (plane light), cosine scattering, and background.
    light = g.Plane((0, 2.0, 0), (0.8, 0, 0), (0, 0, 0.8),
                    g.Emissive(g.Constant((6.0, 6.0, 6.0))))
    floor = g.Plane((0, -0.4, 0), (-4, 0, 0), (0, 0, 4),
                    g.Lambertian(g.Constant((0.6, 0.6, 0.6))))
    ball = g.Sphere((0, 0, 0), 0.35, g.Lambertian(g.Constant((0.7, 0.2, 0.2))))
    sky = g.Sky(g.Constant((0.1, 0.1, 0.1)))
    scene = g.SceneDef(world=g.Group([ball, floor, light, sky]),
                       lights=[light, sky], config={})
    pack, static = sc.compile_scene(scene, dtype=jnp.float64)

    cam = Camera(image_width=16, aspect_ratio=1.0, samples_per_pixel=1,
                 max_depth=DEPTH, position=(0, 0.3, 1.6), look_at=(0, 0, 0),
                 focal_length=35.0)
    w = cam.image_width
    px = jnp.asarray(np.arange(N) % w, jnp.uint32)
    py = jnp.asarray((np.arange(N) // w) % cam.image_height, jnp.uint32)
    sample = jnp.zeros((N,), jnp.uint32)
    seed = jnp.uint32(7)
    wgt = jnp.cos(jnp.arange(N * 3, dtype=jnp.float64)).reshape(N, 3)

    @jax.jit
    def loss(pack):
        ctx = vrng.Ctx(pixel=py * np.uint32(w) + px, sample=sample,
                       bounce=jnp.uint32(0), seed=seed)
        org, dirn = cam.generate_rays(px, py, sample, ctx, jnp.float64)
        rad = integrator.trace(pack, static, org, dirn, ctx, DEPTH, 0.25,
                               differentiable=True)
        # weighted sum (not plain mean) so gradients mix channels/pixels
        return jnp.sum(rad * wgt)

    # allow_int: integer ScenePack leaves (material ids, BVH links) are
    # structure, not parameters — their float0 grads are never read below
    grad = jax.jit(jax.grad(loss, allow_int=True))(pack)
    results = []

    def fd_field(name, field, idx, eps=1e-6):
        an = float(np.asarray(getattr(grad, field))[idx])

        def at(delta):
            arr = np.asarray(getattr(pack, field)).copy()
            arr[idx] += delta
            return float(loss(dataclasses.replace(
                pack, **{field: jnp.asarray(arr)})))

        fd = (at(+eps) - at(-eps)) / (2 * eps)
        results.append({"name": name, "analytic": an, "fd": fd})

    for ax, nm in enumerate("xyz"):
        fd_field(f"sph_center.{nm}", "sph_center", (0, ax))
    fd_field("sph_radius", "sph_radius", (0,))
    corners = np.asarray(pack.pln_corner)
    floor_i = int(np.argmin(corners[:, 1]))
    fd_field("pln_corner.y(floor)", "pln_corner", (floor_i, 1))
    fd_field("background.g", "background", (1,))

    # albedo + emission constants live in the dynamic tex_const table
    # (CONSTANT texture node values): probe the 4 most grad-sensitive
    # entries (covers at least one albedo and one emission constant)
    carr = np.asarray(pack.tex_const)
    cgrad = np.asarray(grad.tex_const)
    for fi in np.argsort(-np.abs(cgrad).ravel())[:4]:
        idx = np.unravel_index(int(fi), carr.shape)
        an = float(cgrad[idx])
        if abs(an) < 1e-6:
            continue
        fd_field(f"tex_const[{idx[0]},{idx[1]}]", "tex_const", idx)

    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())

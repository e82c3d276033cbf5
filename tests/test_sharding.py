"""Sharding correctness: 1-device and 8-device renders are BIT-IDENTICAL.

The counter-based RNG (core/rng.py keys on (pixel, sample, bounce)) makes
every lane's radiance independent of where it executes, so sharding the
(pixel, sample) grid over any mesh must reproduce the single-device image
exactly — the property the reference's thread_rng seeding lacks
(camera.rs:189-256 gives each thread an unseeded generator).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rust_raytracer_jax import models
from rust_raytracer_jax.render.camera import Camera
from rust_raytracer_jax.render.renderer import Renderer
from rust_raytracer_jax.parallel import mesh as pmesh

BATCH = 64 * 42 * 4


def _render(mesh):
    scene = models.build("test")
    cam = Camera(
        image_width=64, aspect_ratio=1.5, samples_per_pixel=4, max_depth=4,
        position=(0, 0, 1), look_at=(0, 0, 0), focal_length=50.0,
    )
    r = Renderer(scene, cam, batch_size=BATCH, mesh=mesh)
    return r.render_batched().hdr()


def test_render_1_vs_8_devices_bit_identical():
    assert len(jax.devices()) >= 8, "conftest forces an 8-device CPU mesh"
    img1 = _render(pmesh.make_mesh(1))
    img8 = _render(pmesh.make_mesh(8))
    np.testing.assert_array_equal(img1, img8)


def test_render_unsharded_vs_8_devices_bit_identical():
    img0 = _render(None)
    img8 = _render(pmesh.make_mesh(8))
    np.testing.assert_array_equal(img0, img8)


def test_pool_render_1_vs_8_devices():
    """The production pool renderer sharded over 8 devices reproduces the
    single-device image.  Per-job radiance is bit-identical (counter-based
    RNG); only the per-pixel fp summation order differs across meshes, so
    the comparison is allclose at f32 tolerance, and the issued-job count
    must match exactly."""
    from rust_raytracer_jax.render import pool as poolmod
    from rust_raytracer_jax.scene import compiler as sc

    scene = models.build("test")
    cam = Camera(
        image_width=32, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        position=(0, 0, 1), look_at=(0, 0, 0), focal_length=50.0,
    )
    pack, static = sc.compile_scene(scene)
    n_pixels = cam.image_width * cam.image_height
    spp = 4
    imgs = []
    for mesh in (None, pmesh.make_mesh(8)):
        accum = poolmod.render_pool(
            pack, static, cam, n_pixels, spp, n_lanes=1024, seed=3,
            mesh=mesh, kernel="jnp",
        )
        imgs.append(np.asarray(accum))
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=2e-5, atol=1e-6)


def test_train_step_loss_and_grads_match_across_meshes():
    """Sharded psum-reduced loss/grads == single-device loss/grads."""
    scene = models.build("test")
    cam = Camera(
        image_width=32, aspect_ratio=1.0, samples_per_pixel=1, max_depth=3,
        position=(0, 0, 1), look_at=(0, 0, 0), focal_length=50.0,
    )
    from rust_raytracer_jax.core import rng as vrng
    from rust_raytracer_jax.render import integrator
    from rust_raytracer_jax.scene import compiler as sc

    pack, static = sc.compile_scene(scene)
    w = cam.image_width
    n = 256

    def batch_fn(p, px, py, sample, seed):
        ctx = vrng.Ctx(
            pixel=py * np.uint32(w) + px, sample=sample,
            bounce=jnp.uint32(0), seed=seed,
        )
        org, dirn = cam.generate_rays(px, py, sample, ctx, jnp.float32)
        return integrator.trace(p, static, org, dirn, ctx, 3, 0.25,
                                differentiable=True)

    def loss_of_radiance(rad, target):
        return jnp.mean((rad - target) ** 2)

    px = jnp.asarray(np.arange(n) % w, jnp.uint32)
    py = jnp.asarray((np.arange(n) // w) % 32, jnp.uint32)
    sample = jnp.zeros((n,), jnp.uint32)
    seed = jnp.uint32(0)
    target = jnp.zeros((n, 3), jnp.float32)

    results = []
    for nd in (1, 8):
        step = pmesh.train_step_fn(batch_fn, loss_of_radiance,
                                   pmesh.make_mesh(nd))
        loss, grads = step(pack, px, py, sample, seed, target)
        results.append((np.asarray(loss),
                        [np.asarray(g) for g in grads]))
    (l1, g1), (l8, g8) = results
    # psum of per-shard means: each shard's mean is over n/nd lanes, so
    # the 8-way psum is 8x the global mean — normalize before comparing.
    np.testing.assert_allclose(l8 / 8.0, l1, rtol=1e-6)
    assert len(g1) == len(g8) and len(g1) > 0
    for a, b in zip(g1, g8):
        np.testing.assert_allclose(b / 8.0, a, rtol=1e-5, atol=1e-7)


def test_make_mesh_raises_when_devices_are_too_few():
    """A mesh never moves to another platform behind the caller: asking
    for more devices than the default backend has raises."""
    n = len(jax.devices())
    assert pmesh.make_mesh(n).devices.size == n
    with pytest.raises(ValueError, match="devices"):
        pmesh.make_mesh(n + 1)

"""Checkpoint/resume: a render interrupted at an arbitrary step and resumed
from disk produces a BIT-IDENTICAL image to an uninterrupted run."""
import numpy as np
import jax.numpy as jnp
import pytest

from rust_raytracer_jax import models
from rust_raytracer_jax.render import checkpoint as ckpt
from rust_raytracer_jax.render import pool as poolmod
from rust_raytracer_jax.render.camera import Camera
from rust_raytracer_jax.scene import compiler as sc

SPP = 4
LANES = 1024


@pytest.fixture(scope="module")
def setup():
    scene = models.build("test")
    cam = Camera(image_width=32, aspect_ratio=1.0, samples_per_pixel=SPP,
                 max_depth=4, position=(0, 0, 1), look_at=(0, 0, 0),
                 focal_length=50.0)
    pack, static = sc.compile_scene(scene)
    return pack, static, cam


def test_resume_bit_identical(setup, tmp_path):
    pack, static, cam = setup
    n_pixels = cam.image_width * cam.image_height

    straight = np.asarray(poolmod.render_pool(
        pack, static, cam, n_pixels, SPP, LANES, seed=3))

    path = str(tmp_path / "ck.npz")
    # run A: poll every 3 steps, checkpoint every poll, kill after 2 polls
    total = n_pixels * SPP
    state = poolmod.init_state(LANES, n_pixels)
    step = poolmod.make_step(pack, static, cam, total, SPP, 3)
    for _ in range(6):
        state = step(pack, state)
    ckpt.save_pool_state(path, state, {"step_count": 6})
    del state  # "crash"

    resumed = np.asarray(ckpt.render_pool_resumable(
        pack, static, cam, n_pixels, SPP, LANES, seed=3,
        steps_per_poll=3, checkpoint_path=path, checkpoint_every_steps=6))

    np.testing.assert_array_equal(straight, resumed)


def test_save_load_roundtrip(setup, tmp_path):
    pack, static, cam = setup
    state = poolmod.init_state(LANES, cam.image_width * cam.image_height)
    step = poolmod.make_step(
        pack, static, cam, LANES * 4, SPP, 0)
    state = step(pack, state)
    path = str(tmp_path / "rt.npz")
    ckpt.save_pool_state(path, state, {"step_count": 1})
    loaded, meta = ckpt.load_pool_state(path)
    assert int(meta["step_count"]) == 1
    for f in ("org", "dirn", "throughput", "radiance", "pixel", "sample",
              "bounce", "active", "accum"):
        np.testing.assert_array_equal(
            np.asarray(getattr(state, f)), np.asarray(getattr(loaded, f)))
    assert int(jnp.sum(loaded.next_flat)) == int(jnp.sum(state.next_flat))

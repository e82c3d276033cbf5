"""Pool renderer (render/pool.py) vs the bounded-loop batch renderer:
identical estimator, identical RNG streams — images must match to fp
reorder tolerance."""
import numpy as np
import pytest

from rust_raytracer_jax import models
from rust_raytracer_jax.render.camera import Camera
from rust_raytracer_jax.render.renderer import Renderer


@pytest.mark.parametrize("scene_name", ["test"])
def test_pool_matches_batched(scene_name):
    scene = models.build(scene_name)
    cam = Camera(
        image_width=48, aspect_ratio=1.5, samples_per_pixel=9,
        max_depth=5, position=(0, 0, 1), look_at=(0, 0, 0),
        focal_length=50.0,
    )
    r = Renderer(scene, cam, batch_size=1 << 12)
    img_batch = np.asarray(r.render_batched().hdr())
    img_pool = np.asarray(r.render_pool().hdr())
    np.testing.assert_allclose(img_pool, img_batch, rtol=2e-5, atol=2e-6)


def test_pool_lane_starvation():
    """More lanes than jobs: the pool must terminate and produce the same
    image (inactive lanes stay inert)."""
    scene = models.build("test")
    cam = Camera(
        image_width=16, aspect_ratio=1.0, samples_per_pixel=4,
        max_depth=4, position=(0, 0, 1), look_at=(0, 0, 0),
        focal_length=50.0,
    )
    # batch_size larger than n_pixels * spp
    r = Renderer(scene, cam, batch_size=1 << 12)
    img_pool = np.asarray(r.render_pool().hdr())
    img_batch = np.asarray(r.render_batched().hdr())
    np.testing.assert_allclose(img_pool, img_batch, rtol=2e-5, atol=2e-6)

"""Radiometric correctness tests with analytic oracles.

Furnace-style setups where the transport equation has a closed form; these
validate the estimator (NEE mixture weights, cosine pdfs, specular chains)
end-to-end, which no amount of unit testing of parts can.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from rust_raytracer_jax.core import rng as vrng
from rust_raytracer_jax.scene import graph as g
from rust_raytracer_jax.scene import compiler as sc
from rust_raytracer_jax.render import integrator


def _trace_rays(scene, org, dirn, max_depth=8, light_bias=0.25, seed=0):
    import functools
    import jax

    pack, static = sc.compile_scene(scene)
    n = org.shape[0]
    ctx = vrng.Ctx(
        pixel=jnp.arange(n, dtype=jnp.uint32),
        sample=jnp.zeros((n,), jnp.uint32),
        bounce=jnp.uint32(0),
        seed=jnp.uint32(seed),
    )
    traced = jax.jit(
        functools.partial(integrator.trace, static=static,
                          max_depth=max_depth, light_bias=light_bias),
        static_argnames=(),
    )
    return np.asarray(
        traced(pack, org=jnp.asarray(org, jnp.float32),
               dirn=jnp.asarray(dirn, jnp.float32), rng_ctx=ctx)
    )


N = 4096


def test_lambertian_furnace():
    """Lambertian plane under a uniform sky L: reflected radiance = a * L
    for any viewing direction (cosine-weighted MC is exact in expectation)."""
    albedo, sky_l = 0.6, 1.0
    plane = g.Plane((0, 0, 0), (50, 0, 0), (0, 0, -50),
                    g.Lambertian(g.Constant((albedo,) * 3)))
    sky = g.Sky(g.Constant((sky_l,) * 3))
    scene = g.SceneDef(world=g.Group([plane, sky]), lights=[sky])

    org = np.tile([0.0, 1.0, 0.0], (N, 1))
    dirn = np.tile([0.01, -1.0, 0.02], (N, 1))
    rad = _trace_rays(scene, org, dirn, max_depth=6, light_bias=0.25)
    # every lane hits the plane once then the sky; E[pixel] = a * L
    np.testing.assert_allclose(rad.mean(0), albedo * sky_l, rtol=0.02)


def test_lambertian_furnace_no_nee():
    """Same furnace with light_bias=0 (pure BRDF sampling): each lane is
    exactly a*L with zero variance (cos/pi / (cos/pi) == 1)."""
    albedo, sky_l = 0.45, 2.0
    plane = g.Plane((0, 0, 0), (50, 0, 0), (0, 0, -50),
                    g.Lambertian(g.Constant((albedo,) * 3)))
    sky = g.Sky(g.Constant((sky_l,) * 3))
    scene = g.SceneDef(world=g.Group([plane, sky]), lights=[sky])

    org = np.tile([0.0, 1.0, 0.0], (N // 8, 1))
    dirn = np.tile([0.0, -1.0, 0.0], (N // 8, 1))
    rad = _trace_rays(scene, org, dirn, max_depth=4, light_bias=0.0)
    np.testing.assert_allclose(rad, albedo * sky_l, rtol=1e-3)


def test_mirror_reflects_sky():
    """Perfect mirror (metal, roughness 0): radiance = albedo * sky."""
    alb = (0.9, 0.7, 0.5)
    plane = g.Plane((0, 0, 0), (50, 0, 0), (0, 0, -50),
                    g.Metal(g.Constant(alb), g.Constant(0.0)))
    sky = g.Sky(g.Constant((1.0, 1.0, 1.0)))
    scene = g.SceneDef(world=g.Group([plane, sky]), lights=[sky])

    org = np.tile([0.0, 1.0, 0.0], (64, 1))
    dirn = np.tile([0.3, -1.0, 0.1], (64, 1))
    rad = _trace_rays(scene, org, dirn, max_depth=4)
    np.testing.assert_allclose(rad, np.tile(alb, (64, 1)), rtol=1e-3)


def test_emissive_front_face_only():
    """Emissive planes emit only on the front face (emissive.rs:28-34)."""
    light = g.Plane((0, 0, 0), (10, 0, 0), (0, 0, -10),
                    g.Emissive(g.Constant((5.0, 5.0, 5.0))))
    scene = g.SceneDef(world=g.Group([light]), lights=[light])

    above = np.tile([0.0, 1.0, 0.0], (16, 1))
    below = np.tile([0.0, -1.0, 0.0], (16, 1))
    down = np.tile([0.0, -1.0, 0.0], (16, 1))
    up = np.tile([0.0, 1.0, 0.0], (16, 1))
    # plane normal is u x v = +y: visible from above...
    rad_above = _trace_rays(scene, above, down)
    np.testing.assert_allclose(rad_above, 5.0, rtol=1e-4)
    # ...but a ray from below doesn't even hit (backface culled,
    # plane.rs:68-77) -> black background
    rad_below = _trace_rays(scene, below, up)
    np.testing.assert_allclose(rad_below, 0.0, atol=1e-6)


def test_depth_zero_cutoff():
    """max_depth bounces then black (camera.rs:290-292): a mirror box ping-
    pongs forever; finite depth must give finite (zero) light."""
    m = g.Metal(g.Constant((1.0, 1.0, 1.0)), g.Constant(0.0))
    p1 = g.Plane((0, 0, 0), (10, 0, 0), (0, 0, -10), m)
    p2 = g.Plane((0, 2, 0), (10, 0, 0), (0, 0, 10), m)
    scene = g.SceneDef(world=g.Group([p1, p2]), lights=[])

    org = np.tile([0.0, 1.0, 0.0], (16, 1))
    dirn = np.tile([0.0, -1.0, 0.0], (16, 1))
    rad = _trace_rays(scene, org, dirn, max_depth=5)
    assert np.isfinite(rad).all()
    np.testing.assert_allclose(rad, 0.0, atol=1e-6)


def test_sun_delta_light():
    """Sun visible only within its 1e-3 cone (sun.rs:33-45)."""
    sun = g.Sun((0, 0, 1), g.Constant((7.0, 7.0, 7.0)))
    scene = g.SceneDef(world=g.Group([sun]), lights=[sun])
    org = np.zeros((2, 3))
    dirn = np.array([[0.0, 0.0, 1.0], [0.05, 0.0, 1.0]])
    rad = _trace_rays(scene, org, dirn)
    np.testing.assert_allclose(rad[0], 7.0, rtol=1e-4)
    np.testing.assert_allclose(rad[1], 0.0, atol=1e-6)


def test_volume_transmittance():
    """Constant-density slab: P(pass through) = exp(-rho * thickness);
    black absorber (albedo 0) in front of a white sky -> mean radiance
    = L * exp(-rho * d)."""
    rho, d, L = 0.5, 2.0, 1.0
    box = g.Box((0, 0, 0), (10.0, 10.0, d), g.Lambertian(g.Constant((1, 1, 1))))
    vol = g.Volume(box, g.Isotropic(g.Constant((0.0, 0.0, 0.0))), rho)
    sky = g.Sky(g.Constant((L, L, L)))
    scene = g.SceneDef(world=g.Group([vol, sky]), lights=[sky])

    org = np.tile([0.0, 0.0, -5.0], (N, 1))
    dirn = np.tile([0.0, 0.0, 1.0], (N, 1))
    rad = _trace_rays(scene, org, dirn, max_depth=3, light_bias=0.0)
    expected = L * np.exp(-rho * d)
    np.testing.assert_allclose(rad.mean(0), expected, rtol=0.05)

"""Unit tests for core vector math vs NumPy/analytic oracles.

Oracles mirror the closed-form definitions in the reference
(vec4.rs, utils.rs) evaluated in float64 NumPy.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from rust_raytracer_jax.core import math as m


RNG = np.random.default_rng(0)


def rand_vecs(n=64):
    return RNG.standard_normal((n, 3)).astype(np.float32)


def test_dot_cross_length():
    a, b = rand_vecs(), rand_vecs()
    np.testing.assert_allclose(m.dot(a, b), np.sum(a * b, -1), rtol=1e-5)
    np.testing.assert_allclose(m.cross(a, b), np.cross(a, b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.length(a), np.linalg.norm(a, axis=-1), rtol=1e-5)


def test_normalize():
    a = rand_vecs()
    u = np.asarray(m.normalize(a))
    np.testing.assert_allclose(np.linalg.norm(u, axis=-1), 1.0, rtol=1e-5)


def test_reflect_is_involution_and_preserves_length():
    v, n = rand_vecs(), np.asarray(m.normalize(rand_vecs()))
    r = np.asarray(m.reflect(v, n))
    # reflecting twice returns the original vector
    rr = np.asarray(m.reflect(r, n))
    np.testing.assert_allclose(rr, v, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        np.linalg.norm(r, axis=-1), np.linalg.norm(v, axis=-1), rtol=1e-5
    )


def test_refract_snell_law():
    # incoming 45 degrees onto a flat surface with ior ratio 1/1.5
    v = np.array([[np.sqrt(0.5), -np.sqrt(0.5), 0.0]], np.float32)
    n = np.array([[0.0, 1.0, 0.0]], np.float32)
    ratio = 1.0 / 1.5
    r = np.asarray(m.refract(v, n, ratio))
    # sin(theta_t) = ratio * sin(theta_i)
    sin_t = np.linalg.norm(np.cross(r, n), axis=-1)
    np.testing.assert_allclose(sin_t, ratio * np.sqrt(0.5), rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(r, axis=-1), 1.0, rtol=1e-5)


def test_refract_normal_incidence_passthrough():
    v = np.array([[0.0, -1.0, 0.0]], np.float32)
    n = np.array([[0.0, 1.0, 0.0]], np.float32)
    r = np.asarray(m.refract(v, n, 0.7))
    np.testing.assert_allclose(r, v, atol=1e-6)


def test_reflectance_schlick_oracle():
    # reference utils.rs:31-36
    def oracle(cos, ratio):
        r0 = ((1 - ratio) / (1 + ratio)) ** 2
        return r0 + (1 - r0) * (1 - cos) ** 5

    cos = np.linspace(0, 1, 11)
    for ratio in [1 / 1.5, 1.5, 1 / 2.4]:
        np.testing.assert_allclose(
            m.reflectance(cos, ratio), oracle(cos, ratio), rtol=1e-5
        )
    # grazing incidence -> full reflection
    np.testing.assert_allclose(m.reflectance(0.0, 1 / 1.5), 1.0, rtol=1e-6)


def test_onb_orthonormal_right_handed():
    w = np.asarray(m.normalize(rand_vecs()))
    u, v, w2 = m.onb_from_vec(w)
    u, v = np.asarray(u), np.asarray(v)
    for a, b in [(u, v), (u, w), (v, w)]:
        np.testing.assert_allclose(np.sum(a * b, -1), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(u, axis=-1), 1.0, rtol=1e-5)
    # the reference's ONB (utils.rs:17-28: v = w x a, u = w x v) is
    # left-handed: u x v = -w.  Harmless for azimuthally-symmetric pdfs;
    # we match it exactly for parity.
    np.testing.assert_allclose(np.cross(u, v), -w, atol=1e-5)
    # local +z maps to w
    z = m.onb_transform(u, v, w, np.array([0.0, 0.0, 1.0], np.float32))
    np.testing.assert_allclose(np.asarray(z), w, atol=1e-5)


def test_cosine_hemisphere_distribution():
    n = 200_000
    u = RNG.random((n, 2)).astype(np.float32)
    d = np.asarray(m.square_to_cosine_hemisphere(u[:, 0], u[:, 1]))
    assert (d[:, 2] >= 0).all()
    # E[cos theta] under pdf cos/pi is 2/3
    np.testing.assert_allclose(d[:, 2].mean(), 2.0 / 3.0, atol=5e-3)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-4)


def test_uniform_sphere_distribution():
    n = 200_000
    u = RNG.random((n, 2)).astype(np.float32)
    d = np.asarray(m.square_to_uniform_sphere(u[:, 0], u[:, 1]))
    np.testing.assert_allclose(np.abs(d.mean(0)), 0.0, atol=6e-3)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-4)


def test_sphere_cone_within_cone():
    n = 10_000
    u = RNG.random((n, 2)).astype(np.float32)
    cos_max = 0.8
    d = np.asarray(m.square_to_sphere_cone(u[:, 0], u[:, 1], cos_max))
    assert (d[:, 2] >= cos_max - 1e-5).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-4)


def test_unit_circle_rim():
    # parity with reference vec4.rs:35-40 (normalized gaussian = rim)
    u = RNG.random((1000, 2)).astype(np.float32)
    p = np.asarray(m.square_to_unit_circle(u[:, 0], u[:, 1]))
    np.testing.assert_allclose(np.linalg.norm(p, axis=-1), 1.0, rtol=1e-5)

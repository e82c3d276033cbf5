"""Tests for the counter-based pcg4d RNG (core/rng.py)."""
import numpy as np
import jax.numpy as jnp

from rust_raytracer_jax.core import rng


def test_determinism_and_independence():
    lanes = jnp.arange(1024)
    a = np.asarray(rng.uniform(lanes, 0, 0, 42))
    b = np.asarray(rng.uniform(lanes, 0, 0, 42))
    np.testing.assert_array_equal(a, b)
    # different stream / bounce / seed give different values
    for kwargs in [(1, 0, 42), (0, 1, 42), (0, 0, 43)]:
        c = np.asarray(rng.uniform(lanes, *kwargs))
        assert np.mean(a == c) < 0.01


def test_uniformity():
    lanes = jnp.arange(1 << 16)
    u = np.asarray(rng.uniform(lanes, 3, 7, 123))
    assert (u >= 0).all() and (u < 1).all()
    np.testing.assert_allclose(u.mean(), 0.5, atol=5e-3)
    np.testing.assert_allclose(u.var(), 1.0 / 12.0, atol=5e-3)
    # chi-square-ish: histogram flatness over 64 bins
    h, _ = np.histogram(u, bins=64, range=(0, 1))
    assert h.min() > 0.8 * len(u) / 64
    assert h.max() < 1.2 * len(u) / 64


def test_order_independence_of_lanes():
    """Value depends only on the lane key, not array position/shape —
    the property that makes 1-chip vs N-chip renders bit-identical."""
    all_lanes = jnp.arange(4096)
    full = np.asarray(rng.uniform(all_lanes, 2, 5, 7))
    for start in [0, 1000, 4000]:
        shard = np.asarray(rng.uniform(all_lanes[start : start + 96], 2, 5, 7))
        np.testing.assert_array_equal(shard, full[start : start + 96])


def test_gaussian_moments():
    lanes = jnp.arange(1 << 17)
    g1, g2 = rng.gaussian2(lanes, 0, 9, 1)
    g = np.concatenate([np.asarray(g1), np.asarray(g2)])
    np.testing.assert_allclose(g.mean(), 0.0, atol=8e-3)
    np.testing.assert_allclose(g.std(), 1.0, atol=8e-3)


def test_uniform4_channels_independent():
    lanes = jnp.arange(1 << 14)
    u0, u1, u2, u3 = rng.uniform4(lanes, 0, 0, 0)
    us = np.stack([np.asarray(x) for x in (u0, u1, u2, u3)])
    corr = np.corrcoef(us)
    off_diag = corr[~np.eye(4, dtype=bool)]
    assert np.abs(off_diag).max() < 0.03

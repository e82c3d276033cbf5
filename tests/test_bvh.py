"""BVH traversal correctness: threaded flat BVH vs brute-force
Möller–Trumbore over all triangles (same closest-hit semantics as the
reference's octree traversal, mesh.rs:165-203)."""
import numpy as np
import jax.numpy as jnp
import pytest

from rust_raytracer_jax.scene import graph as g
from rust_raytracer_jax.scene import compiler as sc
from rust_raytracer_jax.ops import intersect as isect


def _random_mesh(n_tris=300, seed=3):
    rng = np.random.default_rng(seed)
    # triangle soup in [-1, 1]^3 with small extents
    centers = rng.uniform(-1, 1, (n_tris, 3))
    offsets = rng.normal(0, 0.15, (n_tris, 3, 3))
    verts = (centers[:, None, :] + offsets).reshape(-1, 3)
    tris = np.arange(3 * n_tris).reshape(n_tris, 3)
    normals = np.tile(np.array([[0.0, 1.0, 0.0]]), (3 * n_tris, 1))
    tri_idx = np.stack([tris, tris, np.full_like(tris, -1)], axis=-1)
    return g.Mesh(
        vertices=verts, normals=normals, uvs=np.zeros((0, 2)),
        triangles=tri_idx, material=g.Lambertian(g.Constant((0.5, 0.5, 0.5))),
    )


@pytest.fixture(scope="module")
def compiled():
    mesh = _random_mesh()
    scene = g.SceneDef(world=g.Group([mesh]), lights=[])
    pack, static = sc.compile_scene(scene)
    return pack


def _brute_force(pack, org, dirn, t_min):
    """Reference oracle: test every (padded) triangle per ray in NumPy."""
    v0 = np.asarray(pack.tri_v0)
    e1 = np.asarray(pack.tri_e1)
    e2 = np.asarray(pack.tri_e2)
    best_t = np.full(org.shape[0], np.inf)
    best_i = np.full(org.shape[0], -1)
    for i in range(v0.shape[0]):
        pvec = np.cross(dirn, e2[i])
        det = np.sum(e1[i] * pvec, -1)
        ok = det > 1e-12
        inv = 1.0 / np.where(det == 0, 1, det)
        b = org - v0[i]
        u = np.sum(b * pvec, -1) * inv
        qvec = np.cross(b, e1[i])
        v = np.sum(dirn * qvec, -1) * inv
        t = np.sum(e2[i] * qvec, -1) * inv
        ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
        ok &= (t > t_min) & (t < best_t)
        best_t = np.where(ok, t, best_t)
        best_i = np.where(ok, i, best_i)
    return best_t, best_i


def test_traversal_matches_brute_force(compiled):
    rng = np.random.default_rng(0)
    n = 512
    org = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    dirn = rng.normal(size=(n, 3)).astype(np.float32)

    t_bvh, i_bvh = isect.intersect_triangles(
        compiled, jnp.asarray(org), jnp.asarray(dirn),
        jnp.full((n,), 1e-3, jnp.float32), jnp.full((n,), np.inf, jnp.float32),
    )
    t_ref, i_ref = _brute_force(compiled, org.astype(np.float64),
                                dirn.astype(np.float64), 1e-3)

    t_bvh = np.asarray(t_bvh)
    i_bvh = np.asarray(i_bvh)
    hit_ref = np.isfinite(t_ref)
    hit_bvh = np.isfinite(t_bvh)
    # f32 vs f64 oracle: allow near-tie disagreement on the winning tri but
    # never on hit/miss classification beyond ulp-level t differences
    agree = hit_ref == hit_bvh
    assert agree.mean() > 0.999, f"hit/miss mismatch on {np.sum(~agree)} rays"
    both = hit_ref & hit_bvh
    np.testing.assert_allclose(t_bvh[both], t_ref[both], rtol=1e-3, atol=1e-4)
    # winning ids equal except possible exact-tie cases
    assert (i_bvh[both] == i_ref[both]).mean() > 0.99


def test_traversal_misses_outside(compiled):
    n = 64
    org = np.full((n, 3), 10.0, np.float32)
    dirn = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    t, i = isect.intersect_triangles(
        compiled, jnp.asarray(org), jnp.asarray(dirn),
        jnp.full((n,), 1e-3, jnp.float32), jnp.full((n,), np.inf, jnp.float32),
    )
    assert not np.isfinite(np.asarray(t)).any()
    assert (np.asarray(i) == -1).all()

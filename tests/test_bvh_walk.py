"""Triangle traversal: the Triton BVH walk (ops/bvh_walk.py, in the Pallas
interpreter here) and the jnp walk (ops/intersect.py) against each other
and against a NumPy brute-force oracle, on a random triangle soup."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rust_raytracer_jax.ops import bvh_walk
from rust_raytracer_jax.ops import intersect as isect
from rust_raytracer_jax.scene import bvh_builder
from rust_raytracer_jax.scene import compiler as sc
from rust_raytracer_jax.scene import graph as g


@pytest.fixture(scope="module")
def soup():
    rng = np.random.default_rng(11)
    n_tris = 700  # many leaves, several BVH levels
    centers = rng.uniform(-1, 1, (n_tris, 3))
    offsets = rng.normal(0, 0.12, (n_tris, 3, 3))
    verts = (centers[:, None, :] + offsets).reshape(-1, 3)
    tris = np.arange(3 * n_tris).reshape(n_tris, 3)
    tri_idx = np.stack([tris, tris, np.full_like(tris, -1)], axis=-1)
    mesh = g.Mesh(
        vertices=verts, normals=np.zeros((0, 3)), uvs=np.zeros((0, 2)),
        triangles=tri_idx, material=g.Lambertian(g.Constant((0.5, 0.5, 0.5))),
    )
    pack, _ = sc.compile_scene(g.SceneDef(world=g.Group([mesh]), lights=[]))
    return pack


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    dirn = rng.normal(size=(n, 3)).astype(np.float32)
    return jnp.asarray(org), jnp.asarray(dirn)


def _bounds(n, t_max=np.inf):
    return (jnp.full((n,), 1e-3, jnp.float32),
            jnp.full((n,), t_max, jnp.float32))


def _brute_force(pack, org, dirn, t_min, t_max):
    """Closest hit over every triangle slot in float64 (NumPy)."""
    v0 = np.asarray(pack.tri_v0, np.float64)[None]
    e1 = np.asarray(pack.tri_e1, np.float64)[None]
    e2 = np.asarray(pack.tri_e2, np.float64)[None]
    back = np.asarray(pack.tri_hit_back)[None]
    o = np.asarray(org, np.float64)[:, None]
    d = np.asarray(dirn, np.float64)[:, None]
    p = np.cross(d, e2)
    det = np.sum(e1 * p, -1)
    ok = np.where(back, np.abs(det), det) > isect.DET_EPS
    inv = 1.0 / np.where(det == 0.0, 1.0, det)
    b = o - v0
    u = np.sum(b * p, -1) * inv
    q = np.cross(b, e1)
    v = np.sum(d * q, -1) * inv
    t = np.sum(e2 * q, -1) * inv
    ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    ok &= (t > np.asarray(t_min)[:, None]) & (t < np.asarray(t_max)[:, None])
    t = np.where(ok, t, np.inf)
    return t.min(1), np.where(np.isfinite(t.min(1)), t.argmin(1), -1)


def _assert_same_hits(t_a, i_a, t_b, i_b):
    t_a, i_a, t_b, i_b = map(np.asarray, (t_a, i_a, t_b, i_b))
    np.testing.assert_array_equal(i_a >= 0, i_b >= 0)
    hit = i_a >= 0
    np.testing.assert_allclose(t_a[hit], t_b[hit], rtol=2e-5, atol=1e-6)
    assert (i_a[hit] == i_b[hit]).mean() > 0.999


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jnp_walk_matches_brute_force(soup, seed):
    n = 512
    org, dirn = _rays(n, seed)
    t_min, t_max = _bounds(n)
    t, i = isect.intersect_triangles(soup, org, dirn, t_min, t_max,
                                     kernel="jnp")
    t_ref, i_ref = _brute_force(soup, org, dirn, t_min, t_max)
    i = np.asarray(i)
    assert (i >= 0).sum() > 20
    _assert_same_hits(np.where(i >= 0, t, np.inf), i, t_ref, i_ref)


@pytest.mark.parametrize("seed", [0, 3])
def test_kernel_matches_jnp_walk(soup, seed):
    n = 256
    org, dirn = _rays(n, seed)
    t_min, t_max = _bounds(n)
    t_ref, i_ref = isect.intersect_triangles(soup, org, dirn, t_min, t_max,
                                             kernel="jnp")
    t_k, i_k = bvh_walk.intersect_triangles_gpu(
        soup, org, dirn, t_min, t_max, interpret=True)
    _assert_same_hits(t_k, i_k, t_ref, i_ref)
    # misses keep t = t_max, like the jnp walk
    miss = np.asarray(i_k) < 0
    assert np.all(np.isinf(np.asarray(t_k)[miss]))


def test_kernel_ragged_batch(soup):
    n = bvh_walk.BLOCK * 3 + 7  # not a whole number of blocks: padded
    org, dirn = _rays(n, seed=5)
    t_min, t_max = _bounds(n)
    t_k, i_k = bvh_walk.intersect_triangles_gpu(
        soup, org, dirn, t_min, t_max, interpret=True)
    assert t_k.shape == (n,) and i_k.shape == (n,)
    t_ref, i_ref = isect.intersect_triangles(soup, org, dirn, t_min, t_max,
                                             kernel="jnp")
    _assert_same_hits(t_k, i_k, t_ref, i_ref)


def test_kernel_finite_t_max(soup):
    n = 128
    org, dirn = _rays(n, seed=7)
    t_min, t_inf = _bounds(n)
    t_ref, i_ref = isect.intersect_triangles(soup, org, dirn, t_min, t_inf,
                                             kernel="jnp")
    t_ref, hit = np.asarray(t_ref), np.asarray(i_ref) >= 0
    # odd lanes get a bound below their hit, even lanes keep infinity
    cap = np.where(hit, t_ref * 0.5, 1.0).astype(np.float32)
    cap[::2] = np.inf
    cap = jnp.asarray(cap)
    t_k, i_k = bvh_walk.intersect_triangles_gpu(
        soup, org, dirn, t_min, cap, interpret=True)
    t_j, i_j = isect.intersect_triangles(soup, org, dirn, t_min, cap,
                                         kernel="jnp")
    _assert_same_hits(t_k, i_k, t_j, i_j)
    i_k = np.asarray(i_k)
    np.testing.assert_array_equal(i_k[::2] >= 0, hit[::2])
    assert not np.any(i_k[1::2][hit[1::2]] >= 0)


def test_kernel_dead_lanes(soup):
    """t_max = 0 (a dead pool lane): no hit, and t stays 0."""
    n = 64
    org, dirn = _rays(n, seed=9)
    t_min, _ = _bounds(n)
    t_k, i_k = bvh_walk.intersect_triangles_gpu(
        soup, org, dirn, t_min, jnp.zeros((n,), jnp.float32),
        interpret=True)
    assert np.all(np.asarray(i_k) < 0)
    np.testing.assert_array_equal(np.asarray(t_k), 0.0)


def test_kernel_detached_gradient(soup):
    """jax.grad through the kernel: the pallas_call has no JVP rule, so it
    runs detached (intersect.call_detached) — the forward value is kept,
    no cotangent reaches the traversal inputs, and downstream
    differentiable use of the rays still gets its gradient."""
    n = 64
    org, dirn = _rays(n, seed=4)
    t_min, _ = _bounds(n)
    t_max = jnp.full((n,), 1e9, jnp.float32)

    def loss(o):
        t, _ = bvh_walk.walk_triangles(soup, o, dirn, t_min, t_max,
                                       interpret=True)
        return jnp.sum(jnp.where(t < 1e9, t, 0.0) * o[:, 0])

    val, grad = jax.value_and_grad(loss)(org)
    t, _ = bvh_walk.walk_triangles(soup, org, dirn, t_min, t_max,
                                   interpret=True)
    t = np.asarray(t)
    np.testing.assert_allclose(np.asarray(grad)[:, 0],
                               np.where(t < 1e9, t, 0.0), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(grad)[:, 1:], 0.0)
    assert np.isfinite(float(val))


def test_auto_runs_jnp_walk_on_cpu(soup):
    """kernel="auto" compiles the jnp walk for the CPU (no Triton kernel in
    the program) and the Triton kernel for an NVIDIA GPU."""
    n = 64
    org, dirn = _rays(n, seed=2)
    t_min, t_max = _bounds(n)

    def f(o, d):
        return isect.intersect_triangles(soup, o, d, t_min, t_max)

    traced = jax.jit(f).trace(org, dirn)
    cpu_text = traced.lower(lowering_platforms=("cpu",)).as_text()
    cuda_text = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" not in cpu_text
    assert "__gpu$xla.gpu.triton" in cuda_text
    assert "bvh_walk" in cuda_text
    t, i = jax.jit(f)(org, dirn)
    t_j, i_j = isect.intersect_triangles(soup, org, dirn, t_min, t_max,
                                         kernel="jnp")
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_j))


def test_explicit_kernel_raises_off_gpu(soup):
    n = 32
    org, dirn = _rays(n)
    t_min, t_max = _bounds(n)
    with pytest.raises(ValueError, match="GPU"):
        bvh_walk.intersect_triangles_gpu(soup, org, dirn, t_min, t_max)
    with pytest.raises(ValueError, match="kernel"):
        isect.intersect_triangles(soup, org, dirn, t_min, t_max,
                                  kernel="pallas")


def test_leaf_size_is_shared(soup):
    """Every leaf owns exactly LEAF_SIZE slots of the padded triangle
    table, the count both walks test at a leaf."""
    leaf = np.asarray(soup.bvh_leaf_start)
    starts = np.sort(leaf[leaf >= 0])
    assert soup.tri_v0.shape[0] == len(starts) * bvh_builder.LEAF_SIZE
    np.testing.assert_array_equal(
        starts, np.arange(len(starts)) * bvh_builder.LEAF_SIZE)


@pytest.mark.gpu
def test_kernel_on_gpu_matches_jnp_walk(soup):
    n = 4096
    org, dirn = _rays(n, seed=1)
    t_min, t_max = _bounds(n)
    t_k, i_k = bvh_walk.intersect_triangles_gpu(soup, org, dirn, t_min,
                                                t_max)
    t_j, i_j = isect.intersect_triangles(soup, org, dirn, t_min, t_max,
                                         kernel="jnp")
    _assert_same_hits(t_k, i_k, t_j, i_j)

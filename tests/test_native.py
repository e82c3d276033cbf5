"""Native C++ core vs NumPy fallback parity (OBJ parsing, BVH layout
invariants)."""
import os

import numpy as np
import pytest

from rust_raytracer_jax import native
from rust_raytracer_jax.scene import bvh_builder
from rust_raytracer_jax.utils import assets

MONKEY = os.path.join(
    os.environ.get("RRT_ASSET_ROOT", "/root/reference/scenes"),
    "resource/monkey.obj",
)

needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)
needs_monkey = pytest.mark.skipif(
    not os.path.exists(MONKEY), reason="monkey.obj asset unavailable"
)


def _numpy_parse(path):
    os.environ["RRT_NO_NATIVE"] = "1"
    try:
        # reset wrapper state so the env var takes effect
        native._lib_failed = False
        lib, native._lib = native._lib, None
        try:
            return assets.parse_obj(path)
        finally:
            native._lib = lib
    finally:
        del os.environ["RRT_NO_NATIVE"]
        native._lib_failed = False


@needs_native
@needs_monkey
def test_obj_native_matches_numpy():
    v1, uv1, n1, t1 = assets.parse_obj(MONKEY)
    v2, uv2, n2, t2 = _numpy_parse(MONKEY)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_allclose(v1, v2, rtol=0, atol=0)
    np.testing.assert_allclose(uv1, uv2, rtol=0, atol=0)
    np.testing.assert_allclose(n1, n2, rtol=1e-12, atol=1e-12)


@needs_native
def test_sah_bvh_layout_invariants():
    rng = np.random.default_rng(1)
    n = 5000
    c = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.3, (n, 3)).astype(np.float32)
    flat = bvh_builder.build(c - h, c + h)
    m = flat.node_min.shape[0]

    # every primitive appears exactly once
    used = flat.tri_order[flat.tri_order >= 0]
    assert sorted(used.tolist()) == list(range(n))

    # links are in range and strictly forward (preorder threading)
    idx = np.arange(m)
    assert (flat.hit_link > idx).all() and (flat.hit_link <= m).all()
    assert (flat.miss_link > idx).all() and (flat.miss_link <= m).all()

    # leaf AABBs contain their triangles' AABBs
    leaf = np.where(flat.leaf_start >= 0)[0]
    ls = flat.leaf_start[leaf]
    for li, s in zip(leaf[:500], ls[:500]):
        tris = flat.tri_order[s : s + bvh_builder.LEAF_SIZE]
        tris = tris[tris >= 0]
        assert ((c - h)[tris] >= flat.node_min[li] - 1e-4).all()
        assert ((c + h)[tris] <= flat.node_max[li] + 1e-4).all()

    # walking hit links on "always hit" visits every node exactly once:
    # internal -> hit_link, leaf -> also hit_link (== miss); terminates at m
    seen = np.zeros(m, bool)
    node = 0
    steps = 0
    while node < m and steps <= m:
        seen[node] = True
        node = int(flat.hit_link[node])
        steps += 1
    assert seen.all() and steps == m

"""Arbitrary affine instancing (reference: object/transform.rs:122-139) and
convex volume boundaries (reference: object/volume.rs:34-37).

The reference transforms the ray per instance; this build bakes transforms
at compile time — sheared planes via the dual-basis parameterization,
non-uniform/sheared spheres via per-instance world<->unit-sphere maps,
and sheared/mesh volume boundaries via per-volume triangle blocks.  Each
test checks the baked form against an independent oracle.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rust_raytracer_jax.core import rng as vrng
from rust_raytracer_jax.ops import intersect as isect
from rust_raytracer_jax.scene import compiler as sc
from rust_raytracer_jax.scene import graph as g
from rust_raytracer_jax.scene import pack as sp

MAT = g.Lambertian(g.Constant((0.5, 0.5, 0.5)))


def _rays(n, seed=0, aim=(0.0, 0.0, 0.0), spread=0.8):
    """Rays from random origins aimed at `aim` with jitter — guarantees
    meaningful hit coverage on unit-scale targets."""
    r = np.random.default_rng(seed)
    org = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    target = np.asarray(aim) + r.normal(0, spread, (n, 3))
    dirn = (target - org).astype(np.float32)
    return jnp.asarray(org), jnp.asarray(dirn)


def _ctx(n):
    return vrng.Ctx(pixel=jnp.arange(n, dtype=jnp.uint32),
                    sample=jnp.zeros((n,), jnp.uint32),
                    bounce=jnp.uint32(0), seed=jnp.uint32(0))


SHEAR = np.eye(4)
SHEAR[0, 1] = 0.6
SHEAR[1, 2] = -0.3


def test_sheared_plane_matches_mesh():
    """A plane under a shear transform must hit exactly like the same
    parallelogram tessellated as two triangles."""
    plane = g.Transform(
        g.Plane((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), MAT),
        matrix=SHEAR.copy(),
    )
    # the same parallelogram as a mesh: corner = c-u-v, span 2u x 2v
    c = SHEAR[:3, :3] @ np.zeros(3)
    u = SHEAR[:3, :3] @ np.array([1.0, 0.0, 0.0])
    v = SHEAR[:3, :3] @ np.array([0.0, 0.0, 1.0])
    corner = c - u - v
    verts = np.array([corner, corner + 2 * u, corner + 2 * u + 2 * v,
                      corner + 2 * v])
    tris = np.array([[0, 1, 2], [0, 2, 3]])
    tri_idx = np.stack([tris, tris, np.full_like(tris, -1)], axis=-1)
    mesh = g.Mesh(vertices=verts, normals=np.zeros((0, 3)),
                  uvs=np.zeros((0, 2)), triangles=tri_idx, material=MAT,
                  hit_back_faces=True)

    pack_p, _ = sc.compile_scene(g.SceneDef(world=g.Group([plane]), lights=[]))
    pack_m, _ = sc.compile_scene(g.SceneDef(world=g.Group([mesh]), lights=[]))

    n = 512
    org, dirn = _rays(n)
    hit_p = isect.intersect(pack_p, org, dirn, 1e-3, _ctx(n), kernel="jnp")
    hit_m = isect.intersect(pack_m, org, dirn, 1e-3, _ctx(n), kernel="jnp")
    tp = np.asarray(hit_p.t)
    tm = np.asarray(hit_m.t)
    # plane tests only the front face; restrict to front-side rays
    nrm = np.cross(u, v)
    front = np.asarray(jnp.sum(dirn * jnp.asarray(nrm, jnp.float32), -1)) < 0
    hp = np.isfinite(tp[front])
    hm = np.isfinite(tm[front])
    assert hp.sum() > 30  # enough coverage to be meaningful
    np.testing.assert_array_equal(hp, hm)
    np.testing.assert_allclose(tp[front][hp], tm[front][hm], rtol=2e-4,
                               atol=1e-5)


def test_ellipsoid_sphere_matches_quadric_oracle():
    """Sphere under non-uniform scale + shear: hits must satisfy the
    ellipsoid quadric |A(p - c)| = 1, with t matching a NumPy solve."""
    m = SHEAR.copy()
    m[:3, :3] = m[:3, :3] @ np.diag([2.0, 1.0, 0.5])
    m[:3, 3] = [0.3, -0.2, 0.1]
    sphere = g.Transform(g.Sphere((0.1, 0.0, 0.0), 0.8, MAT),
                         matrix=m.copy())
    pack, _ = sc.compile_scene(g.SceneDef(world=g.Group([sphere]), lights=[]))
    assert pack.sph_inv.shape[0] == 1  # ellipsoid path engaged

    n = 512
    org, dirn = _rays(n, seed=3)
    hit = isect.intersect(pack, org, dirn, 1e-3, _ctx(n), kernel="jnp")
    t = np.asarray(hit.t)

    # oracle: unit-sphere quadratic in object space
    c_w = m[:3, :3] @ np.array([0.1, 0.0, 0.0]) + m[:3, 3]
    A = np.linalg.inv(m[:3, :3] * 0.8)
    o_l = (np.asarray(org) - c_w) @ A.T
    d_l = np.asarray(dirn) @ A.T
    a = np.sum(d_l * d_l, -1)
    hb = np.sum(d_l * o_l, -1)
    cc = np.sum(o_l * o_l, -1) - 1.0
    disc = hb * hb - a * cc
    ok = disc > 0
    sq = np.sqrt(np.maximum(disc, 0))
    r1 = (-hb - sq) / a
    r2 = (-hb + sq) / a
    t_oracle = np.where(ok & (r1 > 1e-3), r1,
                        np.where(ok & (r2 > 1e-3), r2, np.inf))
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(t_oracle))
    hits = np.isfinite(t)
    assert hits.sum() > 30
    np.testing.assert_allclose(t[hits], t_oracle[hits], rtol=2e-4, atol=1e-5)

    # normal maps by the forward matrix (transform.rs:133 quirk) and is
    # flipped toward the ray
    attr = isect.hit_attributes(pack, org, dirn, hit)
    pos = np.asarray(attr.pos)[hits]
    nrm = np.asarray(attr.normal)[hits]
    s_hat = (pos - c_w) @ A.T
    expect = s_hat @ (m[:3, :3] * 0.8).T
    expect /= np.linalg.norm(expect, axis=-1, keepdims=True)
    d_h = np.asarray(dirn)[hits]
    expect = np.where((np.sum(d_h * expect, -1) < 0)[:, None], expect, -expect)
    np.testing.assert_allclose(nrm, expect, atol=2e-4)


def test_many_ellipsoids_match_quadric_oracle():
    """More than 16 ellipsoids take the chunked (N, C) scan; its 3x3 maps
    must hold full f32 precision (a TF32 product would miss the rtol)."""
    r = np.random.default_rng(5)
    mats, spheres = [], []
    for k in range(20):
        m = np.eye(4)
        m[:3, :3] = r.normal(0, 0.3, (3, 3)) + np.diag(r.uniform(0.5, 1.5, 3))
        m[:3, 3] = r.uniform(-1.5, 1.5, 3)
        mats.append(m)
        spheres.append(g.Transform(g.Sphere((0.0, 0.0, 0.0), 0.4, MAT),
                                   matrix=m.copy()))
    pack, _ = sc.compile_scene(g.SceneDef(world=g.Group(spheres), lights=[]))
    assert pack.sph_inv.shape[0] == 20  # ellipsoid path, chunked scan

    n = 512
    org, dirn = _rays(n, seed=8, spread=1.2)
    t = np.asarray(isect.intersect(pack, org, dirn, 1e-3, _ctx(n),
                                   kernel="jnp").t)

    o = np.asarray(org, np.float64)
    d = np.asarray(dirn, np.float64)
    t_oracle = np.full(n, np.inf)
    for m in mats:
        A = np.linalg.inv(m[:3, :3] * 0.4)
        o_l = (o - m[:3, 3]) @ A.T
        d_l = d @ A.T
        a = np.sum(d_l * d_l, -1)
        hb = np.sum(d_l * o_l, -1)
        disc = hb * hb - a * (np.sum(o_l * o_l, -1) - 1.0)
        sq = np.sqrt(np.maximum(disc, 0))
        r1, r2 = (-hb - sq) / a, (-hb + sq) / a
        tk = np.where((disc > 0) & (r1 > 1e-3), r1,
                      np.where((disc > 0) & (r2 > 1e-3), r2, np.inf))
        t_oracle = np.minimum(t_oracle, tk)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(t_oracle))
    hits = np.isfinite(t)
    assert hits.sum() > 100
    np.testing.assert_allclose(t[hits], t_oracle[hits], rtol=2e-4, atol=1e-5)


def test_mesh_volume_boundary_matches_box_analytic():
    """A rotated box volume compiled analytically (VOL_BOX) vs the same
    boundary forced through the mesh path (VOL_MESH): identical spans."""
    box = g.Box((0.2, -0.1, 0.0), (1.2, 0.8, 1.5), MAT)
    rot = g.Transform(g.Volume(box, g.Isotropic(g.Constant((1, 1, 1))),
                               density=0.5))
    rot.rotate_y(35.0).rotate_x(10.0).translate(0.1, 0.2, -0.3)
    pack_box, _ = sc.compile_scene(
        g.SceneDef(world=g.Group([rot]), lights=[]))
    assert int(pack_box.vol_kind[0]) == sp.VOL_BOX

    # same transform but sheared => compiler must take the mesh path;
    # with shear = 0 limit we instead force it via an explicit Mesh boundary
    m = np.eye(4)
    m[:3, :3] = rot.matrix[:3, :3]
    m[:3, 3] = rot.matrix[:3, 3]
    cx = np.array([0.2, -0.1, 0.0])
    hx = np.array([1.2, 0.8, 1.5]) / 2.0
    corners = np.array([
        cx + hx * np.array(s)
        for s in [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
                  (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
    ])
    quads = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
             (2, 3, 7, 6), (0, 3, 7, 4), (1, 2, 6, 5)]
    tris = []
    for a, b, c2, d in quads:
        tris += [(a, b, c2), (a, c2, d)]
    tris = np.asarray(tris)
    tri_idx = np.stack([tris, tris, np.full_like(tris, -1)], axis=-1)
    bmesh = g.Mesh(vertices=corners, normals=np.zeros((0, 3)),
                   uvs=np.zeros((0, 2)), triangles=tri_idx, material=MAT)
    vol_m = g.Transform(
        g.Volume(bmesh, g.Isotropic(g.Constant((1, 1, 1))), density=0.5),
        matrix=m.copy(),
    )
    pack_mesh, _ = sc.compile_scene(
        g.SceneDef(world=g.Group([vol_m]), lights=[]))
    assert int(pack_mesh.vol_kind[0]) == sp.VOL_MESH

    n = 512
    org, dirn = _rays(n, seed=9)
    span = jax.vmap(isect._volume_boundary_span, in_axes=(None, 0, 0, None))
    eb, xb, vb = map(np.asarray, span(pack_box, org, dirn, 0))
    em, xm, vm = map(np.asarray, span(pack_mesh, org, dirn, 0))
    assert vb.sum() > 50
    np.testing.assert_array_equal(vb, vm)
    np.testing.assert_allclose(em[vb], eb[vb], rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(xm[vb], xb[vb], rtol=2e-4, atol=1e-4)


def test_sheared_box_volume_takes_mesh_path():
    """The compiler must route sheared box boundaries through VOL_MESH and
    produce a valid span (entry < exit) for rays through the medium."""
    vol = g.Transform(
        g.Volume(g.Box((0, 0, 0), (1, 1, 1), MAT),
                 g.Isotropic(g.Constant((1, 1, 1))), density=1.0),
        matrix=SHEAR.copy(),
    )
    pack, _ = sc.compile_scene(g.SceneDef(world=g.Group([vol]), lights=[]))
    assert int(pack.vol_kind[0]) == sp.VOL_MESH
    n = 256
    org, dirn = _rays(n, seed=5)
    span = jax.vmap(isect._volume_boundary_span, in_axes=(None, 0, 0, None))
    e, x, v = map(np.asarray, span(pack, org, dirn, 0))
    assert v.sum() > 20
    assert np.all(e[v] < x[v])
    # oracle membership: midpoints of valid spans lie inside the sheared box
    mid = np.asarray(org)[v] + np.asarray(dirn)[v] * ((e[v] + x[v]) / 2)[:, None]
    inv = np.linalg.inv(SHEAR[:3, :3])
    local = mid @ inv.T
    assert np.all(np.abs(local) <= 0.5 + 1e-4)

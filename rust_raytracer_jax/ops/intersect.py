"""Wavefront intersection kernels.

Replaces the reference's recursive `Hit::test` descent over trait objects
(reference: src/object/list.rs:58-74 and friends) with typed, fully
vectorized ray-vs-table tests:

  * spheres / planes: `lax.scan` over primitive chunks with a running
    closest-hit carry — O(N_rays x chunk) memory, no (N, P)
    materialization.
  * triangles: stackless traversal of a flat threaded BVH (skip links);
    leaves are fixed-size (LEAF_SIZE) runs of degenerate-padded triangles
    so leaf processing is branch-free and unrolled.  On an NVIDIA GPU the
    walk is one Triton kernel (ops/bvh_walk.py); elsewhere it is the jnp
    while_loop below.
  * volumes / sky / sun: analytic, evaluated after surfaces (see
    `intersect` for the exact reference-ordering argument).

Returned hits carry (t, kind, prim); `hit_attributes` then gathers the
winning primitive's data and computes the differentiable hit record
(position, normal, uv, tangent frame).  Discrete ids are integers and act
as detached decisions; geometry recomputed from gathered arrays keeps the
chain differentiable w.r.t. scene parameters.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core import math as vmath
from ..core import rng
from ..scene import bvh_builder
from ..scene import pack as sp

# t used for sun hits (reference: sun.rs uses f64::MAX so the sun occludes
# the sky at t = INFINITY but loses to any finite surface hit).
T_SUN = 3.0e38
# Epsilon guarding near-parallel plane/triangle hits.  The reference uses
# f64::EPSILON (plane.rs:76, mesh.rs:79); in f32 we use a tiny absolute
# threshold — dets below this are degenerate either way.
DET_EPS = 1e-12

# 3x3 maps run in full f32: a GPU may otherwise take f32 products in TF32
HIGHEST = lax.Precision.HIGHEST

PRIM_CHUNK = 32   # primitives per scan step for sphere/plane loops


class Hit(NamedTuple):
    t: jnp.ndarray        # (N,) hit distance (in units of |dir|); inf = miss
    kind: jnp.ndarray     # (N,) int32 PRIM_* id
    prim: jnp.ndarray     # (N,) int32 index into the kind's table


# ---------------------------------------------------------------------------
# Sphere / plane closest-hit scans
# ---------------------------------------------------------------------------


def _chunk_size(n_prims: int) -> int:
    """Chunk width for the sphere/plane scans: no wider than the actual
    primitive count (padding a 2-sphere scene to a 32-wide chunk costs 16x
    the vector work for nothing)."""
    return max(1, min(PRIM_CHUNK, n_prims))


def _chunked_argmin(n_prims, init_t, body):
    """Scan `body(start) -> (t_chunk, idx_chunk)` over primitive chunks,
    keeping the closest hit per ray.  Static trip count; chunk indices are
    masked with +inf beyond n_prims."""
    chunk = _chunk_size(n_prims)
    n_chunks = max(1, -(-n_prims // chunk))

    def step(carry, start):
        best_t, best_i = carry
        t_c, i_c = body(start)  # (N, C), (C,)
        t_c = jnp.where(t_c < best_t[:, None], t_c, jnp.inf)
        k = jnp.argmin(t_c, axis=1)
        t_new = jnp.take_along_axis(t_c, k[:, None], axis=1)[:, 0]
        better = t_new < best_t
        best_t = jnp.where(better, t_new, best_t)
        best_i = jnp.where(better, i_c[k], best_i)
        return (best_t, best_i), None

    starts = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (best_t, best_i), _ = lax.scan(step, (init_t, jnp.full_like(init_t, -1, jnp.int32)), starts)
    return best_t, best_i


def sphere_hit_t(org, dirn, center, radius, t_min, t_max):
    """Quadratic ray-sphere test, nearest root in (t_min, t_max)
    (reference: sphere.rs:40-63).  Broadcasts org (N,1,3) vs center (..,C,3).

    Grad-safe: this is called from the NEE pdf path (ops/lights.py), which
    is live under jax.grad.  sqrt's argument is masked *before* the sqrt —
    `where` after the fact does not stop reverse-mode from multiplying the
    d(sqrt)/dx = inf of missing lanes into upstream cotangents (0*inf=NaN).
    """
    oc = org - center
    a = vmath.length_squared(dirn)
    half_b = vmath.dot(dirn, oc)
    c = vmath.length_squared(oc) - radius * radius
    disc = half_b * half_b - a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
    sq = jnp.where(ok, sq, 0.0)
    root1 = (-half_b - sq) / a
    root2 = (-half_b + sq) / a
    v1 = ok & (root1 > t_min) & (root1 < t_max)
    v2 = ok & (root2 > t_min) & (root2 < t_max)
    return jnp.where(v1, root1, jnp.where(v2, root2, jnp.inf))


def intersect_spheres(pack: sp.ScenePack, org, dirn, t_min, t_max):
    n_s = pack.sph_center.shape[0]
    if n_s == 0:
        return t_max, jnp.full(org.shape[:-1], -1, jnp.int32)

    # ellipsoid instances present? (static: compiler emits sph_inv only
    # when some sphere carries a non-similarity transform)
    affine = pack.sph_inv.shape[0] > 0

    # Few primitives (the common case): one unrolled (N,)-shaped test per
    # sphere; the chunked (N, C) broadcast below puts a tiny C on the minor
    # axis.
    if n_s <= 16:
        best_t = t_max
        best_i = jnp.full(org.shape[:-1], -1, jnp.int32)
        for si in range(n_s):
            if affine:
                inv = pack.sph_inv[si]
                oc = jnp.einsum("ij,nj->ni", inv, org - pack.sph_center[si],
                                precision=HIGHEST)
                dl = jnp.einsum("ij,nj->ni", inv, dirn, precision=HIGHEST)
                a = jnp.sum(dl * dl, axis=-1)
                half_b = jnp.sum(dl * oc, axis=-1)
                c = jnp.sum(oc * oc, axis=-1) - 1.0
            else:
                oc = org - pack.sph_center[si]
                a = vmath.length_squared(dirn)
                half_b = jnp.sum(dirn * oc, axis=-1)
                c = jnp.sum(oc * oc, axis=-1) - pack.sph_radius[si] ** 2
            disc = half_b * half_b - a * c
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            root1 = (-half_b - sq) / a
            root2 = (-half_b + sq) / a
            ok = disc >= 0.0
            v1 = ok & (root1 > t_min) & (root1 < best_t)
            v2 = ok & (root2 > t_min) & (root2 < best_t)
            t = jnp.where(v1, root1, jnp.where(v2, root2, jnp.inf))
            better = t < best_t
            best_t = jnp.where(better, t, best_t)
            best_i = jnp.where(better, si, best_i)
        return best_t, best_i

    a_plain = vmath.length_squared(dirn)[:, None]

    def body(start):
        idx = start + jnp.arange(_chunk_size(n_s), dtype=jnp.int32)
        valid = idx < n_s
        idx_c = jnp.clip(idx, 0, n_s - 1)
        center = pack.sph_center[idx_c]          # (C, 3)
        oc = org[:, None, :] - center[None, :, :]
        if affine:
            # world -> unit-sphere space per instance; the quadratic's t
            # parameter is preserved by the linear map
            inv = pack.sph_inv[idx_c]            # (C, 3, 3)
            oc_l = jnp.einsum("cij,ncj->nci", inv, oc, precision=HIGHEST)
            d_l = jnp.einsum("cij,nj->nci", inv, dirn, precision=HIGHEST)
            a = jnp.sum(d_l * d_l, axis=-1)
            half_b = jnp.sum(d_l * oc_l, axis=-1)
            c = jnp.sum(oc_l * oc_l, axis=-1) - 1.0
        else:
            radius = pack.sph_radius[idx_c]      # (C,)
            a = a_plain
            half_b = jnp.sum(dirn[:, None, :] * oc, axis=-1)
            c = jnp.sum(oc * oc, axis=-1) - (radius * radius)[None, :]
        disc = half_b * half_b - a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        root1 = (-half_b - sq) / a
        root2 = (-half_b + sq) / a
        ok = disc >= 0.0
        v1 = ok & (root1 > t_min[:, None]) & (root1 < t_max[:, None])
        v2 = ok & (root2 > t_min[:, None]) & (root2 < t_max[:, None])
        t = jnp.where(v1, root1, jnp.where(v2, root2, jnp.inf))
        t = jnp.where(valid[None, :], t, jnp.inf)
        return t, idx

    return _chunked_argmin(n_s, t_max, body)


def plane_hit(org, dirn, corner, dual_u, dual_v, normal, backface, t_min, t_max):
    """Finite-parallelogram test (reference: plane.rs:66-101).

    `dual_u`/`dual_v` are the compile-time dual basis of the (possibly
    non-orthogonal) half-span vectors (scene/compiler._plane_duals), so
    uv = (local . dual_u, local . dual_v) is exact for sheared instances
    too (the reference transforms the ray per instance instead,
    transform.rs:122-139).

    Returns (t, u, v) with t = inf on miss; u, v in [0, 1] across the full
    2u x 2v span.  Shapes broadcast: ray (N, 1, 3) vs plane (1, C, 3).
    """
    dot_rn = jnp.sum(normal * dirn, axis=-1)
    dd = jnp.where(backface, jnp.abs(dot_rn), -dot_rn)
    facing = dd > DET_EPS
    # Grad-safe division: `facing` implies |dot_rn| > DET_EPS, so masking the
    # denominator never changes a hit lane's t — it only keeps the t of
    # parallel rays finite so reverse-mode (this runs live in the NEE pdf
    # path, ops/lights.py) never sees inf*0 cotangents.
    denom = jnp.where(jnp.abs(dot_rn) > DET_EPS, dot_rn, 1.0)
    t = jnp.sum(normal * (corner - org), axis=-1) / denom
    in_t = facing & (t > t_min) & (t < t_max)
    # uv math on a bounded t: non-facing lanes can still carry a huge finite
    # t; evaluating pos there would feed inf/overflow into the uv products.
    t_uvsafe = jnp.where(in_t, t, 1.0)
    pos = org + dirn * t_uvsafe[..., None]
    local = pos - corner
    # uv from the dual basis (reference inv_u/inv_v, plane.rs:56)
    u = jnp.sum(local * dual_u, axis=-1)
    v = jnp.sum(local * dual_v, axis=-1)
    in_uv = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    hit = in_t & in_uv
    return jnp.where(hit, t, jnp.inf), u, v


def intersect_planes(pack: sp.ScenePack, org, dirn, t_min, t_max):
    n_p = pack.pln_corner.shape[0]
    if n_p == 0:
        return t_max, jnp.full(org.shape[:-1], -1, jnp.int32)

    # few planes: unrolled (N,) tests (see intersect_spheres)
    if n_p <= 16:
        best_t = t_max
        best_i = jnp.full(org.shape[:-1], -1, jnp.int32)
        for pi in range(n_p):
            t, _, _ = plane_hit(
                org, dirn, pack.pln_corner[pi], pack.pln_dual_u[pi],
                pack.pln_dual_v[pi], pack.pln_normal[pi],
                pack.pln_backface[pi], t_min, best_t,
            )
            better = t < best_t
            best_t = jnp.where(better, t, best_t)
            best_i = jnp.where(better, pi, best_i)
        return best_t, best_i

    def body(start):
        idx = start + jnp.arange(_chunk_size(n_p), dtype=jnp.int32)
        valid = idx < n_p
        idx_c = jnp.clip(idx, 0, n_p - 1)
        t, _, _ = plane_hit(
            org[:, None, :], dirn[:, None, :],
            pack.pln_corner[idx_c][None], pack.pln_dual_u[idx_c][None],
            pack.pln_dual_v[idx_c][None], pack.pln_normal[idx_c][None],
            pack.pln_backface[idx_c][None],
            t_min[:, None], t_max[:, None],
        )
        return jnp.where(valid[None, :], t, jnp.inf), idx

    return _chunked_argmin(n_p, t_max, body)


# ---------------------------------------------------------------------------
# Triangles: Möller–Trumbore + threaded-BVH traversal
# ---------------------------------------------------------------------------


def triangle_hit(org, dirn, v0, e1, e2, hit_back, t_min, t_max):
    """Möller–Trumbore with Cramer barycentrics (reference: mesh.rs:61-101).

    Returns (t, u, v); t = inf on miss.  Degenerate (zero-edge) padding
    triangles produce det = 0 and never hit.
    """
    pvec = jnp.cross(dirn, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    dd = jnp.where(hit_back, jnp.abs(det), det)
    ok = dd > DET_EPS
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
    b = org - v0
    u = jnp.sum(b * pvec, axis=-1) * inv_det
    qvec = jnp.cross(b, e1)
    v = jnp.sum(dirn * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    ok &= (t > t_min) & (t < t_max)
    return jnp.where(ok, t, jnp.inf), u, v


def call_detached(fn, *args):
    """Run fn(*args) as a non-differentiable block: forward is unchanged;
    under AD the outputs carry zero tangents and no cotangents reach the
    inputs.

    The Triton traversal kernel (ops/bvh_walk.py) is wrapped with this
    because pallas_call's internal while loop has no JVP rule.
    Semantically identical to the integrator's stop_gradient on the hits:
    traversal DECISIONS (ids, raw t) are detached, and hit_attributes
    recomputes geometry differentiably from the gathered primitives
    (reference estimator: camera.rs:282-332)."""
    import numpy as np

    f = jax.custom_jvp(fn)

    @f.defjvp
    def _jvp(primals, tangents):
        del tangents
        out = fn(*primals)

        def zero_tangent(o):
            if jnp.issubdtype(o.dtype, jnp.floating):
                return jnp.zeros_like(o)
            return np.zeros(o.shape, dtype=jax.dtypes.float0)

        return out, jax.tree_util.tree_map(zero_tangent, out)

    return f(*args)


KERNELS = ("auto", "jnp")


def walk_triangles_jnp(pack: sp.ScenePack, org, dirn, t_min, t_max):
    """The portable threaded-BVH walk, one XLA while_loop over the whole
    wavefront: every lane advances one node per iteration, and a lane at a
    leaf tests the leaf's LEAF_SIZE triangle slots.  The reference that
    the GPU kernel (ops/bvh_walk.py) is tested against."""
    n_nodes = pack.bvh_min.shape[0]
    n_tris = pack.tri_v0.shape[0]
    n = org.shape[0]
    inv_dir = 1.0 / dirn  # inf on zero components — IEEE slab test handles it

    def cond(state):
        node, best_t, best_i = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, best_t, best_i = state
        active = node < n_nodes
        nidx = jnp.where(active, node, 0)

        bmin = pack.bvh_min[nidx]
        bmax = pack.bvh_max[nidx]
        t0 = (bmin - org) * inv_dir
        t1 = (bmax - org) * inv_dir
        near = jnp.minimum(t0, t1)
        far = jnp.maximum(t0, t1)
        t_near = jnp.maximum(jnp.max(near, axis=-1), t_min)
        t_far = jnp.minimum(jnp.min(far, axis=-1), best_t)
        box_hit = t_near <= t_far

        leaf_start = pack.bvh_leaf_start[nidx]
        is_leaf = box_hit & (leaf_start >= 0)
        start = jnp.where(is_leaf, leaf_start, 0)
        for k in range(bvh_builder.LEAF_SIZE):
            ti = jnp.clip(start + k, 0, n_tris - 1)
            t, _, _ = triangle_hit(
                org, dirn,
                pack.tri_v0[ti], pack.tri_e1[ti], pack.tri_e2[ti],
                pack.tri_hit_back[ti], t_min, best_t,
            )
            better = is_leaf & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_i = jnp.where(better, ti, best_i)

        next_node = jnp.where(
            box_hit & (leaf_start < 0),
            pack.bvh_hit_link[nidx],
            pack.bvh_miss_link[nidx],
        )
        node = jnp.where(active, next_node, node)
        return node, best_t, best_i

    node0 = jnp.zeros((n,), jnp.int32)
    best_i0 = jnp.full((n,), -1, jnp.int32)
    _, best_t, best_i = lax.while_loop(cond, body, (node0, t_max, best_i0))
    return best_t, best_i


def intersect_triangles(pack: sp.ScenePack, org, dirn, t_min, t_max,
                        kernel: str = "auto"):
    """Closest triangle hit through the threaded BVH.  Returns (t, slot):
    t = t_max and slot = -1 where no triangle lies in (t_min, t_max).

    kernel="auto" runs the Triton walk (ops/bvh_walk.py) where the
    computation is compiled for an NVIDIA GPU, and the jnp walk on every
    other platform; kernel="jnp" always runs the jnp walk.  Both are
    exact and detached: traversal decisions carry no gradient.
    """
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if pack.tri_v0.shape[0] == 0 or pack.bvh_min.shape[0] == 0:
        return t_max, jnp.full(org.shape[:-1], -1, jnp.int32)
    args = jax.tree_util.tree_map(
        lax.stop_gradient, (pack, org, dirn, t_min, t_max))
    if kernel == "jnp":
        return walk_triangles_jnp(*args)
    from . import bvh_walk

    return lax.platform_dependent(
        *args, cuda=bvh_walk.walk_triangles, default=walk_triangles_jnp)


# ---------------------------------------------------------------------------
# Volumes (reference: object/volume.rs)
# ---------------------------------------------------------------------------


def _volume_boundary_span(pack: sp.ScenePack, org, dirn, vi):
    """Entry/exit t of ray vs. the (convex) boundary of volume vi —
    sphere/ellipsoid, oriented box, or arbitrary convex triangle mesh
    (reference: volume.rs:34-37 accepts any Hit boundary).
    Returns (t_enter, t_exit, valid)."""
    kind = pack.vol_kind[vi]
    center = pack.vol_center[vi]
    axes = pack.vol_axes[vi]  # (3, 3): world->unit-sphere map (VOL_SPHERE)
    #                            or world->local rotation rows (VOL_BOX)

    # sphere/ellipsoid span via the unit-sphere quadratic (axes = I/r for
    # plain spheres — same roots, one code path for ellipsoid instances)
    oc = jnp.einsum("ij,j->i", axes, org - center, precision=HIGHEST)
    dl = jnp.einsum("ij,j->i", axes, dirn, precision=HIGHEST)
    a = vmath.length_squared(dl)
    half_b = vmath.dot(dl, oc)
    c = vmath.length_squared(oc) - 1.0
    disc = half_b * half_b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    a_safe = jnp.where(a == 0.0, 1.0, a)
    s_enter = (-half_b - sq) / a_safe
    s_exit = (-half_b + sq) / a_safe
    s_valid = disc > 0.0

    # oriented-box span: rotate into local frame, slab test
    lo_org = oc  # == axes @ (org - center); box axes are unit rows / half
    lo_dir = dl
    half = pack.vol_halfsize[vi]
    inv = 1.0 / lo_dir
    t0 = (-half - lo_org) * inv
    t1 = (half - lo_org) * inv
    b_enter = jnp.max(jnp.minimum(t0, t1))
    b_exit = jnp.min(jnp.maximum(t0, t1))
    b_valid = b_enter < b_exit

    # mesh span: all crossings of the padded triangle block; convex =>
    # entry = min, exit = second distinct crossing (min t > entry)
    v0 = pack.vol_tri_v0[vi]  # (TB, 3)
    e1 = pack.vol_tri_e1[vi]
    e2 = pack.vol_tri_e2[vi]
    pvec = jnp.cross(dirn[None, :], e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
    bvec = org[None, :] - v0
    u = jnp.sum(bvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(bvec, e1)
    w = jnp.sum(dirn[None, :] * qvec, axis=-1) * inv_det
    tt = jnp.sum(e2 * qvec, axis=-1) * inv_det
    ok = (jnp.abs(det) > DET_EPS) & (u >= 0.0) & (u <= 1.0)
    ok &= (w >= 0.0) & (u + w <= 1.0)
    ts = jnp.where(ok, tt, jnp.inf)
    m_enter = jnp.min(ts)
    m_exit = jnp.min(jnp.where(ts > m_enter + 1e-6, ts, jnp.inf))
    m_valid = jnp.isfinite(m_enter) & jnp.isfinite(m_exit)
    m_enter = jnp.where(m_valid, m_enter, 0.0)
    m_exit = jnp.where(m_valid, m_exit, 0.0)

    is_sphere = kind == sp.VOL_SPHERE
    is_mesh = kind == sp.VOL_MESH
    t_enter = jnp.where(is_sphere, s_enter,
                        jnp.where(is_mesh, m_enter, b_enter))
    t_exit = jnp.where(is_sphere, s_exit,
                       jnp.where(is_mesh, m_exit, b_exit))
    valid = jnp.where(is_sphere, s_valid,
                      jnp.where(is_mesh, m_valid, b_valid))
    return t_enter, t_exit, valid


def intersect_volumes(pack: sp.ScenePack, org, dirn, t_min, t_max, rng_ctx):
    """Stochastic constant-density media (reference: volume.rs:33-71).

    Surfaces must already have bounded t_max so free-flight sampling is
    truncated at the nearest surface — equivalent to the reference's
    shrinking-interval list scan for non-nested media, and strictly more
    correct when a surface precedes the volume in list order.
    """
    n_v = pack.vol_kind.shape[0]
    if n_v == 0:
        return t_max, jnp.full(org.shape[:-1], -1, jnp.int32)

    ray_len = vmath.length(dirn)
    best_t = t_max
    best_i = jnp.full(org.shape[:-1], -1, jnp.int32)
    span = jax.vmap(_volume_boundary_span, in_axes=(None, 0, 0, None))
    for vi in range(n_v):  # volumes are few; unrolled
        t_enter, t_exit, valid = span(pack, org, dirn, vi)
        lo = jnp.maximum(jnp.maximum(t_enter, t_min), 0.0)
        hi = jnp.minimum(t_exit, best_t)
        inside = valid & (lo < hi)
        dist_inside = (hi - lo) * ray_len
        u = rng_ctx.uniform(rng.Streams.VOLUME + 16 * vi)
        hit_dist = pack.vol_neg_inv_density[vi] * jnp.log(jnp.maximum(u, 1e-30))
        t = lo + hit_dist / ray_len
        hit = inside & (hit_dist <= dist_inside)
        best_i = jnp.where(hit, vi, best_i)
        best_t = jnp.where(hit, t, best_t)
    return best_t, best_i


# ---------------------------------------------------------------------------
# Sun / sky / full-scene dispatch
# ---------------------------------------------------------------------------

SUN_THETA_MAX = 1e-3  # reference: sun.rs:14


def intersect(pack: sp.ScenePack, org, dirn, t_min, rng_ctx, alive=None,
              kernel: str = "auto"):
    """Closest hit across all primitive classes.  Returns Hit.

    Ordering semantics match the reference's ObjectList scan with shrinking
    intervals: finite surface hits beat volumes' truncated free-flight
    samples, sun (t = MAX) beats sky (t = INF), and sky "hits" whenever
    nothing else does (sky.rs:29-33: t=INF accepted only while the interval
    is still unbounded).

    `alive` (optional bool mask) bounds the triangle traversal's t_max at 0
    for dead lanes: a dead (compacted) lane then exits the BVH
    at the root instead of re-walking its stale ray.  Dead lanes' results
    are garbage by contract — the integrator masks them.
    """
    n = org.shape[0]
    inf = jnp.full((n,), jnp.inf, org.dtype)
    t_min = jnp.broadcast_to(jnp.asarray(t_min, org.dtype), (n,))

    t_sph, i_sph = intersect_spheres(pack, org, dirn, t_min, inf)
    t_pln, i_pln = intersect_planes(pack, org, dirn, t_min, inf)
    # Bound the BVH walk by the nearest sphere/plane hit: a bounce ray that
    # terminates on a wall prunes every subtree farther than the wall.
    tri_tmax = jnp.minimum(t_sph, t_pln)
    if alive is not None:
        tri_tmax = jnp.where(alive, tri_tmax, 0.0).astype(org.dtype)
    t_tri, i_tri = intersect_triangles(
        pack, org, dirn, t_min, tri_tmax, kernel=kernel)
    t_tri = jnp.where(i_tri >= 0, t_tri, jnp.inf)

    # closest surface
    t_best = jnp.minimum(jnp.minimum(t_sph, t_pln), t_tri)
    kind = jnp.where(
        t_sph <= t_best, sp.PRIM_SPHERE,
        jnp.where(t_pln <= t_best, sp.PRIM_PLANE, sp.PRIM_TRIANGLE),
    ).astype(jnp.int32)
    prim = jnp.where(
        t_sph <= t_best, i_sph, jnp.where(t_pln <= t_best, i_pln, i_tri)
    )
    kind = jnp.where(jnp.isfinite(t_best), kind, sp.PRIM_NONE)
    prim = jnp.where(jnp.isfinite(t_best), prim, -1)

    # volumes, truncated by nearest surface
    t_vol, i_vol = intersect_volumes(pack, org, dirn, t_min, t_best, rng_ctx)
    vol_hit = i_vol >= 0
    t_best = jnp.where(vol_hit, t_vol, t_best)
    kind = jnp.where(vol_hit, sp.PRIM_VOLUME, kind)
    prim = jnp.where(vol_hit, i_vol, prim)

    # sun: only when no finite hit and direction within the cone
    n_sun = pack.sun_dir.shape[0]
    if n_sun:
        unit_d = vmath.normalize(dirn)
        miss = ~jnp.isfinite(t_best)
        for ui in range(n_sun):
            in_cone = jnp.abs(vmath.dot(unit_d, pack.sun_dir[ui]) - 1.0) <= SUN_THETA_MAX
            take = miss & in_cone
            t_best = jnp.where(take, T_SUN, t_best)
            kind = jnp.where(take, sp.PRIM_SUN, kind)
            prim = jnp.where(take, ui, prim)
            miss = miss & ~take

    # sky: catches everything still unbounded.  The LAST sky in the list
    # wins ties: Sky::test rejects only when hit_t > interval max, and
    # inf > inf is false, so each later sky at t=inf replaces the previous
    # one in the reference's list scan (sky.rs:31, list.rs:66-71).
    n_sky = pack.sky_tex.shape[0]
    if n_sky:
        miss = ~jnp.isfinite(t_best)
        kind = jnp.where(miss, sp.PRIM_SKY, kind)
        prim = jnp.where(miss, n_sky - 1, prim)
        t_best = jnp.where(miss, jnp.inf, t_best)

    return Hit(t=t_best, kind=kind, prim=prim)


class HitAttributes(NamedTuple):
    pos: jnp.ndarray         # (N, 3) hit position (finite pseudo-pos for sky/sun)
    normal: jnp.ndarray      # (N, 3) shading normal, flipped toward the ray
    tangent: jnp.ndarray     # (N, 3)
    bitangent: jnp.ndarray   # (N, 3)
    uv: jnp.ndarray          # (N, 2)
    front_face: jnp.ndarray  # (N,) bool
    mat: jnp.ndarray         # (N,) int32 material id (0 if miss)
    valid: jnp.ndarray       # (N,) bool — there was a hit


def hit_attributes(pack: sp.ScenePack, org, dirn, hit: Hit) -> HitAttributes:
    """Gather the winning primitive and compute the full hit record
    (reference: HitRecord, object.rs:32-105).

    Differentiability contract: the caller stop-gradients `hit` (ids AND t),
    and this function *recomputes* t for the winning primitive from the
    gathered geometry, so d(pos)/d(scene params) flows without
    differentiating the traversal loop.  Volume t stays detached (its
    free-flight sample is a stochastic decision)."""
    n = org.shape[0]
    dtype = org.dtype
    prim = jnp.maximum(hit.prim, 0)
    hit_t_detached = jax.lax.stop_gradient(hit.t)
    # finite evaluation t: sky/sun use t=1 (direction-only shading)
    env = (hit.kind == sp.PRIM_SKY) | (hit.kind == sp.PRIM_SUN)
    t_eval = jnp.where(env | ~jnp.isfinite(hit_t_detached), 1.0, hit_t_detached)

    # --- differentiable t refinement per primitive kind ---
    # The sphere/plane tables are packed into one row table IN-JIT (they
    # are small, so the concat is free and XLA folds it) and gathered
    # once per lane instead of one narrow (N,3) gather per column, and
    # because the concat happens inside the trace,
    # gradients still flow to the CANONICAL narrow arrays (unlike the
    # big triangle table, which is packed at scene-compile time).
    sph_affine = pack.sph_inv.shape[0] > 0
    sph_row = None
    if pack.sph_center.shape[0]:
        ns = pack.sph_center.shape[0]
        cols = [pack.sph_center, pack.sph_radius[:, None],
                pack.sph_mat.astype(dtype)[:, None]]
        if sph_affine:
            cols += [pack.sph_inv.reshape(ns, 9),
                     pack.sph_fwd.reshape(ns, 9)]
        sph_row = jnp.concatenate(cols, axis=1)[prim]  # (N, 5|23)
        sc_ = sph_row[:, 0:3]
        if sph_affine:
            inv_ = sph_row[:, 5:14].reshape(n, 3, 3)
            oc = jnp.einsum("nij,nj->ni", inv_, org - sc_,
                            precision=HIGHEST)
            dl = jnp.einsum("nij,nj->ni", inv_, dirn, precision=HIGHEST)
            a_ = vmath.length_squared(dl)
            half_b = vmath.dot(dl, oc)
            c_ = vmath.length_squared(oc) - 1.0
        else:
            sr_ = sph_row[:, 3]
            oc = org - sc_
            dl = dirn
            a_ = vmath.length_squared(dirn)
            half_b = vmath.dot(dirn, oc)
            c_ = vmath.length_squared(oc) - sr_ * sr_
        sq = vmath.safe_sqrt(half_b * half_b - a_ * c_)
        r1 = (-half_b - sq) / a_
        r2 = (-half_b + sq) / a_
        # pick the root the traversal accepted (nearest to the detached t)
        t_sph = jnp.where(
            jnp.abs(r1 - t_eval) <= jnp.abs(r2 - t_eval), r1, r2
        )
        t_eval = jnp.where(hit.kind == sp.PRIM_SPHERE, t_sph, t_eval)
    pln_row = None
    if pack.pln_corner.shape[0]:
        pln_row = jnp.concatenate(
            [pack.pln_corner, pack.pln_dual_u, pack.pln_dual_v,
             pack.pln_normal, pack.pln_uhalf, pack.pln_vhalf,
             pack.pln_mat.astype(dtype)[:, None]], axis=1)[prim]  # (N, 19)
        nrm_ = pln_row[:, 9:12]
        denom = vmath.dot(nrm_, dirn)
        t_pln = vmath.dot(nrm_, pln_row[:, 0:3] - org) / jnp.where(
            denom == 0.0, 1.0, denom
        )
        t_eval = jnp.where(hit.kind == sp.PRIM_PLANE, t_pln, t_eval)
    # ONE packed row gather covers every per-triangle attribute (layout:
    # ScenePack.tri_attr) in place of eleven narrow (N,3)/(N,2) gathers
    tri_row = pack.tri_attr[prim] if pack.tri_v0.shape[0] else None
    if tri_row is not None:
        e1_ = tri_row[:, 3:6]
        e2_ = tri_row[:, 6:9]
        bq = jnp.cross(org - tri_row[:, 0:3], e1_)
        det_ = jnp.sum(e1_ * jnp.cross(dirn, e2_), axis=-1)
        t_tri = jnp.sum(e2_ * bq, axis=-1) / jnp.where(det_ == 0.0, 1.0, det_)
        t_eval = jnp.where(hit.kind == sp.PRIM_TRIANGLE, t_tri, t_eval)

    pos = org + dirn * t_eval[:, None]
    unit_d = vmath.normalize(dirn)

    # a miss keeps a unit normal facing the ray: shading builds a frame
    # from it on every lane, and a zero normal there gives NaN directions
    # whose masked-out terms still NaN the gradients (0 * NaN)
    normal = -unit_d
    tangent = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], dtype), (n, 3))
    bitangent = tangent
    uv = jnp.zeros((n, 2), dtype)
    mat = jnp.zeros((n,), jnp.int32)

    # --- sphere attributes (reference: sphere.rs:65-94) ---
    if sph_row is not None:
        sc = sph_row[:, 0:3]
        if sph_affine:
            # object (unit-sphere) space point: uv/tangent live there,
            # the world normal maps by the forward 3x3 — the reference's
            # Transform normal quirk (transform.rs:133); tangent frames
            # stay object-space exactly like transform.rs (which maps
            # only pos and normal back to world)
            s_n = jnp.einsum("nij,nj->ni",
                             sph_row[:, 5:14].reshape(n, 3, 3), pos - sc,
                             precision=HIGHEST)
            w_n = vmath.normalize(
                jnp.einsum("nij,nj->ni",
                           sph_row[:, 14:23].reshape(n, 3, 3), s_n,
                           precision=HIGHEST), 1e-20
            )
        else:
            s_n = (pos - sc) / sph_row[:, 3:4]
            w_n = s_n
        # clips keep arccos/atan2 gradients finite at poles & garbage lanes
        theta = jnp.arccos(jnp.clip(s_n[:, 1], -1.0 + 1e-7, 1.0 - 1e-7))
        pole = (jnp.abs(s_n[:, 0]) + jnp.abs(s_n[:, 2])) < 1e-12
        phi = jnp.arctan2(-s_n[:, 2], jnp.where(pole, 1.0, s_n[:, 0])) + jnp.pi
        s_uv = jnp.stack([phi / (2.0 * jnp.pi), theta / jnp.pi], axis=-1)
        s_tan = jnp.stack([-s_n[:, 2], jnp.zeros((n,), dtype), -s_n[:, 0]], axis=-1)
        s_bit = jnp.cross(s_n, s_tan)
        is_s = (hit.kind == sp.PRIM_SPHERE)[:, None]
        normal = jnp.where(is_s, w_n, normal)
        tangent = jnp.where(is_s, s_tan, tangent)
        bitangent = jnp.where(is_s, s_bit, bitangent)
        uv = jnp.where(is_s, s_uv, uv)
        mat = jnp.where(is_s[:, 0], sph_row[:, 4].astype(jnp.int32), mat)

    # --- plane attributes (reference: plane.rs:85-101) ---
    if pln_row is not None:
        cor = pln_row[:, 0:3]
        uh = pln_row[:, 12:15]
        vh = pln_row[:, 15:18]
        local = pos - cor
        # dual-basis uv — exact for non-orthogonal (sheared) spans
        pu = vmath.dot(local, pln_row[:, 3:6])
        pv = vmath.dot(local, pln_row[:, 6:9])
        is_p = (hit.kind == sp.PRIM_PLANE)[:, None]
        normal = jnp.where(is_p, pln_row[:, 9:12], normal)
        tangent = jnp.where(is_p, vmath.normalize(uh, 1e-20), tangent)
        bitangent = jnp.where(is_p, vmath.normalize(vh, 1e-20), bitangent)
        uv = jnp.where(is_p, jnp.stack([pu, pv], axis=-1), uv)
        mat = jnp.where(is_p[:, 0], pln_row[:, 18].astype(jnp.int32), mat)

    # --- triangle attributes (reference: mesh.rs:101-163) ---
    if tri_row is not None:
        v0 = tri_row[:, 0:3]
        e1 = tri_row[:, 3:6]
        e2 = tri_row[:, 6:9]
        # recompute barycentrics for the winning triangle (differentiable)
        pvec = jnp.cross(dirn, e2)
        det = jnp.sum(e1 * pvec, axis=-1)
        inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
        bvec = org - v0
        bu = jnp.sum(bvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(bvec, e1)
        bv = jnp.sum(dirn * qvec, axis=-1) * inv_det
        bw = 1.0 - bu - bv
        # interpolated shading normal — NOT renormalized, matching
        # mesh.rs:107-117 (flat shading bakes face normals into n0=n1=n2)
        t_n = (
            tri_row[:, 9:12] * bw[:, None]
            + tri_row[:, 12:15] * bu[:, None]
            + tri_row[:, 15:18] * bv[:, None]
        )
        uv0 = tri_row[:, 18:20]
        uv1 = tri_row[:, 20:22]
        uv2 = tri_row[:, 22:24]
        t_uv = uv0 * bw[:, None] + uv1 * bu[:, None] + uv2 * bv[:, None]
        # tangent frame from UV deltas (mesh.rs:129-151, thetenthplanet.de)
        duv1 = uv1 - uv0
        duv2 = uv2 - uv0
        e1perp = jnp.cross(t_n, e1)
        e2perp = jnp.cross(e2, t_n)
        tan = e2perp * duv1[:, 0:1] + e1perp * duv2[:, 0:1]
        bit = e2perp * duv1[:, 1:2] + e1perp * duv2[:, 1:2]
        inv_max = 1.0 / vmath.safe_sqrt(
            jnp.maximum(vmath.length_squared(tan), vmath.length_squared(bit)),
            1e-20,
        )
        has_uv = tri_row[:, 24] > 0.5
        t_tan = jnp.where(has_uv[:, None], tan * (-inv_max)[:, None], tangent)
        t_bit = jnp.where(has_uv[:, None], bit * inv_max[:, None], tangent)
        t_uv = jnp.where(has_uv[:, None], t_uv, 0.0)
        is_t = (hit.kind == sp.PRIM_TRIANGLE)[:, None]
        normal = jnp.where(is_t, t_n, normal)
        tangent = jnp.where(is_t, t_tan, tangent)
        bitangent = jnp.where(is_t, t_bit, bitangent)
        uv = jnp.where(is_t, t_uv, uv)
        mat = jnp.where(is_t[:, 0],
                        tri_row[:, 26].astype(jnp.int32), mat)

    # --- volume attributes (reference: volume.rs:56-66: arbitrary
    #     normal/uv; isotropic ignores them) ---
    if pack.vol_kind.shape[0]:
        is_v = hit.kind == sp.PRIM_VOLUME
        normal = jnp.where(is_v[:, None], jnp.array([1.0, 0.0, 0.0], dtype), normal)
        mat = jnp.where(is_v, pack.vol_mat[prim], mat)

    # --- sky attributes (reference: sky.rs:36-52) ---
    if pack.sky_tex.shape[0]:
        is_k = hit.kind == sp.PRIM_SKY
        kpole = (jnp.abs(unit_d[:, 0]) + jnp.abs(unit_d[:, 2])) < 1e-12
        k_u = jnp.arctan2(unit_d[:, 0], jnp.where(kpole, 1.0, unit_d[:, 2])) / (2.0 * jnp.pi) + 0.5
        k_v = unit_d[:, 1] / 2.0 + 0.5
        normal = jnp.where(is_k[:, None], -unit_d, normal)
        uv = jnp.where(is_k[:, None], jnp.stack([k_u, k_v], axis=-1), uv)

    # --- sun attributes (reference: sun.rs:47-61) ---
    if pack.sun_dir.shape[0]:
        is_u = hit.kind == sp.PRIM_SUN
        normal = jnp.where(is_u[:, None], -unit_d, normal)

    # front-face flip (reference: object.rs:55-60)
    front_face = vmath.dot(dirn, normal) < 0.0
    normal = jnp.where(front_face[:, None], normal, -normal)

    valid = hit.kind != sp.PRIM_NONE
    return HitAttributes(
        pos=pos, normal=normal, tangent=tangent, bitangent=bitangent,
        uv=uv, front_face=front_face, mat=mat, valid=valid,
    )

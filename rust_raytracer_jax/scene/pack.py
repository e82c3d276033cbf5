"""ScenePack — the flat, device-resident scene representation.

The reference walks an `Arc<dyn Hit>` object graph per ray (reference:
src/object.rs, src/object/list.rs).  Here the whole scene is
compiled once (scene/compiler.py) into typed SoA arrays: transforms baked
into world-space primitives, the per-mesh octrees + scene BVH replaced by a
single flat BVH over all triangles, and materials/textures/lights as tables
indexed by integer ids.  The pack is a pytree, so it passes straight through
jit / shard_map / grad; every array is replicated in each device's memory.

Material type ids (reference: src/material/*):
  0 lambertian, 1 metal, 2 dielectric, 3 glossy, 4 emissive, 5 isotropic,
  6 normal_debug

Light kinds (reference light-samplable objects): 0 sphere, 1 plane, 2 sky,
  3 sun   (meshes/volumes have pdf 0 in the reference and are not sampled)

Primitive kinds (hit records): 0 none/miss, 1 sphere, 2 plane, 3 triangle,
  4 volume, 5 sky, 6 sun
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import numpy as np
import jax.numpy as jnp

# Material type ids
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_GLOSSY = 3
MAT_EMISSIVE = 4
MAT_ISOTROPIC = 5
MAT_NORMAL_DEBUG = 6

# Primitive kinds
PRIM_NONE = 0
PRIM_SPHERE = 1
PRIM_PLANE = 2
PRIM_TRIANGLE = 3
PRIM_VOLUME = 4
PRIM_SKY = 5
PRIM_SUN = 6

# Light kinds
LIGHT_SPHERE = 0
LIGHT_PLANE = 1
LIGHT_SKY = 2
LIGHT_SUN = 3
LIGHT_PROXY = 4  # invisible sampling sphere (assimp.rs:123-129)

# Volume boundary kinds
VOL_SPHERE = 0
VOL_BOX = 1
VOL_MESH = 2  # arbitrary convex triangle boundary (volume.rs:34-37)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ScenePack:
    # --- spheres (reference: object/sphere.rs) ---
    sph_center: Any  # (S, 3)
    sph_radius: Any  # (S,)
    sph_mat: Any     # (S,) int32
    # ellipsoid instancing: present (shape (S, 3, 3)) only when some
    # sphere carries a non-similarity transform (non-uniform scale or
    # shear; the reference transforms the ray per instance,
    # transform.rs:122-139).  sph_inv maps world deltas into the unit
    # sphere's object space; sph_fwd is the forward 3x3 used for the
    # reference's normal-by-forward-matrix quirk (transform.rs:133).
    sph_inv: Any     # (S, 3, 3) or (0, 3, 3)
    sph_fwd: Any     # (S, 3, 3) or (0, 3, 3)

    # --- planes (reference: object/plane.rs); uhalf/vhalf are the half-span
    #     vectors, corner = center - uhalf - vhalf.  dual_u/dual_v are the
    #     precomputed dual basis of (uhalf, vhalf) scaled so that
    #     uv = (local . dual_u, local . dual_v) lands in [0,1] over the
    #     full 2u x 2v span — exact for NON-ORTHOGONAL spans too (sheared
    #     instances; the reference handles these by transforming the ray
    #     per instance, transform.rs:122-139) ---
    pln_corner: Any    # (P, 3)
    pln_uhalf: Any     # (P, 3)
    pln_vhalf: Any     # (P, 3)
    pln_dual_u: Any    # (P, 3)
    pln_dual_v: Any    # (P, 3)
    pln_normal: Any    # (P, 3) unit
    pln_area: Any      # (P,) full (2u x 2v) area
    pln_backface: Any  # (P,) bool — render_backface flag
    pln_mat: Any       # (P,) int32

    # --- triangles, world-space baked (reference: object/mesh.rs) ---
    tri_v0: Any   # (T, 3)
    tri_e1: Any   # (T, 3) v1 - v0
    tri_e2: Any   # (T, 3) v2 - v0
    tri_n0: Any   # (T, 3) shading normals (flat shading: all = face normal)
    tri_n1: Any
    tri_n2: Any
    tri_uv0: Any  # (T, 2)
    tri_uv1: Any
    tri_uv2: Any
    tri_has_uv: Any    # (T,) bool
    tri_hit_back: Any  # (T,) bool
    tri_mat: Any       # (T,) int32
    # packed per-triangle attribute rows — the SAME data as the eleven
    # narrow tri_* arrays above, laid out as one (T, 32) float table so
    # hit_attributes needs ONE row gather per lane instead of eleven.
    # Columns: v0(0:3) e1(3:6) e2(6:9) n0(9:12) n1(12:15)
    # n2(15:18) uv0(18:20) uv1(20:22) uv2(22:24) has_uv(24) hit_back(25)
    # mat(26).  This is a compiled mirror: under jax.grad the
    # triangle-geometry gradient of the hit record flows to THIS table
    # (the narrow arrays keep their gradients through every other
    # consumer, e.g. NEE pdfs).
    tri_attr: Any      # (T, 32) float

    # --- flat threaded BVH over all triangles (replaces per-mesh octrees +
    #     scene BVH nodes, reference: object/mesh/octree.rs, object/bvh.rs).
    #     Nodes are in DFS order with skip-link threading for stackless,
    #     divergence-free traversal: on AABB hit continue to hit_link (next
    #     node in DFS order), on miss jump to miss_link (skips the subtree);
    #     node_count acts as the terminal sentinel.  leaf_start >= 0 marks a
    #     leaf owning triangles [leaf_start, leaf_start + LEAF_SIZE) of the
    #     reordered, degenerate-padded triangle arrays
    #     (scene/bvh_builder.LEAF_SIZE). ---
    bvh_min: Any        # (M, 3)
    bvh_max: Any        # (M, 3)
    bvh_hit_link: Any   # (M,) int32
    bvh_miss_link: Any  # (M,) int32
    bvh_leaf_start: Any  # (M,) int32, -1 for internal nodes

    # --- constant-density volumes (reference: object/volume.rs) ---
    vol_kind: Any       # (V,) int32: VOL_SPHERE | VOL_BOX
    vol_center: Any     # (V, 3) sphere center / box center (world)
    vol_radius: Any     # (V,) sphere radius
    vol_axes: Any       # (V, 3, 3) box rows: world->local rotation (unit rows)
    vol_halfsize: Any   # (V, 3) box half extents in local space
    vol_neg_inv_density: Any  # (V,)
    vol_mat: Any        # (V,) int32
    # VOL_MESH boundaries: padded per-volume triangle blocks (degenerate
    # zero triangles never hit); the entry/exit span is the min and
    # second-min crossing over the block (convex => exactly 2 crossings)
    vol_tri_v0: Any     # (V, TB, 3)
    vol_tri_e1: Any     # (V, TB, 3)
    vol_tri_e2: Any     # (V, TB, 3)

    # --- sky / sun (reference: object/sky.rs, object/sun.rs) ---
    sky_tex: Any   # (K,) int32 emission texture node id
    sun_dir: Any   # (U, 3) unit direction
    sun_tex: Any   # (U,) int32

    # --- material table ---
    mat_type: Any        # (NM,) int32
    mat_albedo_tex: Any  # (NM,) int32 texture node id (albedo or emission map)
    mat_rough_tex: Any   # (NM,) int32
    mat_inv_ior: Any     # (NM,) 1/ior for glossy Schlick (glossy.rs:31)
    mat_ior: Any         # (NM,) ior for dielectric
    mat_normal_tex: Any  # (NM,) int32, -1 = no normal map

    # --- light table for NEE (reference: pdf/hittable.rs + object lists) ---
    light_kind: Any  # (L,) int32
    light_idx: Any   # (L,) int32 index into the kind's primitive table

    # --- invisible proxy light spheres: sampled by NEE, never intersected
    #     (reference: assimp.rs:123-129) ---
    lgt_sph_center: Any  # (Q, 3)
    lgt_sph_radius: Any  # (Q,)

    # --- texture node data (images, perlin tables), indexed statically by
    #     the TexProgram (ops/texture.py) ---
    tex_data: Tuple[Any, ...]

    # --- CONSTANT texture node values: row i is program node i's RGB value
    #     (0 for non-constant nodes).  Kept as a dynamic array (not baked
    #     into the static program) so albedo/emission constants are
    #     differentiable scene parameters. ---
    tex_const: Any  # (TN, 3)

    # --- misc ---
    background: Any  # (3,) constant background color


def _empty(shape, dtype=np.float32):
    return jnp.zeros(shape, dtype)


def empty_pack(dtype=jnp.float32) -> ScenePack:
    """A pack with zero primitives of every kind (all tables present)."""
    i32 = jnp.int32
    return ScenePack(
        sph_center=_empty((0, 3), dtype), sph_radius=_empty((0,), dtype),
        sph_mat=_empty((0,), i32),
        sph_inv=_empty((0, 3, 3), dtype), sph_fwd=_empty((0, 3, 3), dtype),
        pln_corner=_empty((0, 3), dtype), pln_uhalf=_empty((0, 3), dtype),
        pln_vhalf=_empty((0, 3), dtype),
        pln_dual_u=_empty((0, 3), dtype), pln_dual_v=_empty((0, 3), dtype),
        pln_normal=_empty((0, 3), dtype),
        pln_area=_empty((0,), dtype), pln_backface=_empty((0,), jnp.bool_),
        pln_mat=_empty((0,), i32),
        tri_v0=_empty((0, 3), dtype), tri_e1=_empty((0, 3), dtype),
        tri_e2=_empty((0, 3), dtype), tri_n0=_empty((0, 3), dtype),
        tri_n1=_empty((0, 3), dtype), tri_n2=_empty((0, 3), dtype),
        tri_uv0=_empty((0, 2), dtype), tri_uv1=_empty((0, 2), dtype),
        tri_uv2=_empty((0, 2), dtype), tri_has_uv=_empty((0,), jnp.bool_),
        tri_hit_back=_empty((0,), jnp.bool_), tri_mat=_empty((0,), i32),
        tri_attr=_empty((0, 32), dtype),
        bvh_min=_empty((0, 3), dtype), bvh_max=_empty((0, 3), dtype),
        bvh_hit_link=_empty((0,), i32), bvh_miss_link=_empty((0,), i32),
        bvh_leaf_start=_empty((0,), i32),
        vol_kind=_empty((0,), i32), vol_center=_empty((0, 3), dtype),
        vol_radius=_empty((0,), dtype), vol_axes=_empty((0, 3, 3), dtype),
        vol_halfsize=_empty((0, 3), dtype),
        vol_neg_inv_density=_empty((0,), dtype), vol_mat=_empty((0,), i32),
        vol_tri_v0=_empty((0, 1, 3), dtype), vol_tri_e1=_empty((0, 1, 3), dtype),
        vol_tri_e2=_empty((0, 1, 3), dtype),
        sky_tex=_empty((0,), i32),
        sun_dir=_empty((0, 3), dtype), sun_tex=_empty((0,), i32),
        mat_type=_empty((0,), i32), mat_albedo_tex=_empty((0,), i32),
        mat_rough_tex=_empty((0,), i32), mat_inv_ior=_empty((0,), dtype),
        mat_ior=_empty((0,), dtype), mat_normal_tex=_empty((0,), i32),
        light_kind=_empty((0,), i32), light_idx=_empty((0,), i32),
        lgt_sph_center=_empty((0, 3), dtype), lgt_sph_radius=_empty((0,), dtype),
        tex_data=(),
        tex_const=_empty((1, 3), dtype),
        background=_empty((3,), dtype),
    )

"""Closest-hit triangle traversal as one GPU kernel (Pallas, Triton route).

The jnp walk in ops/intersect.py runs the threaded BVH as one XLA
`while_loop` over the whole wavefront: every iteration launches its
kernels again and waits for the slowest of all lanes.  Here each Triton
program owns BLOCK rays and walks the same threaded BVH (preorder nodes
with hit/miss skip links, scene/pack.py) inside the kernel, so a block
finishes as soon as its own lanes do, and nothing leaves the registers
between nodes.  Node and triangle reads are gathers from device memory
into the tables the jnp walk reads; the triangle set of a large mesh
(v0/e1/e2, 36 bytes a triangle) stays in the card's L2.

A leaf owns `bvh_builder.LEAF_SIZE` triangle slots; each is tested with
the Möller–Trumbore arithmetic of `intersect.triangle_hit`.  Lanes not at
a leaf mask their triangle loads, so they issue no memory traffic there.

Results are (t, slot) with the jnp walk's contract: t = t_max and slot =
-1 where no triangle lies in (t_min, t_max).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from ..scene import bvh_builder
from .intersect import DET_EPS, call_detached

# Rays per Triton program, and warps per program.
BLOCK = 32
NUM_WARPS = 1


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmin_ref,
            tmax_ref, bmin_ref, bmax_ref, hit_ref, miss_ref, leaf_ref,
            v0_ref, e1_ref, e2_ref, back_ref, t_out, i_out, *,
            n_nodes: int, leaf_size: int):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    t_min = tmin_ref[...]
    inv_x, inv_y, inv_z = 1.0 / dx, 1.0 / dy, 1.0 / dz

    def cond(carry):
        node, _, _ = carry
        return jnp.max((node < n_nodes).astype(jnp.int32)) > 0

    def body(carry):
        node, best_t, best_i = carry
        active = node < n_nodes
        nidx = jnp.where(active, node, 0)
        b3 = nidx * 3
        tx0 = (bmin_ref[b3] - ox) * inv_x
        ty0 = (bmin_ref[b3 + 1] - oy) * inv_y
        tz0 = (bmin_ref[b3 + 2] - oz) * inv_z
        tx1 = (bmax_ref[b3] - ox) * inv_x
        ty1 = (bmax_ref[b3 + 1] - oy) * inv_y
        tz1 = (bmax_ref[b3 + 2] - oz) * inv_z
        t_near = jnp.maximum(
            jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
            jnp.maximum(jnp.minimum(tz0, tz1), t_min))
        t_far = jnp.minimum(
            jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
            jnp.minimum(jnp.maximum(tz0, tz1), best_t))
        box_hit = active & (t_near <= t_far)
        leaf_start = leaf_ref[nidx]
        is_leaf = box_hit & (leaf_start >= 0)

        for k in range(leaf_size):
            ti = jnp.where(is_leaf, leaf_start + k, 0)
            t3 = ti * 3

            def ld(ref, off, ti3=t3):
                return pltr.load(ref.at[ti3 + off], mask=is_leaf, other=0.0)

            v0x, v0y, v0z = ld(v0_ref, 0), ld(v0_ref, 1), ld(v0_ref, 2)
            e1x, e1y, e1z = ld(e1_ref, 0), ld(e1_ref, 1), ld(e1_ref, 2)
            e2x, e2y, e2z = ld(e2_ref, 0), ld(e2_ref, 1), ld(e2_ref, 2)
            back = pltr.load(back_ref.at[ti], mask=is_leaf, other=0)
            # pvec = d x e2
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            dd = jnp.where(back != 0, jnp.abs(det), det)
            inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
            bx, by, bz = ox - v0x, oy - v0y, oz - v0z
            u = (bx * px + by * py + bz * pz) * inv_det
            # qvec = b x e1
            qx = by * e1z - bz * e1y
            qy = bz * e1x - bx * e1z
            qz = bx * e1y - by * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            ok = (is_leaf & (dd > DET_EPS) & (u >= 0.0) & (u <= 1.0)
                  & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < best_t))
            best_t = jnp.where(ok, t, best_t)
            best_i = jnp.where(ok, ti, best_i)

        nxt = jnp.where(box_hit & (leaf_start < 0), hit_ref[nidx],
                        miss_ref[nidx])
        return jnp.where(active, nxt, node), best_t, best_i

    node0 = jnp.zeros(ox.shape, jnp.int32)
    _, best_t, best_i = lax.while_loop(
        cond, body, (node0, tmax_ref[...], jnp.full(ox.shape, -1, jnp.int32)))
    t_out[...] = best_t
    i_out[...] = best_i


@functools.partial(jax.jit, static_argnames=("interpret",))
def _walk(bvh_min, bvh_max, hit_link, miss_link, leaf_start, v0, e1, e2,
          hit_back, org, dirn, t_min, t_max, *, interpret: bool):
    n = org.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    f32 = jnp.float32

    def lanes(x, fill):
        x = x.astype(f32)
        return jnp.pad(x, (0, n_pad - n), constant_values=fill)

    # padded lanes get t_max = 0: they leave the tree at the root
    rays = [lanes(org[:, c], 0.0) for c in range(3)]
    rays += [lanes(dirn[:, c], 1.0) for c in range(3)]
    rays += [lanes(t_min, 0.0), lanes(t_max, 0.0)]
    tables = [
        bvh_min.astype(f32).reshape(-1), bvh_max.astype(f32).reshape(-1),
        hit_link, miss_link, leaf_start,
        v0.astype(f32).reshape(-1), e1.astype(f32).reshape(-1),
        e2.astype(f32).reshape(-1), hit_back.astype(jnp.int32),
    ]
    lane_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    t, idx = pl.pallas_call(
        functools.partial(_kernel, n_nodes=bvh_min.shape[0],
                          leaf_size=bvh_builder.LEAF_SIZE),
        grid=(n_pad // BLOCK,),
        in_specs=[lane_spec] * 8 + [pl.no_block_spec] * len(tables),
        out_specs=[lane_spec, lane_spec],
        out_shape=[jax.ShapeDtypeStruct((n_pad,), f32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32)],
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS,
                                            num_stages=1),
        interpret=interpret,
        name="bvh_walk",
    )(*rays, *tables)
    return t[:n].astype(org.dtype), idx[:n]


def walk_triangles(pack, org, dirn, t_min, t_max, interpret: bool = False):
    """Closest triangle hit of each ray through the Triton kernel: (t, slot),
    with t = t_max and slot = -1 on a miss (the jnp walk's contract).

    The kernel compiles only for an NVIDIA GPU; `interpret=True` runs it
    through the Pallas interpreter on any backend (tests)."""
    return call_detached(
        functools.partial(_walk, interpret=interpret),
        pack.bvh_min, pack.bvh_max, pack.bvh_hit_link, pack.bvh_miss_link,
        pack.bvh_leaf_start, pack.tri_v0, pack.tri_e1, pack.tri_e2,
        pack.tri_hit_back, org, dirn, t_min, t_max,
    )


def intersect_triangles_gpu(pack, org, dirn, t_min, t_max,
                            interpret: bool = False):
    """Explicit request for the kernel: raises unless the default backend is
    a GPU or `interpret=True`."""
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the Triton BVH walk compiles only for a GPU (default backend is "
            f"{jax.default_backend()!r}); pass interpret=True to run it in "
            "the Pallas interpreter")
    return walk_triangles(pack, org, dirn, t_min, t_max, interpret=interpret)

"""Wavefront path-tracing integrator.

The reference's recursive `Camera::ray_color` (camera.rs:282-332) becomes an
iterative loop over bounce depth on an SoA ray state — the standard
wavefront transform for throughput-oriented hardware.  The per-vertex
estimator is identical (one-sample NEE mixture):

  radiance += throughput * emission(vertex)
  throughput *= attenuation * scattering_pdf / mix_pdf     (diffuse family)
  throughput *= attenuation                                 (specular family)

Control flow is `lax.fori_loop` over a static max_depth with masked lanes —
differentiable (reverse-mode unrolls the bounded loop) and XLA-friendly.

Between bounces the wavefront is COMPACTED AND SORTED: lanes are reordered
by (dead-last, direction octant, position Morton code).  Dead lanes pack
into the tail, where the traversal leaves the BVH at the root, and live
lanes that sit next to each other walk similar nodes.  Because the
RNG streams are keyed by the (pixel, sample) ids that travel with each
lane (core/rng.py), reordering never changes a single sample — images are
bit-identical with compaction on or off, and across any sharding.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core import rng as vrng
from ..ops import intersect as isect
from ..ops import shade as shd
from ..ops import texture as tex
from ..scene import pack as sp
from ..scene.compiler import SceneStatic

# Minimum hit distance (reference: camera.rs:294 Interval(0.001, INF)).
T_MIN = 1e-3


def _expand_bits8(v):
    """Spread the low 8 bits of v to every 3rd bit (Morton interleave)."""
    v = (v | (v << jnp.uint32(16))) & jnp.uint32(0x030000FF)
    v = (v | (v << jnp.uint32(8))) & jnp.uint32(0x0300F00F)
    v = (v | (v << jnp.uint32(4))) & jnp.uint32(0x030C30C3)
    v = (v | (v << jnp.uint32(2))) & jnp.uint32(0x09249249)
    return v


def _compaction_key(org, dirn, alive, dir_bits: int = 3):
    """Sort key: dead lanes last; live lanes grouped by direction octant,
    then 2*dir_bits of finer direction quantization (L1-normalized |x|,|y|
    magnitudes), then a Morton code of the origin (normalized to this
    wavefront's bounding box).

    Finer direction binning groups bounce rays that walk similar BVH
    nodes."""
    u32 = jnp.uint32
    dead = jnp.where(alive, u32(0), u32(1))
    octant = (
        (dirn[:, 0] < 0).astype(u32) * u32(4)
        + (dirn[:, 1] < 0).astype(u32) * u32(2)
        + (dirn[:, 2] < 0).astype(u32)
    )
    lo = jnp.min(org, axis=0)
    span = jnp.maximum(jnp.max(org, axis=0) - lo, 1e-20)
    q = jnp.clip((org - lo) / span * 255.0, 0.0, 255.0).astype(u32)
    morton = (
        (_expand_bits8(q[:, 0]) << u32(2))
        | (_expand_bits8(q[:, 1]) << u32(1))
        | _expand_bits8(q[:, 2])
    )
    # layout (high to low): dead(1) | octant(3) | dir(2*dir_bits) | morton
    key = (dead << u32(31)) | (octant << u32(28))
    if dir_bits > 0:
        a = jnp.abs(dirn)
        a = a / jnp.maximum(jnp.sum(a, axis=1, keepdims=True), 1e-20)
        top = u32((1 << dir_bits) - 1)
        qx = jnp.clip((a[:, 0] * top).astype(u32), 0, top)
        qy = jnp.clip((a[:, 1] * top).astype(u32), 0, top)
        shift = 28 - 2 * dir_bits
        key |= (qx << u32(shift + dir_bits)) | (qy << u32(shift))
        key |= morton >> u32(24 - shift)
    else:
        key |= morton
    return key


def shade_vertex(pack, static, org, dirn, ctx, light_bias, alive,
                 kernel: str = "auto"):
    """One path-vertex evaluation shared by the bounded-loop integrator and
    the persistent ray pool (render/pool.py): closest hit, texture program,
    NEE-mixture shading, miss -> background.

    Returns (emission, weight, new_dir, ended, pos):
      emission (N, 3) — radiance emitted at this vertex (background on miss)
      weight   (N, 3) — throughput multiplier for the next segment
      new_dir  (N, 3) — next ray direction
      ended    (N,)   — path terminates at this vertex (miss/absorb/emissive)
      pos      (N, 3) — hit position (next ray origin)
    """
    hit = isect.intersect(pack, org, dirn, T_MIN, ctx, alive=alive,
                          kernel=kernel)
    # detach traversal decisions (ids + raw t); hit_attributes recomputes
    # t differentiably, keeping the BVH while_loop out of the AD graph
    hit = jax.tree_util.tree_map(lax.stop_gradient, hit)
    # name the hits so the differentiable trace's remat policy can SAVE
    # them: (t, kind, prim) is 12 bytes/lane/bounce, and with them saved
    # the backward sweep's recompute dead-code-eliminates the whole
    # traversal instead of re-running it
    # (f32 only: checkpoint_name lowers through a reduce_precision op
    # that the f64 validation path cannot compile; the f64 oracle just
    # falls back to full remat)
    if org.dtype == jnp.float32:
        from jax.ad_checkpoint import checkpoint_name

        hit = jax.tree_util.tree_map(
            lambda x: checkpoint_name(x, "traversal_hits"), hit)
    attr = isect.hit_attributes(pack, org, dirn, hit)

    tex_values = tex.eval_program(
        static.tex_program, pack.tex_data, attr.uv, attr.pos,
        tex_const=pack.tex_const,
    )
    res = shd.shade(
        pack, static.light_list, tex_values, org, dirn, hit, attr,
        ctx, light_bias,
    )

    # miss -> background (camera.rs:331), then terminate
    miss = ~attr.valid
    emission = jnp.where(miss[:, None], pack.background[None, :], res.emission)
    ended = res.terminate | miss
    return emission, res.weight, res.new_dir, ended, attr.pos


def trace(
    pack: sp.ScenePack,
    static: SceneStatic,
    org,
    dirn,
    rng_ctx: vrng.Ctx,
    max_depth: int,
    light_bias: float,
    compact: bool = True,
    differentiable: bool = False,
    kernel: str = "auto",
    remat: str = "hits",
):
    """Trace a batch of rays to completion; returns (N, 3) radiance in the
    caller's lane order.

    differentiable=False (rendering): the bounce loop is a lax.while_loop
    with an all-dead early exit — XLA compiles the body once (vs unrolling
    the bounded fori_loop) and late bounces cost nothing once the wavefront
    dies.  differentiable=True (training/grad tests): a bounded scan,
    reverse-mode differentiable.  Both run the identical body, so images
    are bit-identical.

    remat (differentiable mode only) trades backward-sweep recompute for
    residual memory, all numerically identical:
      "full" — jax.checkpoint per bounce: O(1-bounce) memory, the bounce
               (traversal included) re-runs in the backward sweep.
      "hits" — (default) additionally saves the named traversal hits
               (12 B/lane/bounce): the recompute dead-code-eliminates
               the traversal kernels.
      "none" — no checkpoint: the scan saves every bounce's residuals
               (~ lanes x depth x O(100 B)); no recompute at all.
    """
    n = org.shape[0]
    dtype = org.dtype

    pixel0 = jnp.asarray(rng_ctx.pixel, jnp.uint32)
    sample0 = jnp.asarray(rng_ctx.sample, jnp.uint32)
    seed = rng_ctx.seed

    def bounce_body(depth, state):
        org, dirn, throughput, radiance, alive, pixel, sample, src = state

        if compact:
            perm = jnp.argsort(_compaction_key(org, dirn, alive))
            org, dirn = org[perm], dirn[perm]
            throughput, radiance = throughput[perm], radiance[perm]
            alive, src = alive[perm], src[perm]
            pixel, sample = pixel[perm], sample[perm]

        ctx = vrng.Ctx(pixel=pixel, sample=sample, bounce=depth, seed=seed)

        emission, weight, next_dir, ended, pos = shade_vertex(
            pack, static, org, dirn, ctx, light_bias, alive, kernel=kernel
        )

        radiance = radiance + throughput * emission * alive[:, None]
        throughput = throughput * jnp.where(alive[:, None], weight, 0.0)
        alive = alive & ~ended
        # keep dead lanes numerically inert
        new_org = jnp.where(alive[:, None], pos, org)
        new_dir = jnp.where(alive[:, None], next_dir, dirn)
        return (new_org, new_dir, throughput, radiance, alive, pixel,
                sample, src)

    state = (
        org,
        dirn,
        jnp.ones((n, 3), dtype),
        jnp.zeros((n, 3), dtype),
        jnp.ones((n,), bool),
        pixel0,
        sample0,
        jnp.arange(n, dtype=jnp.int32),
    )
    # depth-0 black cutoff (camera.rs:290-292) is implicit: the loop simply
    # stops contributing after max_depth scatters.
    if differentiable:
        if remat == "none":
            body = bounce_body
        elif remat == "hits":
            # remat each bounce, but save the named traversal hits
            # (12 B/lane/bounce): the backward sweep's recompute then
            # dead-code-eliminates the traversal kernels — they are
            # detached (zero cotangents) and their outputs fully
            # determine the rest of the bounce.
            body = jax.checkpoint(
                bounce_body,
                policy=jax.checkpoint_policies.save_only_these_names(
                    "traversal_hits"),
            )
        else:
            # O(1-bounce) residual memory, 2x bounce FLOPs — the
            # standard remat trade
            body = jax.checkpoint(bounce_body)

        def scan_body(st, depth):
            return body(depth, st), None

        state, _ = lax.scan(
            scan_body, state,
            jnp.arange(max_depth, dtype=jnp.uint32))
    else:
        def w_cond(c):
            depth, state = c
            return (depth < max_depth) & jnp.any(state[4])

        def w_body(c):
            depth, state = c
            return depth + 1, bounce_body(depth, state)

        _, state = lax.while_loop(w_cond, w_body, (jnp.uint32(0), state))
    radiance, src = state[3], state[7]
    if compact:
        # scatter back to the caller's lane order
        radiance = jnp.zeros((n, 3), dtype).at[src].set(radiance)
    return radiance

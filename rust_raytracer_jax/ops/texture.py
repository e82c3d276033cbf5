"""Texture DAG evaluation on device.

The reference composes `Arc<dyn Sampler>` trait objects into a DAG
(reference: src/texture.rs, src/texture/*).  Here a scene's texture
graph is compiled host-side into a *static* topologically-ordered program of
`TexNode`s (scene/compiler.py).  At trace time we unroll the program: every
node is evaluated for all N shading points at once, producing a value stack
of shape (num_nodes, N, 3).  Per-ray texture lookups then become a single
gather over the node axis — no divergence, no dynamic dispatch.

Scalar (f64-typed in the reference) textures are carried as vec3 with the
value broadcast; scalar consumers read channel 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp

# Node type ids (static, host-side)
CONSTANT = 0
CHECKER = 1          # UV-space checkerboard (texture/checkerboard.rs:34-44)
CHECKER_SOLID = 2    # world-space checkerboard (texture/checkerboard.rs:74-85)
IMAGE = 3            # nearest-neighbor image sample (texture/image.rs:40-53)
LERP = 4             # interpolate two textures by a third (texture/interpolate.rs)
NOISE_SOLID = 5      # turbulence perlin + marble map (texture/noise.rs)
CHANNEL = 6          # extract one channel as scalar (texture/channel.rs)
UV_DEBUG = 7         # (u, v, 0.5) (texture/uv_debug.rs)

REPEAT = 0
CLAMP = 1


@dataclasses.dataclass(frozen=True)
class TexNode:
    """One static node of a compiled texture program.

    `children` index earlier nodes in the program; `data_idx` indexes the
    scene pack's `tex_data` tuple (image pixels / perlin tables).
    """
    kind: int
    value: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # CONSTANT value
    children: Tuple[int, ...] = ()
    scale: float = 1.0            # CHECKER*/NOISE scale
    data_idx: int = -1            # IMAGE pixels or NOISE perlin-table base
    repeat: int = REPEAT          # IMAGE wrap mode
    channel: int = 0              # CHANNEL selector
    samples: int = 7              # NOISE turbulence octaves
    noise_map: str = "marble"     # NOISE post-map: "marble" | "turbulence"
    is_scalar: bool = False       # float-typed in the reference's type system


def perlin_sample(p, grad_vecs, perm_x, perm_y, perm_z):
    """Classic Perlin noise, batched over points p (N, 3).

    Mirrors the reference's algorithm (noise/perlin.rs:80-113): 256 random
    unit gradients addressed by XOR of three permutation tables, smoothstep
    trilinear interpolation of corner-gradient dot products.
    """
    pf = jnp.floor(p)
    uvw = p - pf
    ijk = pf.astype(jnp.int32)

    s = uvw * uvw * (3.0 - 2.0 * uvw)  # smoothstep weights

    acc = jnp.zeros(p.shape[:-1], p.dtype)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                ix = (ijk[..., 0] + di) & 255
                iy = (ijk[..., 1] + dj) & 255
                iz = (ijk[..., 2] + dk) & 255
                gidx = perm_x[ix] ^ perm_y[iy] ^ perm_z[iz]
                g = grad_vecs[gidx]  # (..., 3) gather
                weight_vec = uvw - jnp.array([di, dj, dk], p.dtype)
                w = (
                    (di * s[..., 0] + (1 - di) * (1.0 - s[..., 0]))
                    * (dj * s[..., 1] + (1 - dj) * (1.0 - s[..., 1]))
                    * (dk * s[..., 2] + (1 - dk) * (1.0 - s[..., 2]))
                )
                acc = acc + w * jnp.sum(g * weight_vec, axis=-1)
    return acc


def perlin_turbulence(p, samples, grad_vecs, perm_x, perm_y, perm_z):
    """fBm turbulence |sum w_i * noise(2^i p)| (reference: perlin.rs:101-113)."""
    acc = jnp.zeros(p.shape[:-1], p.dtype)
    weight = 1.0
    pp = p
    for _ in range(samples):
        acc = acc + weight * perlin_sample(pp, grad_vecs, perm_x, perm_y, perm_z)
        weight *= 0.5
        pp = pp * 2.0
    return jnp.abs(acc)


def _sample_image(pixels, u, v, repeat):
    """Nearest-neighbor image lookup (reference: texture/image.rs:40-53)."""
    if repeat == CLAMP:
        u = jnp.clip(u, 0.0, 1.0)
        v = jnp.clip(v, 0.0, 1.0)
    else:
        u = u - jnp.floor(u)
        v = v - jnp.floor(v)
    h, w = pixels.shape[0], pixels.shape[1]
    x = (u * (w - 0.001)).astype(jnp.int32)
    y = (v * (h - 0.001)).astype(jnp.int32)
    return pixels[y, x]


def eval_program(program, tex_data, uv, pos, tex_const=None):
    """Evaluate all texture nodes for all shading points.

    Args:
      program: tuple of TexNode (static, topologically ordered).
      tex_data: tuple of arrays referenced by data_idx (dynamic pytree leaves).
      uv: (N, 2) texture coordinates.
      pos: (N, 3) world-space positions.
      tex_const: optional (num_nodes, 3) dynamic CONSTANT values (row i =
        program node i).  When given, constants are differentiable scene
        parameters; otherwise the static node.value is baked in.

    Returns:
      (num_nodes, N, 3) value stack.  Use `gather_values` to pick per-ray.
    """
    n = uv.shape[0]
    dtype = pos.dtype
    values = []
    for i, node in enumerate(program):
        if node.kind == CONSTANT:
            if tex_const is not None:
                val = jnp.broadcast_to(tex_const[i].astype(dtype), (n, 3))
            else:
                val = jnp.broadcast_to(jnp.asarray(node.value, dtype), (n, 3))
        elif node.kind == CHECKER:
            # iu = (u * 2 / scale) as u32 — rust `as u32` truncates toward 0
            # and saturates negatives to 0; match with clip+trunc.  The upper
            # clip must be a float (2**31 as a Python int overflows the i32
            # weak-type lattice); 2^31 is plenty for uv checkers.
            iu = jnp.clip(uv[..., 0] * 2.0 / node.scale, 0.0, 2.0**31).astype(jnp.uint32)
            iv = jnp.clip(uv[..., 1] * 2.0 / node.scale, 0.0, 2.0**31).astype(jnp.uint32)
            even = ((iu + iv) % 2 == 0)[..., None]
            val = jnp.where(even, values[node.children[0]], values[node.children[1]])
        elif node.kind == CHECKER_SOLID:
            ixyz = jnp.floor(pos / node.scale).astype(jnp.int32)
            even = (jnp.sum(ixyz, axis=-1) % 2 == 0)[..., None]
            val = jnp.where(even, values[node.children[0]], values[node.children[1]])
        elif node.kind == IMAGE:
            val = _sample_image(tex_data[node.data_idx], uv[..., 0], uv[..., 1], node.repeat)
        elif node.kind == LERP:
            t = values[node.children[2]][..., 0:1]
            a = values[node.children[0]]
            b = values[node.children[1]]
            val = a * (1.0 - t) + b * t
        elif node.kind == NOISE_SOLID:
            grad = tex_data[node.data_idx]
            px = tex_data[node.data_idx + 1]
            py = tex_data[node.data_idx + 2]
            pz = tex_data[node.data_idx + 3]
            p_scaled = pos * node.scale
            turb = perlin_turbulence(p_scaled, node.samples, grad, px, py, pz)
            if node.noise_map == "marble":
                s = 0.5 * (1.0 + jnp.sin(p_scaled[..., 2] + 10.0 * turb))
            else:
                s = turb
            val = jnp.broadcast_to(s[..., None], (n, 3))
        elif node.kind == CHANNEL:
            c = values[node.children[0]][..., node.channel : node.channel + 1]
            val = jnp.broadcast_to(c, (n, 3))
        elif node.kind == UV_DEBUG:
            val = jnp.stack(
                [uv[..., 0], uv[..., 1], jnp.full((n,), 0.5, dtype)], axis=-1
            )
        else:
            raise ValueError(f"unknown texture node kind {node.kind}")
        values.append(val.astype(dtype))
    if not values:
        return jnp.zeros((1, n, 3), dtype)
    return jnp.stack(values, axis=0)


def gather_values(value_stack, tex_ids):
    """Pick per-ray texture values: (T, N, 3)[tex_ids[n], n] -> (N, 3)."""
    return jnp.take_along_axis(
        value_stack, tex_ids[None, :, None].astype(jnp.int32), axis=0
    )[0]

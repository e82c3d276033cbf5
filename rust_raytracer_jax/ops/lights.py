"""Light-sampling PDFs for next-event-estimation mixtures.

The reference's `HittablePDF` wraps the scene's lights list and delegates to
`Hit::pdf_value` / `Hit::random` per object (reference: pdf/hittable.rs,
object/list.rs:80-100).  Light-samplable objects are spheres, planes, sky and
sun; all four have *analytic* pdf/sample forms, so NEE needs no BVH
traversal — everything here is closed-form vectorized math.

The light list is static per scene (a tuple of (kind, index) pairs from the
compiler), so the loop over lights unrolls at trace time; the per-ray work is
pure elementwise math.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp

from ..core import math as vmath
from ..core import rng
from ..scene import pack as sp
from . import intersect as isect


def _sphere_pdf_value(pack, li, origin, dirn, proxy=False):
    """Solid-angle cone pdf; 0 if the ray misses the sphere
    (reference: sphere.rs:106-121).  proxy=True reads the invisible
    light-only sphere table (assimp.rs:123-129)."""
    if proxy:
        center = pack.lgt_sph_center[li]
        radius = pack.lgt_sph_radius[li]
    else:
        center = pack.sph_center[li]
        radius = pack.sph_radius[li]
    t = isect.sphere_hit_t(
        origin, dirn, center, radius,
        jnp.asarray(1e-3, origin.dtype), jnp.inf,
    )
    hits = jnp.isfinite(t)
    d2 = vmath.length_squared(center - origin)
    # guard: origin inside the sphere would NaN the sqrt (the reference
    # does too, but only evaluates it after a hit test that can still pass)
    cos_theta_max = vmath.safe_sqrt(1.0 - radius * radius / jnp.maximum(d2, 1e-20))
    solid_angle = 2.0 * jnp.pi * (1.0 - cos_theta_max)
    # reciprocal on a masked operand: 1/0 = inf would poison reverse-mode
    # even behind the where (this pdf is live under jax.grad)
    sa_safe = jnp.where(solid_angle > 0, solid_angle, 1.0)
    return jnp.where(hits & (solid_angle > 0), 1.0 / sa_safe, 0.0)


def _sphere_sample(pack, li, origin, rng_ctx, salt, proxy=False):
    """Cone sampling toward the sphere (reference: sphere.rs:123-145)."""
    if proxy:
        center = pack.lgt_sph_center[li]
        radius = pack.lgt_sph_radius[li]
    else:
        center = pack.sph_center[li]
        radius = pack.sph_radius[li]
    to_c = center - origin
    d2 = vmath.length_squared(to_c)
    cos_theta_max = vmath.safe_sqrt(1.0 - radius * radius / jnp.maximum(d2, 1e-20))
    u1, u2, _, _ = rng_ctx.uniform4(rng.Streams.LIGHT_SAMPLE + salt)
    local = vmath.square_to_sphere_cone(u1, u2, cos_theta_max)
    u, v, w = vmath.onb_from_vec(vmath.normalize(to_c, 1e-20))
    return vmath.onb_transform(u, v, w, local)


def _plane_pdf_value(pack, li, origin, dirn):
    """Area-to-solid-angle pdf (reference: plane.rs:107-118)."""
    t, _, _ = isect.plane_hit(
        origin, dirn,
        pack.pln_corner[li], pack.pln_dual_u[li], pack.pln_dual_v[li],
        pack.pln_normal[li], pack.pln_backface[li],
        jnp.asarray(1e-3, origin.dtype), jnp.full(origin.shape[:-1], jnp.inf, origin.dtype),
    )
    hits = jnp.isfinite(t)
    t_safe = jnp.where(hits, t, 1.0)
    dist2 = t_safe * t_safe * vmath.length_squared(dirn)
    # safe_sqrt + masked denominators: this pdf runs live under jax.grad, so
    # 1/0 = inf anywhere here NaN-poisons upstream cotangents via 0*inf.
    dlen = vmath.safe_sqrt(vmath.length_squared(dirn), 1e-20)
    cosine = jnp.abs(vmath.dot(dirn, pack.pln_normal[li])) / dlen
    cos_safe = jnp.where(cosine > 0, cosine, 1.0)
    pdf = dist2 / (cos_safe * pack.pln_area[li])
    return jnp.where(hits & (cosine > 0), pdf, 0.0)


def _plane_sample(pack, li, origin, rng_ctx, salt):
    """Uniform point on the quarter-plane nearest the corner — the
    reference samples only u,v in [0,1) of the *half* vectors
    (plane.rs:120-126); we reproduce that quirk for noise parity."""
    u1, u2, _, _ = rng_ctx.uniform4(rng.Streams.LIGHT_SAMPLE + salt)
    p = (
        pack.pln_corner[li]
        + pack.pln_uhalf[li] * u1[..., None]
        + pack.pln_vhalf[li] * u2[..., None]
    )
    return p - origin


def lights_pdf_value(pack: sp.ScenePack, light_list: Sequence[Tuple[int, int]],
                     origin, dirn):
    """Mean pdf over the lights list (reference: list.rs:80-89)."""
    n = origin.shape[0]
    if not light_list:
        return jnp.zeros((n,), origin.dtype)
    acc = jnp.zeros((n,), origin.dtype)
    for kind, li in light_list:
        if kind == sp.LIGHT_SPHERE:
            acc += _sphere_pdf_value(pack, li, origin, dirn)
        elif kind == sp.LIGHT_PROXY:
            acc += _sphere_pdf_value(pack, li, origin, dirn, proxy=True)
        elif kind == sp.LIGHT_PLANE:
            acc += _plane_pdf_value(pack, li, origin, dirn)
        elif kind == sp.LIGHT_SKY:
            acc += 1.0 / (4.0 * jnp.pi)  # sky.rs:61-63
        elif kind == sp.LIGHT_SUN:
            acc += 1.0  # delta-light convention, sun.rs:70-72
    return acc / len(light_list)


def lights_sample(pack: sp.ScenePack, light_list: Sequence[Tuple[int, int]],
                  origin, rng_ctx):
    """Draw a direction toward a uniformly-picked light
    (reference: list.rs:91-100)."""
    n = origin.shape[0]
    n_lights = len(light_list)
    if n_lights == 0:
        return jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], origin.dtype), (n, 3))
    pick_u = rng_ctx.uniform(rng.Streams.LIGHT_PICK)
    pick = jnp.minimum(
        (pick_u * n_lights).astype(jnp.int32), n_lights - 1
    )
    out = jnp.zeros((n, 3), origin.dtype)
    for slot, (kind, li) in enumerate(light_list):
        if kind == sp.LIGHT_SPHERE:
            d = _sphere_sample(pack, li, origin, rng_ctx, slot)
        elif kind == sp.LIGHT_PROXY:
            d = _sphere_sample(pack, li, origin, rng_ctx, slot, proxy=True)
        elif kind == sp.LIGHT_PLANE:
            d = _plane_sample(pack, li, origin, rng_ctx, slot)
        elif kind == sp.LIGHT_SKY:
            u1, u2, _, _ = rng_ctx.uniform4(rng.Streams.LIGHT_SAMPLE + slot)
            d = vmath.square_to_uniform_sphere(u1, u2)
        elif kind == sp.LIGHT_SUN:
            d = jnp.broadcast_to(pack.sun_dir[li], (n, 3))
        else:
            raise ValueError(f"unknown light kind {kind}")
        out = jnp.where((pick == slot)[:, None], d, out)
    return out

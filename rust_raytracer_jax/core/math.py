"""Vector math core for the wavefront path tracer.

Replaces the reference's Vec4/Mat4 scalar types (reference: src/vec4.rs,
src/mat4.rs, src/utils.rs) with batched jnp operations over arrays of shape
(..., 3).  Everything here is pure, differentiable and shape-polymorphic so it
can run inside jit / shard_map / Pallas alike.

Conventions:
  * Points and vectors are (..., 3) float arrays (the reference's w component
    only ever distinguished point/vec; we drop it).
  * All ops broadcast; scalars are (...,) arrays.
"""
from __future__ import annotations

import jax.numpy as jnp

EPS_NEAR_ZERO = 1e-8


def dot(a, b):
    """Batched 3-vector dot product (reference: vec4.rs:109-111)."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Batched 3-vector cross product (reference: vec4.rs:113-120)."""
    return jnp.cross(a, b)


def length_squared(a):
    return jnp.sum(a * a, axis=-1)


def length(a):
    return jnp.sqrt(length_squared(a))


def safe_sqrt(x, eps: float = 1e-20):
    """sqrt with a clamped argument — keeps reverse-mode gradients finite at
    x == 0 (the bare sqrt has an infinite derivative there, which poisons
    `where`-masked lanes with NaN cotangents)."""
    return jnp.sqrt(jnp.maximum(x, eps))


def normalize(a, eps: float = 0.0):
    """Unit vector.  `eps` guards against zero-length (0 keeps exact parity
    with the reference's `to_unit`, vec4.rs:123-125, which divides blindly).
    The clamp sits *inside* the sqrt so gradients stay finite at ||a|| = 0."""
    if eps:
        n = jnp.sqrt(jnp.maximum(length_squared(a), eps * eps))
    else:
        n = length(a)
    return a / n[..., None]


def lerp(a, b, t):
    """Linear interpolation (reference: vec4.rs:127-129)."""
    t = jnp.asarray(t)
    if t.ndim < jnp.asarray(a).ndim:
        t = t[..., None]
    return a * (1.0 - t) + b * t


def reflect(v, n):
    """Mirror reflection about normal n (reference: vec4.rs:135-137)."""
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(unit_v, n, ior_ratio):
    """Snell refraction; assumes `unit_v` normalized (reference: vec4.rs:140-147)."""
    cos_theta = jnp.minimum(1.0, dot(-unit_v, n))
    ior_ratio = jnp.asarray(ior_ratio)
    r_perp = (unit_v + n * cos_theta[..., None]) * ior_ratio[..., None]
    # abs + clamp guard the sqrt against tiny negatives from f32 rounding at
    # grazing incidence (and keep gradients finite); callers gate on TIR
    # before using the result.
    r_par = n * (-safe_sqrt(jnp.abs(1.0 - length_squared(r_perp))))[..., None]
    return r_perp + r_par


def reflectance(cos_theta, ior_ratio):
    """Schlick's approximation (reference: utils.rs:31-36)."""
    r0 = (1.0 - ior_ratio) / (1.0 + ior_ratio)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5


def onb_from_vec(w):
    """Build an orthonormal basis with w as local z (reference: utils.rs:17-28).

    Returns (u, v, w) each of shape (..., 3).  `w` is assumed unit length.
    """
    a = jnp.where(
        (jnp.abs(w[..., 0]) > 0.9)[..., None],
        jnp.array([0.0, 1.0, 0.0], dtype=w.dtype),
        jnp.array([1.0, 0.0, 0.0], dtype=w.dtype),
    )
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v, w


def onb_transform(u, v, w, local):
    """Apply the ONB (columns u, v, w) to a local-space vector."""
    return (
        u * local[..., 0:1] + v * local[..., 1:2] + w * local[..., 2:3]
    )


def near_zero(a):
    """True where all components are ~0 (reference: vec4.rs:131-133)."""
    return jnp.all(jnp.abs(a) < EPS_NEAR_ZERO, axis=-1)


def deg_to_rad(degrees):
    return degrees / 180.0 * jnp.pi


# ---------------------------------------------------------------------------
# Counter-based sampling primitives (replace reference's rand_distr samplers,
# vec4.rs:27-61, with deterministic uniforms-in / direction-out transforms).
# ---------------------------------------------------------------------------


def square_to_unit_circle(u1, u2):
    """Uniform point on the unit circle rim.

    Parity note: the reference's `random_in_unit_disk` (vec4.rs:35-40)
    normalizes a 2D Gaussian, which actually yields the circle *rim*, not the
    disk interior.  We reproduce that behavior (ring bokeh) exactly.
    """
    phi = 2.0 * jnp.pi * u1
    del u2  # reference draws 2 gaussians; angle alone determines the point
    return jnp.stack([jnp.cos(phi), jnp.sin(phi)], axis=-1)


def square_to_uniform_sphere(u1, u2):
    """Uniform direction on the sphere (reference: vec4.rs:42-48)."""
    z = 1.0 - 2.0 * u1
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_cosine_hemisphere(u1, u2):
    """Malley cosine-weighted hemisphere about +z (reference: vec4.rs:50-61)."""
    phi = u1 * 2.0 * jnp.pi
    sqrt_r2 = safe_sqrt(u2)
    x = jnp.cos(phi) * sqrt_r2
    y = jnp.sin(phi) * sqrt_r2
    z = safe_sqrt(1.0 - u2)
    return jnp.stack([x, y, z], axis=-1)


def square_to_sphere_cone(u1, u2, cos_theta_max):
    """Uniform direction in a cone about +z, used for sphere-light sampling
    (reference: sphere.rs:123-145 `random_to_sphere`)."""
    phi = u1 * 2.0 * jnp.pi
    z = 1.0 + u2 * (cos_theta_max - 1.0)
    r = safe_sqrt(1.0 - z * z)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)

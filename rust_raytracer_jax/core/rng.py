"""Counter-based RNG for the wavefront path tracer.

The reference threads a mutable per-thread `Pcg64Mcg` through every call
(reference: camera.rs:208-209), making renders order-dependent and
non-deterministic across runs.  A wavefront needs the opposite: stateless,
order-independent streams so that (a) every lane of a wavefront can draw its
own numbers in parallel and (b) a render is bit-identical regardless of how
the sample grid is sharded across devices.

We key every draw by integer coordinates (pixel/sample counter, bounce,
stream id, lane) and hash with pcg4d [Jarzynski & Olano, "Hash Functions for
GPU Rendering", JCGT 2020] — 32-bit mul/add/xor/shift only, which maps
directly onto 32-bit vector lanes (no 64-bit multiplies needed, unlike
philox).
"""
from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32
# 1/2^32 — converts the top 32 random bits into [0, 1).
_INV_U32 = jnp.float32(2.3283064365386963e-10)


def _pcg4d(a, b, c, d):
    """pcg4d hash: 4 x u32 in, 4 x u32 of white noise out."""
    v0 = a * _U32(1664525) + _U32(1013904223)
    v1 = b * _U32(1664525) + _U32(1013904223)
    v2 = c * _U32(1664525) + _U32(1013904223)
    v3 = d * _U32(1664525) + _U32(1013904223)

    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2

    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)

    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    return v0, v1, v2, v3


def random_bits4(lane, bounce, stream, seed):
    """4 independent u32 streams keyed by (lane, bounce, stream, seed).

    All args broadcast; integer dtypes are cast to uint32.
    """
    a = jnp.asarray(lane).astype(_U32)
    b = jnp.asarray(bounce).astype(_U32)
    c = jnp.asarray(stream).astype(_U32)
    d = jnp.asarray(seed).astype(_U32)
    return _pcg4d(a, b, c, d)


def uniform4(lane, bounce, stream, seed):
    """4 independent uniforms in [0, 1) keyed by integer coordinates."""
    v0, v1, v2, v3 = random_bits4(lane, bounce, stream, seed)
    f = lambda v: v.astype(jnp.float32) * _INV_U32
    return f(v0), f(v1), f(v2), f(v3)


def uniform(lane, bounce, stream, seed):
    """One uniform in [0, 1) keyed by integer coordinates."""
    return uniform4(lane, bounce, stream, seed)[0]


# ---------------------------------------------------------------------------
# Keyed context: the integrator threads a Ctx through every op so each
# decision draws from stream (pixel, sample, bounce*STREAM_STRIDE + stream,
# seed) — unique per pixel, per sample, per bounce, per decision.
# ---------------------------------------------------------------------------

STREAM_STRIDE = 4096


class Ctx:
    """RNG key context: (pixel lane, sample id, bounce base, seed).

    Registered as a pytree so it can cross jit/scan boundaries.
    """

    __slots__ = ("pixel", "sample", "bounce", "seed")

    def __init__(self, pixel, sample, bounce, seed):
        self.pixel = pixel
        self.sample = sample
        self.bounce = bounce
        self.seed = seed

    def at_bounce(self, bounce):
        return Ctx(self.pixel, self.sample, bounce, self.seed)

    def uniform4(self, stream):
        return uniform4(
            self.pixel,
            self.sample,
            jnp.asarray(self.bounce).astype(_U32) * _U32(STREAM_STRIDE) + _U32(stream),
            self.seed,
        )

    def uniform(self, stream):
        return self.uniform4(stream)[0]

    def gaussian2(self, stream):
        u1, u2, _, _ = self.uniform4(stream)
        u1 = jnp.maximum(u1, 1e-10)
        r = jnp.sqrt(-2.0 * jnp.log(u1))
        theta = 2.0 * jnp.pi * u2
        return r * jnp.cos(theta), r * jnp.sin(theta)

    def gaussian3(self, stream):
        u1, u2, u3, u4 = self.uniform4(stream)
        u1 = jnp.maximum(u1, 1e-10)
        u3 = jnp.maximum(u3, 1e-10)
        r1 = jnp.sqrt(-2.0 * jnp.log(u1))
        r2 = jnp.sqrt(-2.0 * jnp.log(u3))
        t1 = 2.0 * jnp.pi * u2
        t2 = 2.0 * jnp.pi * u4
        return r1 * jnp.cos(t1), r1 * jnp.sin(t1), r2 * jnp.cos(t2)


def _ctx_flatten(c):
    return (c.pixel, c.sample, c.bounce, c.seed), None


def _ctx_unflatten(_, leaves):
    return Ctx(*leaves)


import jax as _jax  # noqa: E402

_jax.tree_util.register_pytree_node(Ctx, _ctx_flatten, _ctx_unflatten)


# Stream ids: every distinct decision in the integrator draws from its own
# stream so adding/removing draws never perturbs unrelated streams.
class Streams:
    PIXEL_JITTER = 0       # stratified sub-pixel jitter (x, y)
    APERTURE = 1           # defocus disk sample
    MIX_CHOICE = 2         # NEE mixture: light vs material pdf
    MAT_SAMPLE = 3         # cosine / uniform-sphere material sample
    LIGHT_PICK = 4         # which light to sample
    LIGHT_SAMPLE = 5       # point/direction sample on the chosen light
    SPECULAR = 6           # metal/glossy fuzz direction (gaussian)
    FRESNEL = 7            # dielectric/glossy reflect-vs-refract coin
    VOLUME = 8             # free-flight distance sampling
    RUSSIAN_ROULETTE = 9   # reserved (reference has no RR)


def gaussian2(lane, bounce, stream, seed):
    """2 standard normals via Box-Muller (for random_unit fuzz directions)."""
    u1, u2, _, _ = uniform4(lane, bounce, stream, seed)
    # Guard log(0).
    u1 = jnp.maximum(u1, 1e-10)
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    theta = 2.0 * jnp.pi * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)


def gaussian3(lane, bounce, stream, seed):
    """3 standard normals (for uniform sphere directions via normalization)."""
    u1, u2, u3, u4 = uniform4(lane, bounce, stream, seed)
    u1 = jnp.maximum(u1, 1e-10)
    u3 = jnp.maximum(u3, 1e-10)
    r1 = jnp.sqrt(-2.0 * jnp.log(u1))
    r2 = jnp.sqrt(-2.0 * jnp.log(u3))
    t1 = 2.0 * jnp.pi * u2
    t2 = 2.0 * jnp.pi * u4
    return r1 * jnp.cos(t1), r1 * jnp.sin(t1), r2 * jnp.cos(t2)

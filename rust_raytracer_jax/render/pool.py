"""Persistent ray-pool renderer: wavefront path tracing with dead-lane
regeneration, single- or multi-device.

The bounded-loop integrator (render/integrator.py) traces a fixed batch of
paths for max_depth bounces; on the cornell benchmark the live fraction
decays 100% -> 70% -> 37% -> 23% -> ... so most of the per-bounce work
(shading, sorting, attribute gathers — dense vector ops that cannot skip
dead lanes) is wasted after a few bounces.

The pool keeps a fixed-size lane array at ~full occupancy instead
(wavefront scheduling with path regeneration, cf. the reference's
thread-pool over samples, camera.rs:189-256 — same estimator, different
schedule): every step advances EVERY lane one bounce; lanes whose path
ends scatter their radiance into the accumulated image and are refilled
with the next un-issued (pixel, sample) id from the global sample grid.
Because the RNG is keyed by (pixel, sample, bounce) (core/rng.py), the
schedule change does not alter a single sample — only the floating-point
order of each pixel's radiance sum differs from the batch renderer.

Multi-device: the lane axis is sharded over a 1-D device mesh with
shard_map (the analog of the reference's thread pool).  Each
shard owns a contiguous slice of the (pixel, sample) job grid and a
private image accumulator — no traffic between devices during tracing (scene
replicated, lanes independent), one accumulator reduction at the end,
exactly the reference's join-and-sum (camera.rs:243-255).  Per-job
radiance is bit-identical to the single-device run (counter-based RNG);
only the per-pixel summation order differs.

All shapes are static: one XLA compilation for the whole render.  The
host loop chains K steps per device round-trip and polls a tiny scalar
(lanes remaining) to decide completion.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..core import rng as vrng
from . import integrator


class PoolState:
    """Pytree of the pool's per-lane state + per-shard image accumulator.

    `accum` is (n_shards, n_pixels, 3) and `next_flat` (n_shards,): shard
    s owns accum[s] and issues jobs from its own contiguous quota of the
    flat (pixel, sample) grid, counted by next_flat[s].  Single-device runs
    are the n_shards=1 special case.
    """

    __slots__ = ("org", "dirn", "throughput", "radiance", "pixel", "sample",
                 "bounce", "active", "accum", "next_flat")

    def __init__(self, org, dirn, throughput, radiance, pixel, sample,
                 bounce, active, accum, next_flat):
        self.org = org
        self.dirn = dirn
        self.throughput = throughput
        self.radiance = radiance
        self.pixel = pixel
        self.sample = sample
        self.bounce = bounce
        self.active = active
        self.accum = accum
        self.next_flat = next_flat


def _flatten(s):
    return (
        (s.org, s.dirn, s.throughput, s.radiance, s.pixel, s.sample,
         s.bounce, s.active, s.accum, s.next_flat),
        None,
    )


jax.tree_util.register_pytree_node(
    PoolState, _flatten, lambda _, l: PoolState(*l)
)


def init_state(n_lanes: int, n_pixels: int, dtype=jnp.float32,
               n_shards: int = 1) -> PoolState:
    return PoolState(
        org=jnp.zeros((n_lanes, 3), dtype),
        dirn=jnp.ones((n_lanes, 3), dtype),
        throughput=jnp.zeros((n_lanes, 3), dtype),
        radiance=jnp.zeros((n_lanes, 3), dtype),
        pixel=jnp.zeros((n_lanes,), jnp.uint32),
        sample=jnp.zeros((n_lanes,), jnp.uint32),
        bounce=jnp.zeros((n_lanes,), jnp.uint32),
        active=jnp.zeros((n_lanes,), bool),
        accum=jnp.zeros((n_shards, n_pixels, 3), dtype),
        next_flat=jnp.zeros((n_shards,), jnp.uint32),
    )


def _shard_quota(shard, n_shards, total):
    """Contiguous balanced partition of [0, total): shard s owns
    [start, start + quota).  uint32-safe (no s*total products)."""
    q = np.uint32(total // n_shards)
    r = np.uint32(total % n_shards)
    extra = jnp.minimum(shard, r).astype(jnp.uint32)
    start = shard.astype(jnp.uint32) * q + extra
    quota = q + (shard < r).astype(jnp.uint32)
    return start, quota


def make_step(pack, static, camera, total: int, spp: int, seed,
              compact: bool = True, kernel: str = "auto",
              mesh=None, axis: str = "dp",
              sort_impl: str = "multisort", scatter_cap: int = None):
    """Build the jitted pool step.  `total` = n_pixels * spp lane-jobs;
    flat job ids are pixel-major (pixel = flat // spp) so consecutive
    refills share pixels — coherent regeneration.

    The step sorts lanes (dead-last compaction key) BEFORE retiring and
    refilling: this step's retirees land in a contiguous tail, so the
    image scatter-add only needs a `scatter_cap`-row tail window (a
    lax.cond falls back to the full-width scatter on the rare step where
    more lanes die than the window holds; 0 = always full width).
    Retirements per steady step are ~N/mean_path.  scatter_cap=None
    auto-sizes the window to n_lanes/4.

    sort_impl: "multisort" (default; one multi-operand lax.sort carrying
    all state columns through the sort network — no random gathers) or
    "argsort" (argsort + gather-apply of each state array).  Both orders
    are identical (stable on the same key).

    With `mesh`, the returned step is shard_map'ed over the lane axis:
    state lanes sharded, ScenePack replicated, each shard issuing from
    its own job-grid slice into its own accum plane.
    """
    w = np.uint32(camera.image_width)
    max_depth = np.uint32(camera.max_depth)
    light_bias = camera.light_bias
    seed = jnp.uint32(seed)
    total = int(total)
    spp_u = np.uint32(spp)
    n_shards = 1 if mesh is None else mesh.devices.size
    if sort_impl == "multisort" and (camera.max_depth >= 256
                                     or spp > (1 << 22)):
        # the packed sort payload holds bounce in 8 bits, sample in 22
        sort_impl = "argsort"

    def step_local(pack, s: PoolState) -> PoolState:
        if mesh is None:
            shard = jnp.uint32(0)
        else:
            shard = lax.axis_index(axis).astype(jnp.uint32)
        job_base, quota = _shard_quota(shard, n_shards, total)
        next_local = s.next_flat[0]
        accum = s.accum[0]

        ctx = vrng.Ctx(pixel=s.pixel, sample=s.sample, bounce=s.bounce,
                       seed=seed)
        emission, weight, new_dir, ended, pos = integrator.shade_vertex(
            pack, static, s.org, s.dirn, ctx, light_bias, s.active,
            kernel=kernel,
        )

        act = s.active[:, None]
        radiance = s.radiance + s.throughput * emission * act
        throughput = s.throughput * jnp.where(act, weight, 0.0)
        bounce = s.bounce + 1
        still = s.active & ~ended & (bounce < max_depth)
        org = jnp.where(still[:, None], pos, s.org)
        dirn = jnp.where(still[:, None], new_dir, s.dirn)
        retired = s.active & ~still
        pixel, sample = s.pixel, s.sample

        # ---- compaction sort, BEFORE retire/refill: dead lanes (incl.
        # this step's retirees) pack into the tail; surviving lanes
        # regain spatial coherence; the refill below then issues its
        # pixel-major (coherent) camera rays into that same tail ----
        if compact:
            key = integrator._compaction_key(org, dirn, still)
            if sort_impl == "multisort":
                # sample/bounce/flags ride the sort packed in one u32
                # (sample < 2^22, bounce < 2^8): three fewer payload
                # columns through the sort network
                aux = ((sample << jnp.uint32(10))
                       | (bounce << jnp.uint32(2))
                       | (still.astype(jnp.uint32) << jnp.uint32(1))
                       | retired.astype(jnp.uint32))
                ops = lax.sort(
                    (key, org[:, 0], org[:, 1], org[:, 2],
                     dirn[:, 0], dirn[:, 1], dirn[:, 2],
                     throughput[:, 0], throughput[:, 1], throughput[:, 2],
                     radiance[:, 0], radiance[:, 1], radiance[:, 2],
                     pixel, aux),
                    num_keys=1,
                )
                org = jnp.stack(ops[1:4], 1)
                dirn = jnp.stack(ops[4:7], 1)
                throughput = jnp.stack(ops[7:10], 1)
                radiance = jnp.stack(ops[10:13], 1)
                pixel, aux = ops[13:]
                sample = aux >> jnp.uint32(10)
                bounce = (aux >> jnp.uint32(2)) & jnp.uint32(0xFF)
                still = ((aux >> jnp.uint32(1)) & jnp.uint32(1)).astype(bool)
                retired = (aux & jnp.uint32(1)).astype(bool)
            else:
                perm = jnp.argsort(key)
                org, dirn = org[perm], dirn[perm]
                throughput, radiance = throughput[perm], radiance[perm]
                pixel, sample = pixel[perm], sample[perm]
                bounce = bounce[perm]
                still, retired = still[perm], retired[perm]

        # ---- retire finished paths into this shard's accumulator ----
        n_lanes = org.shape[0]
        n_dead = jnp.sum((~still).astype(jnp.uint32))
        oob = jnp.uint32(accum.shape[0])  # mode="drop" discards these

        def _scatter(acc, idx_pix, ret, rad):
            return acc.at[jnp.where(ret, idx_pix, oob)].add(
                jnp.where(ret[:, None], rad, 0.0), mode="drop")

        cap = n_lanes // 4 if scatter_cap is None else int(scatter_cap)
        if compact and 0 < cap < n_lanes:
            accum = lax.cond(
                n_dead <= jnp.uint32(cap),
                lambda acc: _scatter(acc, pixel[-cap:], retired[-cap:],
                                     radiance[-cap:]),
                lambda acc: _scatter(acc, pixel, retired, radiance),
                accum,
            )
        else:
            accum = _scatter(accum, pixel, retired, radiance)

        # ---- refill dead lanes with the next un-issued (pixel, sample)
        # jobs from this shard's quota ----
        dead = ~still
        rank = jnp.cumsum(dead.astype(jnp.uint32)) - 1
        new_local = next_local + rank
        issue = dead & (new_local < quota)
        new_flat = job_base + new_local
        pix = new_flat // spp_u
        smp = new_flat % spp_u
        px = pix % w
        py = pix // w
        ctx0 = vrng.Ctx(pixel=pix, sample=smp, bounce=jnp.uint32(0),
                        seed=seed)
        g_org, g_dir = camera.generate_rays(px, py, smp, ctx0, s.org.dtype)

        iss = issue[:, None]
        org = jnp.where(iss, g_org, org)
        dirn = jnp.where(iss, g_dir, dirn)
        throughput = jnp.where(iss, 1.0, throughput)
        radiance = jnp.where(iss | retired[:, None], 0.0, radiance)
        pixel = jnp.where(issue, pix, pixel)
        sample = jnp.where(issue, smp, sample)
        bounce = jnp.where(issue, jnp.uint32(0), bounce)
        active = still | issue
        next_local = jnp.minimum(next_local + n_dead, quota)

        return PoolState(org=org, dirn=dirn, throughput=throughput,
                         radiance=radiance, pixel=pixel, sample=sample,
                         bounce=bounce, active=active,
                         accum=accum[None], next_flat=next_local[None])

    if mesh is None:
        return jax.jit(step_local, donate_argnums=(1,))

    lane = P(axis)
    state_spec = PoolState(
        org=lane, dirn=lane, throughput=lane, radiance=lane, pixel=lane,
        sample=lane, bounce=lane, active=lane, accum=P(axis),
        next_flat=P(axis),
    )
    sharded = jax.shard_map(
        step_local, mesh=mesh,
        in_specs=(P(), state_spec), out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(1,))


def render_pool(pack, static, camera, n_pixels: int, spp: int,
                n_lanes: int, seed=0, dtype=jnp.float32,
                steps_per_poll: int = 10, progress=None,
                kernel: str = "auto", metrics=None,
                mesh=None, axis: str = "dp"):
    """Render n_pixels * spp samples through a persistent pool of n_lanes.

    Returns the (n_pixels, 3) radiance sum (divide by spp for the mean).
    `progress`, if given, is called with (issued, total) after each poll.
    `metrics`, if given, is a utils.metrics.RenderMetrics that records
    per-poll occupancy and throughput counters.
    `mesh`, if given, shards the lane axis over its devices (n_lanes must
    be a multiple of the device count).
    """
    total = n_pixels * spp
    n_shards = 1 if mesh is None else mesh.devices.size
    if n_lanes % n_shards:
        raise ValueError(f"n_lanes {n_lanes} not divisible by {n_shards} devices")
    state = init_state(n_lanes, n_pixels, dtype, n_shards=n_shards)
    if mesh is not None:
        # place the initial state with the step's OUTPUT sharding (every
        # leaf is leading-axis sharded over the lane mesh): buffer
        # donation can only alias input->output when the shardings agree,
        # and without this the donated state was unusable — every step
        # paid a device copy of the whole lane state.
        from jax.sharding import NamedSharding

        state = jax.device_put(state, NamedSharding(mesh, P(axis)))
        # replicate the scene once: a pack left on one device would be
        # copied to every device again by each step
        pack = jax.device_put(pack, NamedSharding(mesh, P()))
    step = make_step(pack, static, camera, total, spp, seed, kernel=kernel,
                     mesh=mesh, axis=axis)

    # Upper bound on steps, for safety against scheduling bugs: every
    # lane-job takes <= max_depth steps (sharding skew adds a few polls).
    max_steps = ((total * camera.max_depth) // n_lanes
                 + 2 * camera.max_depth * n_shards)

    done_steps = 0
    while done_steps < max_steps:
        for _ in range(steps_per_poll):
            state = step(pack, state)
        done_steps += steps_per_poll
        issued = int(jnp.sum(state.next_flat))
        n_active = int(jnp.sum(state.active.astype(jnp.int32)))
        if metrics is not None:
            # counters are poll-granular: one sample covering
            # steps_per_poll steps at the end-of-poll occupancy
            metrics.record_step(n_active, n_lanes, issued,
                                weight=steps_per_poll)
        if progress is not None:
            progress(issued, total)
        if issued >= total and n_active == 0:
            break
    # reduce the per-shard accumulators (the reference's thread-buffer
    # sum, camera.rs:243-255)
    return jnp.sum(state.accum, axis=0)

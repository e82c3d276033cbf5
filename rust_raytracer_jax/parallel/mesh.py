"""Device-mesh sharding for rendering and training.

The reference's only parallelism is sample-space data parallelism over OS
threads with a final buffer sum (camera.rs:189-256).  Here the same
decomposition becomes: shard the flattened (pixel, sample) lane axis over a
1-D "dp" mesh with shard_map, replicate the ScenePack in every device's
memory, and let the host (or a psum, for fused losses) reduce radiance.
Because the RNG is counter-based on (pixel, sample), any sharding yields
bit-identical radiance per lane — the property the reference lacks
(thread_rng seeding).

Scaling contract: lanes are embarrassingly parallel (no cross-lane ops in
the integrator), so no device talks to another during tracing; gradients
of fused losses all-reduce with a single psum at the end.  The mesh is
1-D because every card of a host reaches every other at the same rate.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, local_device_count: Optional[int] = None):
    """Initialize the multi-host JAX runtime (SURVEY §5: the DCN path the
    reference lacks — its only 'backend' is std::thread + join).

    Each host contributes its local devices and the processes coordinate
    over the network; on CPU (tests / dry runs) each process contributes
    `local_device_count` virtual devices.  After this returns,
    jax.devices() spans every process and `make_mesh()` builds a global
    mesh — psum/all_gather ride whatever transport the platform provides.

    Idempotent per-process: calling twice is a no-op.
    """
    import os

    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={local_device_count}"
            ).strip()
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    """1-D mesh over the first n_devices devices of the default backend
    (all of them when n_devices is None).  Raises when that backend has
    fewer: a mesh never moves to another platform behind the caller."""
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} {jax.default_backend()} devices, have "
                f"{len(devices)}"
            )
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (axis,), devices=devices)


def shard_batch_fn(batch_fn, mesh: Mesh, axis: str = "dp"):
    """Wrap a per-lane batch function (pack, px, py, sample, seed) -> rad
    with shard_map over the lane axis: scene replicated, lanes sharded."""

    sharded = jax.shard_map(
        batch_fn,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(sharded)


def train_step_fn(batch_fn, loss_of_radiance, mesh: Mesh, axis: str = "dp"):
    """Build a sharded differentiable render step: per-shard loss + grads
    w.r.t. the ScenePack, psum-reduced over the mesh (the all-reduce the
    reference's thread-join performs on framebuffers, camera.rs:243-255)."""

    def local_step(pack, px, py, sample, seed, target):
        # differentiate w.r.t. the float leaves only (geometry, materials,
        # textures); integer tables (ids, links) are structure
        float_leaves, treedef = jax.tree_util.tree_flatten(pack)
        is_float = [l.dtype.kind == "f" for l in float_leaves]

        def loss_fn(diff_leaves):
            leaves = []
            di = iter(diff_leaves)
            for leaf, isf in zip(float_leaves, is_float):
                leaves.append(next(di) if isf else leaf)
            p = jax.tree_util.tree_unflatten(treedef, leaves)
            rad = batch_fn(p, px, py, sample, seed)
            return loss_of_radiance(rad, target)

        diff_in = [l for l, isf in zip(float_leaves, is_float) if isf]
        loss, grads = jax.value_and_grad(loss_fn)(diff_in)
        loss = jax.lax.psum(loss, axis)
        grads = jax.lax.psum(grads, axis)
        return loss, grads

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)

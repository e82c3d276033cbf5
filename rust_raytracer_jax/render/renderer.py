"""Render orchestration: batches of pixel-samples through the jitted
integrator, accumulated on a Film.

The reference parallelizes by giving each OS thread the full image at
spp/threads samples and summing buffers (camera.rs:189-256).  Here the
(pixel, sample) grid is flattened and chopped into fixed-size device batches
(static shapes => one XLA compilation); multi-device rendering shards the same
batches over a mesh in parallel/mesh.py.  Because the RNG is keyed by
(pixel, sample), any batching/sharding of the grid produces bit-identical
images.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core import rng as vrng
from ..scene import compiler as scompiler
from ..scene import graph as sgraph
from . import camera as cam
from . import film as filmmod
from . import integrator

# Default number of pixel-samples traced per device dispatch.
DEFAULT_BATCH = 1 << 18


class Renderer:
    def __init__(
        self,
        scene: sgraph.SceneDef,
        camera: cam.Camera,
        seed: int = 0,
        dtype=jnp.float32,
        batch_size: int = DEFAULT_BATCH,
        mesh: Optional[object] = None,
        kernel: str = "auto",
    ):
        """kernel: the triangle traversal, "auto" (the Triton kernel where
        the render compiles for an NVIDIA GPU, the jnp walk elsewhere) or
        "jnp" (always the jnp walk; see ops/intersect.intersect_triangles)."""
        self.camera = camera
        self.seed = seed
        self.dtype = dtype
        self.batch_size = batch_size
        self.mesh = mesh
        self.kernel = kernel
        self.pack, self.static = scompiler.compile_scene(scene, dtype)

        static = self.static
        camera_ref = camera

        def batch_fn(pack, px, py, sample_id, seed):
            ctx = vrng.Ctx(
                pixel=py.astype(jnp.uint32) * np.uint32(camera_ref.image_width)
                + px.astype(jnp.uint32),
                sample=sample_id.astype(jnp.uint32),
                bounce=jnp.uint32(0),
                seed=seed.astype(jnp.uint32),
            )
            org, dirn = camera_ref.generate_rays(px, py, sample_id, ctx, dtype)
            return integrator.trace(
                pack, static, org, dirn, ctx,
                camera_ref.max_depth, camera_ref.light_bias,
                kernel=kernel,
            )

        if mesh is not None:
            from ..parallel import mesh as pmesh

            self._batch_fn = pmesh.shard_batch_fn(batch_fn, mesh)
        else:
            self._batch_fn = jax.jit(batch_fn)

    def render(self, spp: Optional[int] = None, progress: bool = False,
               mode: str = "pool", metrics=None) -> filmmod.Film:
        """Render the full image.

        mode="pool" (default): persistent ray pool with dead-lane
        regeneration (render/pool.py) — every step advances a ~full
        wavefront one bounce, so per-bounce costs are paid only for live
        paths.  mode="batch": the bounded-loop schedule (each batch of
        (pixel, sample) lanes traced to max_depth).  Same estimator and
        RNG streams either way; pixel sums differ only in fp order.
        """
        if mode == "pool":
            return self.render_pool(spp=spp, progress=progress,
                                    metrics=metrics)
        return self.render_batched(spp=spp, progress=progress)

    def render_pool(self, spp: Optional[int] = None,
                    progress: bool = False, metrics=None) -> filmmod.Film:
        from . import pool as poolmod

        camera = self.camera
        w, h = camera.image_width, camera.image_height
        total_spp = camera.actual_spp if spp is None else spp
        n_pixels = w * h
        n_lanes = min(self.batch_size, n_pixels * total_spp)
        if self.mesh is not None:
            n_shards = self.mesh.devices.size
            n_lanes = max(n_shards, n_lanes - n_lanes % n_shards)

        cb = None
        if progress:
            def cb(issued, total):
                print(f"issued {issued}/{total}")

        accum = poolmod.render_pool(
            self.pack, self.static, camera, n_pixels, total_spp,
            n_lanes, seed=self.seed, dtype=self.dtype, progress=cb,
            kernel=self.kernel, metrics=metrics, mesh=self.mesh,
        )
        film = filmmod.Film(w, h)
        film.add_samples(jnp.asarray(accum).reshape(h, w, 3), total_spp)
        return film

    def render_batched(self, spp: Optional[int] = None, progress: bool = False) -> filmmod.Film:
        """Render the full image: the flattened (pixel, sample) grid is
        traced in fixed-size batches (one XLA compilation), radiance summed
        per pixel on device."""
        camera = self.camera
        w, h = camera.image_width, camera.image_height
        total_spp = camera.actual_spp if spp is None else spp
        film = filmmod.Film(w, h)

        n_pixels = w * h
        total = n_pixels * total_spp
        batch = min(self.batch_size, total)
        seed_arr = jnp.uint32(self.seed)

        # Host-side f64 accumulation in lane order: per-channel bincount sums
        # strictly in lane order, which is independent of how the batch was
        # sharded — 1-device, N-device and unsharded renders are
        # BIT-IDENTICAL (the reference's thread-buffer sum, camera.rs:243-255,
        # is the analogous mesh-shape-independent reduction).
        accum = np.zeros((n_pixels, 3), np.float64)
        n_batches = -(-total // batch)
        for bi in range(n_batches):
            start = bi * batch
            # pad the tail batch by wrapping; padded lanes are masked to 0
            flat = (start + np.arange(batch)) % total
            # pixel-major, sample-minor: lanes of a batch mostly share pixels
            pix = flat // total_spp
            smp = flat % total_spp
            px = jnp.asarray(pix % w, jnp.uint32)
            py = jnp.asarray(pix // w, jnp.uint32)
            sample_id = jnp.asarray(smp, jnp.uint32)
            rad = np.array(self._batch_fn(self.pack, px, py, sample_id, seed_arr))
            valid = (start + np.arange(batch)) < total
            rad[~valid] = 0.0
            for c in range(3):
                accum[:, c] += np.bincount(pix, weights=rad[:, c],
                                           minlength=n_pixels)
            if progress:
                print(f"batch {bi + 1}/{n_batches}")
        film.add_samples(accum.reshape(h, w, 3), total_spp)
        return film

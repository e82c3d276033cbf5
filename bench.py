#!/usr/bin/env python
"""Benchmark harness for one NVIDIA GPU.

Measures on the cornell_dragon benchmark (1200x1200, 869,556 generated
triangles: a procedural stand-in for the reference's dragon OBJ):

  1. forward path-tracing throughput through the production render path —
     the persistent ray-pool renderer (render/pool.py), and
  2. forward+backward throughput: one jax.grad step of an image loss
     w.r.t. every float scene parameter (geometry, materials, texture
     constants) through the differentiable integrator.

Prints ONE JSON line; the backward number rides along as extra keys, and
"device"/"card" name what it ran on:

  {"metric": ..., "value": N, "unit": "pixel-samples/s",
   "vs_baseline": N, "fwd_bwd_pixel_samples_per_s": N,
   "device": {"platform", "kind", "count"}, "card": "<name>, <power limit>"}

It fails without a GPU, and every self-check (triangle-walk parity, image
parity, the sharded path) raises on failure.  spp=12 keeps the pool >=90%
occupied.

Baseline: the reference renders cornell_dragon 1200x1200@1000spp in ~41 min
on an M3 Pro with 10 threads ~= 0.59 M pixel-samples/s (BASELINE.md).

Knobs (env): RRT_BENCH_SCENE, RRT_BENCH_WIDTH, RRT_BENCH_SPP,
RRT_BENCH_LANES, RRT_BENCH_DEPTH, RRT_BENCH_SKIP_BWD, RRT_BENCH_SKIP_PARITY,
RRT_BENCH_BWD_REMAT, RRT_BENCH_BWD_DEPTH, RRT_BENCH_BWD_LANES.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_PIXEL_SAMPLES_PER_S = 0.59e6  # BASELINE.md cornell_dragon


def bench_backward(pack, static, camera, n_lanes=1 << 15, depth=20,
                   remat=None):
    """One-sample-per-lane differentiable render step: d(loss)/d(pack)
    for an L2 loss against a target image patch.  Returns
    (pixel-samples/s, rays/s) for the fused forward+backward step.

    remat: integrator.trace residual policy (RRT_BENCH_BWD_REMAT, default
    "hits")."""
    import jax
    import jax.numpy as jnp

    from rust_raytracer_jax.core import rng as vrng
    from rust_raytracer_jax.render import integrator

    if remat is None:
        remat = os.environ.get("RRT_BENCH_BWD_REMAT", "hits")
    w = np.uint32(camera.image_width)
    px = jnp.asarray(np.arange(n_lanes) % camera.image_width, jnp.uint32)
    py = jnp.asarray(
        (np.arange(n_lanes) // camera.image_width) % camera.image_height,
        jnp.uint32,
    )
    sample = jnp.zeros((n_lanes,), jnp.uint32)
    target = jnp.zeros((n_lanes, 3), jnp.float32)

    def loss_fn(pack, seed):
        ctx = vrng.Ctx(pixel=py * w + px, sample=sample,
                       bounce=jnp.uint32(0), seed=seed)
        org, dirn = camera.generate_rays(px, py, sample, ctx, jnp.float32)
        # compact=False: the compaction sort's gathers differentiate to
        # narrow row scatters; the estimator is identical either way
        # (counter-based RNG)
        rad = integrator.trace(pack, static, org, dirn, ctx, depth, 0.25,
                               compact=False, differentiable=True,
                               remat=remat)
        return jnp.mean((rad - target) ** 2)

    grad_fn = jax.jit(jax.grad(loss_fn, allow_int=True))
    g = grad_fn(pack, jnp.uint32(0))  # compile
    jax.block_until_ready(jax.tree_util.tree_leaves(g)[0])
    reps = 3
    t0 = time.time()
    for r in range(reps):
        g = grad_fn(pack, jnp.uint32(r + 1))
    jax.block_until_ready(jax.tree_util.tree_leaves(g)[0])
    dt = (time.time() - t0) / reps
    return n_lanes / dt, n_lanes * depth / dt


def kernel_parity_check(pack, camera, n_rays=1 << 14):
    """Scene-scale triangle-walk cross-check on the bench scene, on
    PRIMARY rays and on an incoherent BOUNCE-like wavefront (origins at
    the primary hit points, pseudo-random directions): the GPU kernel
    (kernel="auto") against the jnp walk.  t-agreement is the
    correctness signal; id ties can legitimately break differently when
    equal-t hits exist.  Raises below 0.999 t-agreement."""
    import jax
    import jax.numpy as jnp

    from rust_raytracer_jax.core import rng as vrng
    from rust_raytracer_jax.ops import intersect as isect

    out = {}
    w = np.uint32(camera.image_width)
    px = jnp.asarray(np.arange(n_rays) * 7 % camera.image_width, jnp.uint32)
    py = jnp.asarray((np.arange(n_rays) * 13 // camera.image_width)
                     % camera.image_height, jnp.uint32)
    smp = jnp.zeros((n_rays,), jnp.uint32)
    ctx = vrng.Ctx(pixel=py * w + px, sample=smp, bounce=jnp.uint32(0),
                   seed=jnp.uint32(0))
    org, dirn = camera.generate_rays(px, py, smp, ctx, jnp.float32)
    t_min = jnp.full((n_rays,), 1e-3, jnp.float32)
    t_max = jnp.full((n_rays,), 3.4e38, jnp.float32)

    def run(org, dirn, tag):
        res = {}
        for kern in ("jnp", "auto"):
            t, i = jax.jit(
                lambda o, d, k=kern: isect.intersect_triangles(
                    pack, o, d, t_min, t_max, kernel=k)
            )(org, dirn)
            res[kern] = (np.asarray(t), np.asarray(i))
        (t0, i0), (t, i) = res["jnp"], res["auto"]
        tt0 = np.where(i0 >= 0, t0, 0.0)
        tt = np.where(i >= 0, t, 0.0)
        t_agree = float(
            (np.abs(tt - tt0) <= 1e-4 + 1e-4 * np.abs(tt0)).mean())
        out[f"{tag}t_agree"] = round(t_agree, 5)
        out[f"{tag}id_agree"] = round(float((i == i0).mean()), 5)
        if t_agree < 0.999:
            raise RuntimeError(f"triangle-walk parity failed: {out}")
        return t0, i0

    t_j, i_j = run(org, dirn, "")
    # bounce-like wavefront: origins at the primary hit points,
    # directions from a seeded generator — incoherent like a real bounce
    t_h = jnp.asarray(np.where(i_j >= 0, t_j, 1.0), jnp.float32)
    org2 = org + dirn * t_h[:, None]
    d2 = np.random.default_rng(0).normal(size=(n_rays, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    run(org2, jnp.asarray(d2), "bounce_")
    return out


def image_parity_check(scene, spp=2, width=200):
    """Scene-scale IMAGE parity of the GPU triangle walk against the jnp
    walk: render the bench scene small with both and compare.  The
    samples are identical (counter-based RNG, same (pixel, sample) grid),
    so a lane's radiance differs only where a traversal decision differed
    somewhere along its path.  Raises on lane agreement below 0.99 or a
    mean relative error above 1e-2."""
    import jax
    import jax.numpy as jnp

    from rust_raytracer_jax.core import rng as vrng
    from rust_raytracer_jax.render import integrator
    from rust_raytracer_jax.render.renderer import Renderer
    from rust_raytracer_jax.utils import config as cfg

    scene_config = cfg.merge_scene_config(scene.config,
                                          {"output_width": width})
    render_cfg = cfg.RenderConfig(samples_per_pixel=spp, max_depth=20)
    cam = cfg.make_camera(scene_config, render_cfg)
    n_pixels = cam.image_width * cam.image_height
    r = Renderer(scene, cam, batch_size=1 << 15)

    chunk = 1 << 16
    total = n_pixels * spp
    n_chunks = -(-total // chunk)
    w = np.uint32(cam.image_width)

    def render(kern):
        fn = jax.jit(
            lambda o, d, c: integrator.trace(
                r.pack, r.static, o, d, c, 20, cam.light_bias, kernel=kern)
        )
        rads = []
        for ci in range(n_chunks):
            flat = (np.arange(chunk, dtype=np.int64) + ci * chunk) % total
            pix = (flat // spp).astype(np.uint32)
            smp = (flat % spp).astype(np.uint32)
            px = jnp.asarray(pix % w)
            py = jnp.asarray(pix // w)
            ctx = vrng.Ctx(pixel=jnp.asarray(pix), sample=jnp.asarray(smp),
                           bounce=jnp.uint32(0), seed=jnp.uint32(0))
            org, dirn = cam.generate_rays(px, py, jnp.asarray(smp), ctx,
                                          jnp.float32)
            rads.append(np.asarray(fn(org, dirn, ctx))[
                :total - ci * chunk if ci == n_chunks - 1 else chunk])
        return np.concatenate(rads, axis=0)

    a = render("auto")
    b = render("jnp")
    scale = max(float(np.mean(b)), 1e-6)
    lane_off = np.any(np.abs(a - b) > 1e-3 * scale + 1e-3 * np.abs(b),
                      axis=-1)
    out = {
        "lane_agree": round(1.0 - float(lane_off.mean()), 6),
        "image_mean_rel_err": round(float(np.mean(np.abs(a - b))) / scale,
                                    6),
        "config": f"{cam.image_width}x{cam.image_height}@{spp}spp d20",
    }
    if out["image_mean_rel_err"] > 1e-2 or out["lane_agree"] < 0.99:
        raise RuntimeError(f"GPU walk radiance departs from the jnp walk: "
                           f"{out}")
    return out


def sharded_smoke(scene):
    """Run the production multi-device path (shard_map over a Mesh) on a
    1-device mesh, so the sharded code path executes on the card once per
    bench.  Raises on a wrong image."""
    import jax
    from jax.sharding import Mesh

    from rust_raytracer_jax.render import pool as poolmod
    from rust_raytracer_jax.render.renderer import Renderer
    from rust_raytracer_jax.utils import config as cfg

    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    scene_config = cfg.merge_scene_config(
        scene.config, {"output_width": 128})
    render_cfg = cfg.RenderConfig(samples_per_pixel=1, max_depth=8)
    cam = cfg.make_camera(scene_config, render_cfg)
    n_pixels = cam.image_width * cam.image_height
    r = Renderer(scene, cam, batch_size=1 << 14)
    accum = poolmod.render_pool(
        r.pack, r.static, cam, n_pixels, 1, 1 << 14, seed=0, mesh=mesh,
    )
    a = np.asarray(accum)
    if not (a.shape == (n_pixels, 3) and np.isfinite(a).all()
            and a.max() > 0):
        raise RuntimeError("sharded pool render produced a wrong image")
    return "ok"


def device_info():
    """The JAX device and the card's name and power limit; raises unless
    the default backend is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return ({"platform": dev.platform, "kind": dev.device_kind,
             "count": len(jax.devices())},
            smi.stdout.strip().splitlines()[0])


def main():
    import jax

    from rust_raytracer_jax import models
    from rust_raytracer_jax.render import pool as poolmod
    from rust_raytracer_jax.render.renderer import Renderer
    from rust_raytracer_jax.utils import config as cfg
    from rust_raytracer_jax.utils import metrics as metricsmod

    device, card = device_info()
    scene_name = os.environ.get("RRT_BENCH_SCENE", "cornell_dragon")
    width = int(os.environ.get("RRT_BENCH_WIDTH", "1200"))
    spp = int(os.environ.get("RRT_BENCH_SPP", "12"))
    n_lanes = int(os.environ.get("RRT_BENCH_LANES", str(1 << 18)))
    max_depth = int(os.environ.get("RRT_BENCH_DEPTH", "20"))

    t0 = time.time()
    scene = models.build(scene_name)
    scene_config = cfg.merge_scene_config(scene.config, {"output_width": width})
    render_cfg = cfg.RenderConfig(samples_per_pixel=spp, max_depth=max_depth)
    camera = cfg.make_camera(scene_config, render_cfg)
    r = Renderer(scene, camera, batch_size=n_lanes)
    build_s = time.time() - t0

    w, h = camera.image_width, camera.image_height
    n_pixels = w * h
    total = n_pixels * spp

    # warmup / compile: one pool step on a throwaway state
    state = poolmod.init_state(n_lanes, n_pixels)
    step = poolmod.make_step(r.pack, r.static, camera, total, spp, 0)
    t0 = time.time()
    state = step(r.pack, state)
    jax.block_until_ready(state.accum)
    compile_s = time.time() - t0
    del state

    metrics = metricsmod.RenderMetrics(
        n_pixels=n_pixels, spp=spp, max_depth=max_depth
    )
    t0 = time.time()
    accum = poolmod.render_pool(
        r.pack, r.static, camera, n_pixels, spp, n_lanes, seed=0,
        metrics=metrics,
    )
    jax.block_until_ready(accum)
    elapsed = time.time() - t0
    metrics.emit(stream=sys.stderr)
    del accum
    msum = metrics.summary()

    value = total / elapsed
    result = {
        "metric": (
            f"pixel-samples/s fwd {scene_name} {w}x{h}@{spp}spp depth={max_depth} "
            f"pool renderer (1 card; scene build {build_s:.1f}s, compile "
            f"{compile_s:.1f}s)"
        ),
        "value": round(value, 1),
        "unit": "pixel-samples/s",
        "vs_baseline": round(value / BASELINE_PIXEL_SAMPLES_PER_S, 3),
        "lane_bounces_per_s": round(msum["rays_per_s"], 1),
        "mean_occupancy_frac": round(msum["mean_occupancy"] / n_lanes, 3),
        "device": device,
        "card": card,
    }

    if not os.environ.get("RRT_BENCH_SKIP_PARITY"):
        result["kernel_parity"] = kernel_parity_check(r.pack, camera)
        result["image_parity"] = image_parity_check(scene)
        result["sharded_smoke"] = sharded_smoke(scene)

    if not os.environ.get("RRT_BENCH_SKIP_BWD"):
        bwd_depth = int(os.environ.get("RRT_BENCH_BWD_DEPTH", "20"))
        bwd_lanes = int(os.environ.get("RRT_BENCH_BWD_LANES", str(1 << 15)))
        t0 = time.time()
        bwd_ps, bwd_rays = bench_backward(
            r.pack, r.static, camera, n_lanes=bwd_lanes, depth=bwd_depth
        )
        result["fwd_bwd_pixel_samples_per_s"] = round(bwd_ps, 1)
        result["fwd_bwd_rays_per_s"] = round(bwd_rays, 1)
        result["fwd_bwd_config"] = (
            f"jax.grad of image loss wrt all float scene params, "
            f"{bwd_lanes} lanes x depth {bwd_depth} "
            f"(compile+run {time.time() - t0:.0f}s)"
        )

    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""End-to-end check of the path tracer on NVIDIA GPUs, through the entry
points a user calls (`Renderer`, the CLI, `parallel.mesh`).

    python chip_smoke.py                 # phases (a)-(d) on one card
    python chip_smoke.py --compare-walk  # also time the (b) render with the
                                         # jnp walk in place of the kernel
    python chip_smoke.py --cards 4       # phase (e) only, on four cards

Phases, all in this one process (a second JAX process could not reserve
the card's memory):
  (a) JAX's devices are GPUs, never a CPU stand-in;
  (b) forward render of cornell_dragon (869,556 generated triangles) at
      1200x1200, depth 20, 4 spp through Renderer(...).render() (pool mode,
      2^18 lanes), then the CLI on the same scene;
  (c) parity on the card: the Triton BVH walk against the jnp walk on 2^16
      primary and 2^16 bounce-like rays of that scene, and `cornell` at
      160 px rendered on the GPU and on the CPU;
  (d) three gradient steps of the differentiable trace on the
      cornell_dragon pack (2^15 lanes, depth 20, L2 loss against a rendered
      target) on a one-card mesh, and a one-step gradient of `test` at
      16 px on the GPU and on the CPU;
  (e) with --cards 4 only: the lane-sharded pool render of the (b) job and
      the sharded train step on a 4-card mesh, against one card.

Any failure raises and the process exits non-zero before the last line,
which is one JSON object: {"ok": true, "device": {platform, kind, count}}.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import jax
import jax.numpy as jnp

WIDTH = 1200
SPP = 4
DEPTH = 20
LANES = 1 << 18
PARITY_RAYS = 1 << 16
GRAD_LANES = 1 << 15
BENCH_TRIANGLES = 869_556

# (c) kernel vs jnp walk: the same arithmetic in another order of
# evaluation; a hit or miss may flip only at grazing edges.
WALK_AGREE_MIN = 0.999
# (c) GPU vs CPU image: identical samples (counter-based RNG), so only f32
# rounding differs (FMA contraction, transcendental implementations, the
# order of sums); a rare path crosses a discrete decision there and the
# pixel's 4-sample mean moves.  TF32 products (10-bit mantissa) would move
# most pixels and fail both bounds.
IMAGE_MEAN_REL_ERR_MAX = 1e-2
PIXEL_AGREE_MIN = 0.99
# (d) GPU vs CPU gradient of `test`: the same rounding argument, on a
# 160-lane gradient (relative L2 over all float leaves).
GRAD_REL_ERR_MAX = 1e-2
# (e) 4 cards vs 1: per-lane radiance is bit-identical; pixel sums differ
# in summation order only.
SHARD_RTOL = 1e-5
# (e) first-step gradients, 4 cards vs 1: the same lanes, summed in another
# order (a psum across cards; atomic scatter-adds in the backward pass,
# whose order changes from run to run) — f32 rounding over sums with
# cancellation, well above one ulp but far below a real departure.
SHARD_GRAD_REL_MAX = 1e-3


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase_device(n_cards):
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's default devices are {devs}")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines()[:n_cards]:
        log(line.strip())
    log(f"(a) devices: {len(devs)} x {devs[0].device_kind}")


def bench_camera(scene, width=None, spp=SPP):
    from rust_raytracer_jax.utils import config as cfg

    scene_config = cfg.merge_scene_config(
        scene.config, {"output_width": width or WIDTH})
    return cfg.make_camera(
        scene_config, cfg.RenderConfig(samples_per_pixel=spp, max_depth=DEPTH))


def real_triangles(pack):
    """Triangle slots that are not degenerate leaf padding."""
    e1, e2 = np.asarray(pack.tri_e1), np.asarray(pack.tri_e2)
    return int(np.count_nonzero(np.any(e1 != 0, 1) | np.any(e2 != 0, 1)))


@contextlib.contextmanager
def fresh_cpu_compiles():
    """Compile the CPU references without the persistent cache: a CPU
    executable cached by another host may use instructions this host's CPU
    lacks (XLA:CPU only warns when it loads one)."""
    from jax._src import compilation_cache

    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", True)
        compilation_cache.reset_cache()


def check_image(hdr, shape, what):
    check(hdr.shape == shape, f"{what}: shape {hdr.shape} != {shape}")
    check(bool(np.isfinite(hdr).all()), f"{what}: non-finite pixels")
    check(float(hdr.mean()) > 0.0, f"{what}: black image")


def timed_render(renderer):
    """Compile the pool step ahead of time (timed), then render twice; the
    second render() call is the one timed: its step comes from the
    persistent compilation cache."""
    from rust_raytracer_jax.render import pool as poolmod

    cam, mesh, pack = renderer.camera, renderer.mesh, renderer.pack
    n_pixels = cam.image_width * cam.image_height
    total = n_pixels * cam.actual_spp
    step = poolmod.make_step(pack, renderer.static, cam, total,
                             cam.actual_spp, renderer.seed,
                             kernel=renderer.kernel, mesh=mesh)
    n_shards = 1 if mesh is None else mesh.devices.size
    state = poolmod.init_state(min(renderer.batch_size, total), n_pixels,
                               n_shards=n_shards)
    if mesh is not None:  # placed as render_pool places them
        from jax.sharding import NamedSharding, PartitionSpec as P

        state = jax.device_put(state, NamedSharding(mesh, P("dp")))
        pack = jax.device_put(pack, NamedSharding(mesh, P()))
    t0 = time.perf_counter()
    step.lower(pack, state).compile()
    compile_s = time.perf_counter() - t0
    renderer.render()
    t0 = time.perf_counter()
    film = renderer.render()
    render_s = time.perf_counter() - t0
    return film, compile_s, render_s, total


def phase_render(compare_walk):
    from rust_raytracer_jax import models
    from rust_raytracer_jax.render.renderer import Renderer
    from rust_raytracer_jax.utils import cli

    t0 = time.perf_counter()
    scene = models.build("cornell_dragon")
    camera = bench_camera(scene)
    renderer = Renderer(scene, camera, batch_size=LANES)
    jax.block_until_ready(renderer.pack)
    build_s = time.perf_counter() - t0
    n_tris = real_triangles(renderer.pack)
    check(n_tris == BENCH_TRIANGLES,
          f"cornell_dragon has {n_tris} triangles, not {BENCH_TRIANGLES}")

    film, compile_s, render_s, total = timed_render(renderer)
    check_image(film.hdr(), (WIDTH, WIDTH, 3), "(b) render")
    log(f"(b) cornell_dragon {WIDTH}x{WIDTH} @{camera.actual_spp}spp "
        f"depth {DEPTH}, {n_tris} triangles, {LANES} lanes: "
        f"scene_build_s={build_s:.2f} compile_s={compile_s:.2f} "
        f"render_s={render_s:.3f} pixel_samples_per_s={total / render_s:.1f}")

    if compare_walk:
        renderer.kernel = "jnp"
        jfilm, j_compile_s, j_render_s, _ = timed_render(renderer)
        renderer.kernel = "auto"
        t0 = time.perf_counter()
        renderer.render()
        again_s = time.perf_counter() - t0
        a, b = film.hdr(), jfilm.hdr()
        rel = float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12))
        log(f"(b) walk comparison: kernel render_s={render_s:.3f} then "
            f"{again_s:.3f}; jnp walk render_s={j_render_s:.3f} "
            f"(compile_s={j_compile_s:.2f}); image mean rel diff {rel:.2e}")

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "cornell_dragon.png")
        t0 = time.perf_counter()
        rc = cli.main(["cornell_dragon", f"-w={WIDTH}", "-s=2", f"-o={png}"])
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"CLI returned {rc}")
        with open(png, "rb") as f:
            head = f.read(24)
        check(head[:8] == b"\x89PNG\r\n\x1a\n", "CLI output is not a PNG")
        w, h = np.frombuffer(head[16:24], ">u4")
        check((int(w), int(h)) == (WIDTH, WIDTH), f"CLI PNG is {w}x{h}")
    log(f"(b) CLI cornell_dragon -w={WIDTH} -s=2: {w}x{h} PNG in "
        f"{cli_s:.1f}s")
    return renderer


def bench_rays(pack, camera, n):
    """Primary rays over the image, and bounce-like rays from their hits in
    seeded random directions (incoherent, like a diffuse bounce)."""
    from rust_raytracer_jax.core import rng as vrng
    from rust_raytracer_jax.ops import intersect as isect

    w = np.uint32(camera.image_width)
    px = jnp.asarray(np.arange(n) * 7 % camera.image_width, jnp.uint32)
    py = jnp.asarray((np.arange(n) * 13 // camera.image_width)
                     % camera.image_height, jnp.uint32)
    smp = jnp.zeros((n,), jnp.uint32)
    ctx = vrng.Ctx(pixel=py * w + px, sample=smp, bounce=jnp.uint32(0),
                   seed=jnp.uint32(0))
    org, dirn = camera.generate_rays(px, py, smp, ctx, jnp.float32)
    t_min = jnp.full((n,), 1e-3, jnp.float32)
    t_max = jnp.full((n,), jnp.inf, jnp.float32)
    t, i = jax.jit(lambda o, d: isect.intersect_triangles(
        pack, o, d, t_min, t_max, kernel="jnp"))(org, dirn)
    t_hit = jnp.where(i >= 0, t, 1.0)
    org2 = org + dirn * t_hit[:, None]
    d2 = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return [("primary", org, dirn), ("bounce", org2, jnp.asarray(d2))], \
        t_min, t_max


def walk_agreement(a, b):
    (ta, ia), (tb, ib) = [tuple(map(np.asarray, x)) for x in (a, b)]
    ha, hb = ia >= 0, ib >= 0
    ok = (ha == hb) & (~ha | (np.abs(ta - tb) <= 1e-4 + 1e-4 * np.abs(tb)))
    return float(ok.mean()), float(hb.mean())


def time_call(fn, *args, reps=3):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def phase_parity(renderer):
    from rust_raytracer_jax import models
    from rust_raytracer_jax.ops import intersect as isect
    from rust_raytracer_jax.render.renderer import Renderer

    pack = renderer.pack
    ray_sets, t_min, t_max = bench_rays(pack, renderer.camera, PARITY_RAYS)
    auto = jax.jit(lambda o, d: isect.intersect_triangles(
        pack, o, d, t_min, t_max))
    ref = jax.jit(lambda o, d: isect.intersect_triangles(
        pack, o, d, t_min, t_max, kernel="jnp"))
    hlo = auto.lower(ray_sets[0][1], ray_sets[0][2]).as_text()
    check("bvh_walk" in hlo, "kernel='auto' did not compile the Triton walk")
    for name, org, dirn in ray_sets:
        frac, hits = walk_agreement(auto(org, dirn), ref(org, dirn))
        k_s, j_s = time_call(auto, org, dirn), time_call(ref, org, dirn)
        log(f"(c) walk parity, {PARITY_RAYS} {name} rays: agreement "
            f"{frac:.6f} (hit fraction {hits:.4f}); kernel {k_s * 1e3:.3f} ms, "
            f"jnp walk {j_s * 1e3:.3f} ms")
        check(frac >= WALK_AGREE_MIN,
              f"{name} rays: kernel agrees with the jnp walk on {frac:.6f}")

    scene = models.build("cornell")
    camera = bench_camera(scene, width=160, spp=4)
    gpu_img = Renderer(scene, camera).render().hdr()
    with fresh_cpu_compiles(), jax.default_device(jax.devices("cpu")[0]):
        cpu_img = Renderer(scene, camera).render().hdr()
    check_image(gpu_img, cpu_img.shape, "(c) cornell on the GPU")
    scale = float(np.abs(cpu_img).mean())
    rel = float(np.abs(gpu_img - cpu_img).mean()) / scale
    agree = float(np.mean(np.all(
        np.abs(gpu_img - cpu_img) <= 1e-3 * (np.abs(cpu_img) + scale), -1)))
    log(f"(c) cornell 160px @4spp GPU vs CPU: image mean rel err {rel:.3e} "
        f"(max {IMAGE_MEAN_REL_ERR_MAX}), pixel agreement {agree:.5f} "
        f"(min {PIXEL_AGREE_MIN})")
    check(rel <= IMAGE_MEAN_REL_ERR_MAX and agree >= PIXEL_AGREE_MIN,
          "GPU image departs from the CPU image")


def lane_grid(camera, n):
    """n lanes spread evenly over the image, one sample each."""
    flat = np.arange(n) * max(1, camera.image_width * camera.image_height // n)
    px = jnp.asarray(flat % camera.image_width, jnp.uint32)
    py = jnp.asarray((flat // camera.image_width) % camera.image_height,
                     jnp.uint32)
    return px, py, jnp.zeros((n,), jnp.uint32)


def make_batch_fn(static, camera, differentiable):
    from rust_raytracer_jax.core import rng as vrng
    from rust_raytracer_jax.render import integrator

    def batch_fn(pack, px, py, sample, seed):
        ctx = vrng.Ctx(pixel=py * np.uint32(camera.image_width) + px,
                       sample=sample, bounce=jnp.uint32(0), seed=seed)
        org, dirn = camera.generate_rays(px, py, sample, ctx)
        return integrator.trace(pack, static, org, dirn, ctx,
                                camera.max_depth, camera.light_bias,
                                differentiable=differentiable)

    return batch_fn


def l2(rad, target):
    return jnp.mean((rad - target) ** 2)


@jax.jit
def all_finite(leaves):
    return jnp.stack([jnp.all(jnp.isfinite(x)) for x in leaves])


def float_leaf_index(pack, leaf):
    floats = [x for x in jax.tree_util.tree_leaves(pack)
              if x.dtype.kind == "f"]
    return next(i for i, x in enumerate(floats) if x is leaf)


def train_steps(renderer, mesh, n_steps, lr=0.05):
    """n_steps of SGD on the material constants through
    parallel.mesh.train_step_fn; returns (losses, grads of the first step,
    seconds of the last step).  train_step_fn psums per-shard means, so
    loss and grads are divided by the shard count here."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rust_raytracer_jax.parallel import mesh as pmesh

    camera, static = renderer.camera, renderer.static
    # inputs placed as the step shards them, so no step recompiles for a
    # new input placement
    grid = lane_grid(camera, GRAD_LANES)
    target = jax.jit(make_batch_fn(static, camera, False))(
        renderer.pack, *grid, jnp.uint32(1))
    lanes = NamedSharding(mesh, P("dp"))
    pack = jax.device_put(renderer.pack, NamedSharding(mesh, P()))
    px, py, sample, target = jax.device_put((*grid, target), lanes)
    step = pmesh.train_step_fn(make_batch_fn(static, camera, True), l2, mesh)
    losses, first = [], None
    for _ in range(n_steps):
        t0 = time.perf_counter()
        loss, grads = step(pack, px, py, sample, jnp.uint32(0), target)
        jax.block_until_ready(grads)
        step_s = time.perf_counter() - t0
        loss = loss / mesh.devices.size
        grads = [g / mesh.devices.size for g in grads]
        finite = np.asarray(all_finite(grads))
        check(finite.all(), f"non-finite gradient leaves "
              f"{np.flatnonzero(~finite).tolist()}")
        g_tex = grads[float_leaf_index(pack, pack.tex_const)]
        pack = dataclasses.replace(
            pack, tex_const=jnp.maximum(pack.tex_const - lr * g_tex, 0.0))
        losses.append(float(loss))
        if first is None:
            first = grads
    return losses, first, step_s


def phase_grad(renderer):
    from rust_raytracer_jax import models
    from rust_raytracer_jax.parallel import mesh as pmesh
    from rust_raytracer_jax.render.camera import Camera
    from rust_raytracer_jax.render.renderer import Renderer

    losses, grads, step_s = train_steps(renderer, pmesh.make_mesh(1), 3)
    check(losses[0] > 0, "train step loss is 0: the lanes see nothing")
    log(f"(d) 3 gradient steps, cornell_dragon, {GRAD_LANES} lanes x depth "
        f"{DEPTH}: losses {[f'{x:.6f}' for x in losses]}, {len(grads)} "
        f"finite float leaves, last step {step_s:.3f}s")

    camera = Camera(image_width=16, aspect_ratio=1.5, samples_per_pixel=4,
                    max_depth=8, position=(0, 0, 1), look_at=(0, 0, 0),
                    focal_length=50.0)
    test = Renderer(models.build("test"), camera)
    n = camera.image_width * camera.image_height
    px, py, sample = lane_grid(camera, n)
    fwd = make_batch_fn(test.static, camera, False)
    diff = make_batch_fn(test.static, camera, True)

    def grad_on(device):
        pack = jax.device_put(test.pack, device)
        args = jax.device_put((px, py, sample), device)
        target = jax.jit(fwd)(pack, *args, jnp.uint32(1))
        g = jax.jit(jax.grad(lambda p: l2(diff(p, *args, jnp.uint32(0)),
                                          target), allow_int=True))(pack)
        return np.concatenate([np.ravel(np.asarray(x, np.float64))
                               for x in jax.tree_util.tree_leaves(g)
                               if x.dtype.kind == "f"])

    g_gpu = grad_on(jax.devices()[0])
    with fresh_cpu_compiles():
        g_cpu = grad_on(jax.devices("cpu")[0])
    check(bool(np.isfinite(g_gpu).all()), "non-finite GPU gradient")
    rel = float(np.linalg.norm(g_gpu - g_cpu)
                / max(np.linalg.norm(g_cpu), 1e-30))
    log(f"(d) test 16px gradient GPU vs CPU: relative L2 error {rel:.3e} "
        f"(max {GRAD_REL_ERR_MAX}) over {g_cpu.size} values")
    check(rel <= GRAD_REL_ERR_MAX, "GPU gradient departs from the CPU one")


def phase_cards(n_cards):
    from rust_raytracer_jax import models
    from rust_raytracer_jax.parallel import mesh as pmesh
    from rust_raytracer_jax.render.renderer import Renderer

    scene = models.build("cornell_dragon")
    camera = bench_camera(scene)
    one = Renderer(scene, camera, batch_size=LANES)
    many = Renderer(scene, camera, batch_size=LANES,
                    mesh=pmesh.make_mesh(n_cards))
    film1, _, t1, total = timed_render(one)
    film_n, compile_s, t_n, _ = timed_render(many)
    check_image(film_n.hdr(), (WIDTH, WIDTH, 3), f"({n_cards}-card render)")
    scale = float(np.abs(film1.accum).mean())
    diff = np.abs(film_n.accum - film1.accum)
    within = diff <= SHARD_RTOL * (np.abs(film1.accum) + scale)
    log(f"(e) {n_cards} cards vs 1: pixel sums within rtol {SHARD_RTOL}: "
        f"{within.mean():.6f}, max abs diff {diff.max():.3e}")
    check(bool(within.all()), f"{n_cards}-card pixel sums depart from one "
          "card's")
    log(f"(e) pool render {WIDTH}x{WIDTH} @{camera.actual_spp}spp: 1 card "
        f"{t1:.3f}s, {n_cards} cards {t_n:.3f}s (compile {compile_s:.1f}s), "
        f"{total / t_n:.1f} pixel-samples/s, scaling efficiency "
        f"{t1 / (n_cards * t_n):.3f}; pixel sums agree (rtol {SHARD_RTOL})")

    loss1, g1, s1 = train_steps(one, pmesh.make_mesh(1), 3)
    loss_n, g_n, s_n = train_steps(many, pmesh.make_mesh(n_cards), 3)
    check(loss1[0] > 0, "train step loss is 0: the lanes see nothing")
    flat = [np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in g])
            for g in (g1, g_n)]
    rel = float(np.linalg.norm(flat[1] - flat[0])
                / max(np.linalg.norm(flat[0]), 1e-30))
    log(f"(e) train step, {GRAD_LANES} lanes: 1 card {s1:.3f}s, {n_cards} "
        f"cards {s_n:.3f}s (scaling efficiency {s1 / (n_cards * s_n):.3f}); "
        f"first-step loss {loss1[0]:.7f} vs {loss_n[0]:.7f}, gradient "
        f"relative L2 difference {rel:.3e} (max {SHARD_GRAD_REL_MAX}); "
        f"third-step loss {loss1[-1]:.7f} vs {loss_n[-1]:.7f}")
    check(abs(loss_n[0] - loss1[0]) <= SHARD_RTOL * abs(loss1[0])
          and rel <= SHARD_GRAD_REL_MAX,
          "sharded train step departs from the one-card step")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the 4-card sharded phase")
    ap.add_argument("--compare-walk", action="store_true",
                    help="also time the (b) render with the jnp walk")
    args = ap.parse_args(argv)

    phase_device(args.cards)
    if args.cards > 1:
        phase_cards(args.cards)
    else:
        renderer = phase_render(args.compare_walk)
        phase_parity(renderer)
        phase_grad(renderer)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": args.cards}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

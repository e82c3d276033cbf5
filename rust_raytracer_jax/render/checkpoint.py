"""Checkpoint / resume for long renders.

The reference restarts a 41-minute render from zero on any failure (it has
no persistence at all — camera.rs renders straight through).  Here the pool
renderer's full lane state + image accumulator + global sample cursor are
periodically snapshotted to disk; resuming restores the exact PoolState, so
the final image is BIT-IDENTICAL to an uninterrupted run (the RNG is
counter-based on (pixel, sample, bounce) — core/rng.py — so no generator
state needs saving beyond what travels in the lanes).

Format: a single .npz (atomic rename) — portable, no orbax dependency for
this small state.  Checkpoints are host-side numpy; restore puts arrays
back on the default device.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import jax.numpy as jnp

from . import pool as poolmod

_FIELDS = ("org", "dirn", "throughput", "radiance", "pixel", "sample",
           "bounce", "active", "accum", "next_flat")


def save_pool_state(path: str, state: poolmod.PoolState, meta: dict = None):
    """Atomically write the pool state (+ optional scalar metadata)."""
    arrays = {f: np.asarray(getattr(state, f)) for f in _FIELDS}
    for k, v in (meta or {}).items():
        arrays[f"meta_{k}"] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_pool_state(path: str):
    """Returns (PoolState, meta dict)."""
    with np.load(path) as z:
        arrays = {f: z[f] for f in _FIELDS if f in z.files}
        meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    state = poolmod.PoolState(**{
        f: jnp.asarray(v) for f, v in arrays.items()
    })
    return state, meta


def render_pool_resumable(pack, static, camera, n_pixels: int, spp: int,
                          n_lanes: int, seed=0, dtype=jnp.float32,
                          steps_per_poll: int = 10, progress=None,
                          kernel: str = "auto",
                          checkpoint_path: str = None,
                          checkpoint_every_steps: int = 200):
    """render_pool with periodic checkpoints and resume.

    If checkpoint_path exists, rendering continues from it; otherwise a
    fresh pool starts.  Checkpoints are written every
    `checkpoint_every_steps` pool steps and once at completion.  Resumed
    runs produce images bit-identical to uninterrupted ones (tested in
    tests/test_checkpoint.py).
    """
    total = n_pixels * spp
    step_count = 0
    # Render-parameter fingerprint: resuming under different seed/spp/
    # pixels/camera/depth would silently corrupt the image (lane RNG ids
    # and the accumulator would disagree with the new step function).
    params = {
        "seed": int(seed), "spp": int(spp), "n_pixels": int(n_pixels),
        "n_lanes": int(n_lanes), "max_depth": int(camera.max_depth),
        "cam": (camera.image_width, camera.image_height,
                tuple(np.asarray(camera.position, np.float64)),
                tuple(np.asarray(camera.look_at, np.float64)),
                float(camera.focal_length), float(camera.light_bias)),
    }
    import hashlib

    digest = hashlib.sha256(repr(sorted(params.items())).encode()).digest()
    params_hash = np.frombuffer(digest[:8], np.uint64)[0]
    if checkpoint_path and os.path.exists(checkpoint_path):
        state, meta = load_pool_state(checkpoint_path)
        step_count = int(meta.get("step_count", 0))
        saved_hash = meta.get("params_hash")
        if saved_hash is not None and np.uint64(saved_hash) != params_hash:
            raise ValueError(
                f"checkpoint {checkpoint_path} was written with different "
                f"render parameters (seed/spp/pixels/camera/depth); refusing "
                f"to resume into an inconsistent state"
            )
        assert state.org.shape[0] == n_lanes, (
            f"checkpoint lane count {state.org.shape[0]} != {n_lanes}"
        )
    else:
        state = poolmod.init_state(n_lanes, n_pixels, dtype)
    step = poolmod.make_step(pack, static, camera, total, spp, seed,
                             kernel=kernel)
    max_steps = (total * camera.max_depth) // n_lanes + 2 * camera.max_depth
    since_ckpt = 0
    while step_count < max_steps:
        for _ in range(steps_per_poll):
            state = step(pack, state)
        step_count += steps_per_poll
        since_ckpt += steps_per_poll
        issued = int(jnp.sum(state.next_flat))
        n_active = int(jnp.sum(state.active.astype(jnp.int32)))
        if progress is not None:
            progress(issued, total)
        if checkpoint_path and since_ckpt >= checkpoint_every_steps:
            save_pool_state(checkpoint_path, state,
                            {"step_count": step_count,
                             "params_hash": params_hash})
            since_ckpt = 0
        if issued >= total and n_active == 0:
            break
    if checkpoint_path:
        save_pool_state(checkpoint_path, state,
                        {"step_count": step_count,
                         "params_hash": params_hash})
    return jnp.sum(state.accum, axis=0)

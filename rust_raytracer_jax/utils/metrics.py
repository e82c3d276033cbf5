"""Observability: structured render metrics, per-bounce occupancy
histograms, jax.profiler tracing, and a NaN-debug mode.

The reference prints per-thread wall-clock only (camera.rs:235-236); the
SURVEY §5 blueprint requires doing better: throughput counters a driver
can scrape, per-stage timings, and profiler traces for XLA-level analysis.

Everything here is opt-in and zero-cost when unused — no global state is
touched unless a context manager is entered.
"""
from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class RenderMetrics:
    """Accumulates counters during a render; emit() prints ONE JSON line
    (the same contract as bench.py) so logs stay machine-parseable."""

    n_pixels: int = 0
    spp: int = 0
    max_depth: int = 0
    samples_issued: int = 0
    steps: int = 0
    lane_bounces: int = 0          # lanes advanced x steps (pool work units)
    wall_start: float = field(default_factory=time.time)
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    bounce_alive: List[int] = field(default_factory=list)  # occupancy/step

    def record_step(self, n_alive: int, n_lanes: int, issued: int,
                    weight: int = 1):
        """Record one occupancy sample covering `weight` pool steps (the
        pool polls device state only every steps_per_poll steps, so
        occupancy is poll-granular)."""
        self.steps += weight
        self.lane_bounces += n_alive * weight
        self.samples_issued = issued
        self.bounce_alive.append(int(n_alive))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.stage_seconds[name] = (
                self.stage_seconds.get(name, 0.0) + time.time() - t0
            )

    def summary(self) -> dict:
        wall = max(time.time() - self.wall_start, 1e-9)
        total = self.n_pixels * self.spp
        occ = (
            float(np.mean(self.bounce_alive)) if self.bounce_alive else 0.0
        )
        out = {
            "pixel_samples": total,
            "samples_issued": self.samples_issued,
            "pixel_samples_per_s": self.samples_issued / wall,
            "rays_per_s": self.lane_bounces / wall,  # 1 closest-hit per lane-bounce
            "steps": self.steps,
            "mean_occupancy": occ,
            "wall_s": wall,
            "stages_s": dict(self.stage_seconds),
        }
        return out

    def emit(self, stream=None) -> str:
        line = json.dumps({"render_metrics": self.summary()})
        print(line, file=stream)
        return line


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """jax.profiler trace for XLA-level analysis (view with
    tensorboard or xprof).  No-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """NaN-debug mode: XLA checks every jitted output and raises with the
    offending primitive (the wavefront analog of a data race detector —
    any lane poisoning the image is caught at the step that produced it,
    not in the final buffer).  Recompiles everything entered under it;
    use for debugging, never benchmarks."""
    if not enable:
        yield
        return
    import jax

    old = jax.config.read("jax_debug_nans")
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)

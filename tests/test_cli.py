"""CLI end-to-end (reference: src/main.rs): scene dispatch, -k=v flags,
render, ACES tonemap, PNG output — plus the observability flags
(--metrics emits one JSON line; --profile writes a jax.profiler trace).
"""
import json
import os

import numpy as np
import pytest

from rust_raytracer_jax.utils import cli


def test_cli_renders_builtin_scene(tmp_path, capsys):
    out = tmp_path / "out.png"
    rc = cli.main(["test", "-w=32", "-s=4", "--max-depth=3",
                   f"-o={out}", "--metrics=1"])
    assert rc == 0
    assert out.exists()
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (21, 32, 3)  # 32 wide, aspect 1.5
    assert img.max() > 0

    captured = capsys.readouterr().out
    lines = [l for l in captured.splitlines() if l.startswith("{")]
    assert lines, f"no metrics JSON line in output: {captured!r}"
    m = json.loads(lines[-1])["render_metrics"]
    assert m["samples_issued"] == 32 * 21 * 4
    assert m["pixel_samples_per_s"] > 0
    # occupancy counters are poll-granular; a render that finishes within
    # one poll legitimately reports 0 live lanes at its only sample
    assert m["mean_occupancy"] >= 0


def test_cli_profile_flag_writes_trace(tmp_path):
    out = tmp_path / "out.png"
    prof = tmp_path / "trace"
    rc = cli.main(["test", "-w=16", "-s=1", "--max-depth=2",
                   f"-o={out}", f"--profile={prof}"])
    assert rc == 0
    # jax.profiler writes plugins/profile/<ts>/*.xplane.pb under the dir
    found = []
    for root, _dirs, files in os.walk(prof):
        found += [f for f in files if f.endswith(".xplane.pb")]
    assert found, f"no profiler trace written under {prof}"

"""Multi-host (multi-process) mesh: two OS processes, each contributing 2
virtual CPU devices, render disjoint lane shards of the same image and
psum the result — the DCN analog of test_sharding.py's single-process
mesh, exercising parallel.mesh.init_multihost + jax.distributed.

Runs each worker in a subprocess (jax.distributed is per-process global
state); asserts the psum'd radiance equals the single-process render
bit-for-bit per lane (counter-based RNG).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_HERE = os.path.dirname(__file__)

_WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)
import jax
jax.config.update("jax_platforms", "cpu")

proc_id = int(sys.argv[1])
coord = sys.argv[2]

from rust_raytracer_jax.parallel import mesh as pmesh
pmesh.init_multihost(coord, num_processes=2, process_id=proc_id,
                     local_device_count=2)

import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from rust_raytracer_jax import models
from rust_raytracer_jax.core import rng as vrng
from rust_raytracer_jax.render import integrator
from rust_raytracer_jax.render.camera import Camera
from rust_raytracer_jax.scene import compiler as sc

assert jax.device_count() == 4 and jax.process_count() == 2

scene = models.build("test")
cam = Camera(image_width=16, aspect_ratio=1.0, samples_per_pixel=1,
             max_depth=3, position=(0, 0, 1), look_at=(0, 0, 0),
             focal_length=50.0)
pack, static = sc.compile_scene(scene)
n = 64  # 16 lanes per device
w = np.uint32(cam.image_width)

mesh = jax.make_mesh((4,), ("dp",))

def local_fn(pack, px, py):
    ctx = vrng.Ctx(pixel=py * w + px, sample=jnp.zeros_like(px),
                   bounce=jnp.uint32(0), seed=jnp.uint32(0))
    org, dirn = cam.generate_rays(px, py, jnp.zeros_like(px), ctx,
                                  jnp.float32)
    rad = integrator.trace(pack, static, org, dirn, ctx, 3, 0.25,
                           kernel="jnp")
    return jax.lax.psum(jnp.sum(rad, axis=0), "dp")

sharded = jax.jit(jax.shard_map(
    local_fn, mesh=mesh, in_specs=(P(), P("dp"), P("dp")),
    out_specs=P(), check_vma=False,
))

px_all = np.arange(n, dtype=np.uint32) % cam.image_width
py_all = (np.arange(n, dtype=np.uint32) // cam.image_width) % cam.image_height
# each process feeds only its addressable shard of the global array
lo = proc_id * (n // 2)
hi = lo + n // 2
gpx = jax.make_array_from_process_local_data(
    jax.NamedSharding(mesh, P("dp")), px_all[lo:hi], (n,))
gpy = jax.make_array_from_process_local_data(
    jax.NamedSharding(mesh, P("dp")), py_all[lo:hi], (n,))

total = sharded(pack, gpx, gpy)
# out_specs=P() => fully replicated: every process holds the psum result
local = np.asarray(jax.device_get(total.addressable_data(0)))
if proc_id == 0:
    print("RESULT " + json.dumps(local.reshape(-1).tolist()))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.skipif(os.environ.get("RRT_SKIP_MULTIHOST") == "1",
                    reason="multihost test disabled")
def test_two_process_mesh_matches_single_process():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(_HERE, os.pardir)]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(pid), coord],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    assert all(rc == 0 for rc, _, _ in outs), outs[0][2][-2000:] + outs[1][2][-2000:]
    line = [l for l in outs[0][1].splitlines() if l.startswith("RESULT ")]
    assert line, outs[0][1]
    total = np.asarray(json.loads(line[0][len("RESULT "):]))

    # single-process oracle
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    from rust_raytracer_jax import models
    from rust_raytracer_jax.core import rng as vrng
    from rust_raytracer_jax.render import integrator
    from rust_raytracer_jax.render.camera import Camera
    from rust_raytracer_jax.scene import compiler as sc

    scene = models.build("test")
    cam = Camera(image_width=16, aspect_ratio=1.0, samples_per_pixel=1,
                 max_depth=3, position=(0, 0, 1), look_at=(0, 0, 0),
                 focal_length=50.0)
    pack, static = sc.compile_scene(scene)
    n = 64
    w = np.uint32(cam.image_width)
    px = jnp.asarray(np.arange(n, dtype=np.uint32) % cam.image_width)
    py = jnp.asarray(
        (np.arange(n, dtype=np.uint32) // cam.image_width) % cam.image_height
    )
    ctx = vrng.Ctx(pixel=py * w + px, sample=jnp.zeros_like(px),
                   bounce=jnp.uint32(0), seed=jnp.uint32(0))
    org, dirn = cam.generate_rays(px, py, jnp.zeros_like(px), ctx, jnp.float32)
    rad = integrator.trace(pack, static, org, dirn, ctx, 3, 0.25, kernel="jnp")
    expect = np.asarray(jnp.sum(rad, axis=0))
    np.testing.assert_allclose(total, expect, rtol=1e-6, atol=1e-7)

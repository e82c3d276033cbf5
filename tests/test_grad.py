"""Finite-difference validation of pixel gradients (the north-star
gradient contract, BASELINE.md: image + pixel-grad allclose).

The integrator detaches traversal decisions (hit ids + raw t) and
recomputes t differentiably in hit_attributes (ops/intersect.py), so
jax.grad of radiance w.r.t. scene parameters follows the local-shading
dependency — the standard differentiable-path-tracing contract (visibility
boundary terms are excluded; f64 + eps=1e-6 keeps every FD probe's hit
topology fixed, so FD measures the same thing).

Because the RNG is counter-based on (pixel, sample, bounce), radiance is a
DETERMINISTIC function of the ScenePack for fixed lane ids — central
finite differences of the estimator itself are well-defined.

The numerics run in a subprocess (tests/_grad_fd_main.py) with
JAX_ENABLE_X64=1 so f64 mode never leaks into this f32 suite.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

_HERE = os.path.dirname(__file__)


@pytest.fixture(scope="module")
def fd_results():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(_HERE, os.pardir)]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    out = subprocess.run(
        [sys.executable, os.path.join(_HERE, "_grad_fd_main.py")],
        capture_output=True, text=True, timeout=900, env=env,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _check(results, prefix, rtol=1e-3):
    rows = [r for r in results if r["name"].startswith(prefix)]
    assert rows, f"no FD probe named {prefix}*"
    for r in rows:
        np.testing.assert_allclose(
            r["analytic"], r["fd"], rtol=rtol, atol=1e-5,
            err_msg=f"gradient mismatch for {r['name']}: {r}",
        )


def test_grad_sphere_center(fd_results):
    _check(fd_results, "sph_center")


def test_grad_sphere_radius(fd_results):
    _check(fd_results, "sph_radius")


def test_grad_plane_corner(fd_results):
    _check(fd_results, "pln_corner")


def test_grad_background(fd_results):
    _check(fd_results, "background")


def test_grad_material_texture_constants(fd_results):
    _check(fd_results, "tex_const")
    # at least 2 distinct texture constants (albedo + emission) probed
    assert sum(r["name"].startswith("tex_const") for r in fd_results) >= 2


def test_gradients_nontrivial(fd_results):
    mags = [abs(r["analytic"]) for r in fd_results]
    assert max(mags) > 1e-3, "all probed gradients ~0 — probe is vacuous"


@pytest.mark.parametrize("scene_name", ["cornell", "test"])
def test_grads_finite_when_lanes_miss(scene_name):
    """Lanes that miss everything (camera corners outside the Cornell box)
    must not NaN the gradients: their masked-out shading terms still enter
    reverse mode as 0 * value, so every value has to stay finite."""
    import jax
    import jax.numpy as jnp

    from rust_raytracer_jax import models
    from rust_raytracer_jax.core import rng as vrng
    from rust_raytracer_jax.render import integrator
    from rust_raytracer_jax.scene import compiler as sc
    from rust_raytracer_jax.utils import config as cfg

    scene = models.build(scene_name)
    cam = cfg.make_camera(
        cfg.merge_scene_config(scene.config, {"output_width": 12}),
        cfg.RenderConfig(samples_per_pixel=1, max_depth=2))
    pack, static = sc.compile_scene(scene)
    n = cam.image_width * cam.image_height
    px = jnp.arange(n, dtype=jnp.uint32) % cam.image_width
    py = jnp.arange(n, dtype=jnp.uint32) // cam.image_width
    smp = jnp.zeros((n,), jnp.uint32)

    def loss(p):
        ctx = vrng.Ctx(pixel=py * cam.image_width + px, sample=smp,
                       bounce=jnp.uint32(0), seed=jnp.uint32(0))
        org, dirn = cam.generate_rays(px, py, smp, ctx)
        rad = integrator.trace(p, static, org, dirn, ctx, 2, cam.light_bias,
                               differentiable=True)
        return jnp.mean(rad ** 2)

    grads = jax.jit(jax.grad(loss, allow_int=True))(pack)
    for leaf in jax.tree_util.tree_leaves(grads):
        if leaf.dtype.kind == "f":
            assert np.isfinite(np.asarray(leaf)).all()

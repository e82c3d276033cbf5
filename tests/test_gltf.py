"""glTF `model:` import (reference: src/loaders/assimp.rs).

A .glb fixture is built programmatically: a unit quad with an emissive
material, a floor quad with a glossy base-color material + roughness
factor, a node hierarchy with transforms, and a perspective camera.
Asserts the assimp.rs mapping: emissive -> Emissive + invisible proxy
light sphere; everything else -> Glossy(ior=1.5); camera -> config with
focal = 18/tan(hfov/2); node transforms baked; then compiles + renders.
"""
import json
import math
import struct

import numpy as np
import jax.numpy as jnp
import pytest

from rust_raytracer_jax.scene import compiler as sc
from rust_raytracer_jax.scene import graph as g
from rust_raytracer_jax.scene import pack as sp
from rust_raytracer_jax.utils import model_import


def _build_glb(path):
    # two quads: emissive ceiling (y=2), gray floor (y=0), each 2 tris
    quad_pos = np.array([
        [-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1],
    ], np.float32)
    quad_nrm = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    # winding chosen so the geometric normal (e1 x e2) points +y, agreeing
    # with the shading normals; the rotated light node flips both to -y
    quad_idx = np.array([0, 2, 1, 0, 3, 2], np.uint16)

    bin_parts = []
    views = []
    accessors = []

    def add_view(arr, target):
        off = sum(len(b) for b in bin_parts)
        raw = arr.tobytes()
        bin_parts.append(raw + b"\x00" * (-len(raw) % 4))
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(raw),
                      "target": target})
        return len(views) - 1

    def add_accessor(arr, type_, comp, target=34962):
        v = add_view(arr, target)
        accessors.append({
            "bufferView": v, "componentType": comp,
            "count": arr.shape[0] if arr.ndim > 1 else arr.shape[0],
            "type": type_,
            "max": arr.max(0).tolist() if arr.ndim > 1 else [int(arr.max())],
            "min": arr.min(0).tolist() if arr.ndim > 1 else [int(arr.min())],
        })
        return len(accessors) - 1

    pos_a = add_accessor(quad_pos, "VEC3", 5126)
    nrm_a = add_accessor(quad_nrm, "VEC3", 5126)
    idx_a = add_accessor(quad_idx, "SCALAR", 5123, target=34963)

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1, 2]}],
        "nodes": [
            # rotated 180deg about x so the quad's +y normal faces DOWN
            # (front-face-only emission must reach the floor below)
            {"mesh": 0, "translation": [0.0, 2.0, 0.0],
             "rotation": [1.0, 0.0, 0.0, 0.0], "name": "light"},
            {"mesh": 1, "scale": [4.0, 1.0, 4.0], "name": "floor"},
            {"camera": 0, "translation": [0.0, 1.0, 4.0], "name": "cam"},
        ],
        "cameras": [{
            "type": "perspective",
            "perspective": {"yfov": 0.6, "aspectRatio": 1.5, "znear": 0.01},
        }],
        "meshes": [
            {"primitives": [{
                "attributes": {"POSITION": pos_a, "NORMAL": nrm_a},
                "indices": idx_a, "material": 0,
            }]},
            {"primitives": [{
                "attributes": {"POSITION": pos_a, "NORMAL": nrm_a},
                "indices": idx_a, "material": 1,
            }]},
        ],
        "materials": [
            {"name": "lamp", "emissiveFactor": [1.0, 0.9, 0.8],
             "extensions": {"KHR_materials_emissive_strength":
                            {"emissiveStrength": 5.0}}},
            {"name": "floor", "pbrMetallicRoughness": {
                "baseColorFactor": [0.6, 0.6, 0.6, 1.0],
                "roughnessFactor": 0.4,
            }},
        ],
        "buffers": [{"byteLength": sum(len(b) for b in bin_parts)}],
        "bufferViews": views,
        "accessors": accessors,
    }

    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    binc = b"".join(bin_parts)
    total = 12 + 8 + len(js) + 8 + len(binc)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(binc), 0x004E4942))
        f.write(binc)


@pytest.fixture(scope="module")
def glb_scene(tmp_path_factory):
    p = tmp_path_factory.mktemp("gltf") / "fixture.glb"
    _build_glb(str(p))
    return model_import.load_model(str(p))


def test_gltf_meshes_and_materials(glb_scene):
    meshes = glb_scene.world.items
    assert len(meshes) == 2
    mats = {type(m.material).__name__ for m in meshes}
    assert mats == {"Emissive", "Glossy"}
    glossy = next(m.material for m in meshes
                  if isinstance(m.material, g.Glossy))
    assert glossy.ior == 1.5
    assert glossy.roughness.value == pytest.approx(0.4)
    emissive = next(m.material for m in meshes
                    if isinstance(m.material, g.Emissive))
    # emissiveFactor * KHR emissive strength
    np.testing.assert_allclose(emissive.emission.value,
                               (5.0, 4.5, 4.0), rtol=1e-6)


def test_gltf_transforms_baked(glb_scene):
    light = next(m for m in glb_scene.world.items
                 if isinstance(m.material, g.Emissive))
    floor = next(m for m in glb_scene.world.items
                 if isinstance(m.material, g.Glossy))
    np.testing.assert_allclose(light.vertices[:, 1], 2.0, atol=1e-5)
    # 180deg x-rotation flips the shading normal to -y
    np.testing.assert_allclose(light.normals[:, 1], -1.0, atol=1e-5)
    assert floor.vertices[:, 0].max() == pytest.approx(4.0)


def test_gltf_proxy_light(glb_scene):
    assert len(glb_scene.lights) == 1
    proxy = glb_scene.lights[0]
    assert isinstance(proxy, g.ProxySphereLight)
    # center = accumulated node translation (assimp.rs:76-80)
    np.testing.assert_allclose(proxy.center, (0.0, 2.0, 0.0), atol=1e-6)
    # radius = min vertex distance from mesh-local origin
    assert proxy.radius == pytest.approx(np.sqrt(2.0))


def test_gltf_camera_config(glb_scene):
    cfg = glb_scene.config
    np.testing.assert_allclose(cfg["camera_pos"], (0, 1, 4), atol=1e-6)
    np.testing.assert_allclose(cfg["camera_target"], (0, 1, 3), atol=1e-6)
    assert cfg["aspect_ratio"] == pytest.approx(1.5)
    hfov = 2.0 * math.atan(math.tan(0.3) * 1.5)
    assert cfg["focal_length"] == pytest.approx(18.0 / math.tan(hfov / 2.0))


def test_gltf_compiles_with_proxy_light_and_renders(glb_scene):
    pack, static = sc.compile_scene(glb_scene)
    # proxy light in the light table, absent from the sphere table
    assert (sp.LIGHT_PROXY, 0) in static.light_list
    assert pack.sph_center.shape[0] == 0
    assert pack.lgt_sph_center.shape[0] == 1
    assert pack.tri_v0.shape[0] >= 4

    from rust_raytracer_jax.core import rng as vrng
    from rust_raytracer_jax.render import integrator
    from rust_raytracer_jax.render.camera import Camera
    from rust_raytracer_jax.utils import config as cfgmod

    cam = cfgmod.make_camera(
        cfgmod.merge_scene_config(glb_scene.config, {"output_width": 8}),
        cfgmod.RenderConfig(samples_per_pixel=1, max_depth=3),
    )
    n = 8 * cam.image_height
    px = jnp.asarray(np.arange(n) % 8, jnp.uint32)
    py = jnp.asarray(np.arange(n) // 8, jnp.uint32)
    smp = jnp.zeros((n,), jnp.uint32)
    ctx = vrng.Ctx(pixel=py * np.uint32(8) + px, sample=smp,
                   bounce=jnp.uint32(0), seed=jnp.uint32(0))
    org, dirn = cam.generate_rays(px, py, smp, ctx, jnp.float32)
    rad = integrator.trace(pack, static, org, dirn, ctx, 3, 0.25,
                           kernel="jnp")
    rad = np.asarray(rad)
    assert np.isfinite(rad).all()
    assert rad.max() > 0.0  # the emissive quad lights the floor

"""FBX `model:` import (reference: src/loaders/assimp.rs imports any
Assimp format; models/test.fbx is the shipped sample).

A minimal FBX 7.4 binary is written programmatically (node records,
typed properties, one zlib-compressed array) and round-tripped through
utils/fbx.py; the reference's own models/test.fbx (when mounted) is
cross-checked against its glb twin: same triangle counts/materials,
geometry scaled by the FBX cm units, camera at the same spot (x100).
"""
import math
import os
import struct
import zlib

import numpy as np
import pytest

from rust_raytracer_jax.scene import compiler as sc
from rust_raytracer_jax.scene import graph as g
from rust_raytracer_jax.utils import fbx, model_import

_REF_FBX = "/root/reference/models/test.fbx"
_REF_GLB = "/root/reference/models/test.glb"


# ---------------------------------------------------------------------------
# Tiny FBX 7.4 binary writer (test fixture only)
# ---------------------------------------------------------------------------


def _prop(v):
    if isinstance(v, bool):
        return b"C" + bytes([int(v)])
    if isinstance(v, int):
        return b"L" + struct.pack("<q", v)
    if isinstance(v, float):
        return b"D" + struct.pack("<d", v)
    if isinstance(v, str):
        raw = v.encode()
        return b"S" + struct.pack("<I", len(raw)) + raw
    if isinstance(v, np.ndarray):
        code = {"float64": b"d", "int32": b"i", "float32": b"f",
                "int64": b"l"}[str(v.dtype)]
        raw = v.tobytes()
        if v.size > 8:  # exercise the zlib path on the bigger arrays
            z = zlib.compress(raw)
            return code + struct.pack("<III", v.size, 1, len(z)) + z
        return code + struct.pack("<III", v.size, 0, len(raw)) + raw
    raise TypeError(type(v))


class _Writer:
    """Depth-first writer with absolute EndOffsets."""

    def __init__(self):
        self.buf = bytearray(b"Kaydara FBX Binary  \x00\x1a\x00"
                             + struct.pack("<I", 7400))

    def node(self, name, props=(), children_fn=None):
        start = len(self.buf)
        self.buf.extend(b"\x00" * 12)  # end/nprops/plen placeholder
        name_b = name.encode()
        self.buf.append(len(name_b))
        self.buf.extend(name_b)
        p0 = len(self.buf)
        for p in props:
            self.buf.extend(_prop(p))
        plen = len(self.buf) - p0
        if children_fn is not None:
            children_fn(self)
            self.buf.extend(b"\x00" * 13)
        struct.pack_into("<III", self.buf, start, len(self.buf), len(props),
                         plen)

    def done(self):
        self.buf.extend(b"\x00" * 13)
        return bytes(self.buf)


def _build_fixture(path):
    verts = np.array([-1, 0, -1, 1, 0, -1, 1, 0, 1, -1, 0, 1], np.float64)
    pvi = np.array([0, 1, 2, -4], np.int32)  # one quad -> 2 fan tris
    # ByPolygonVertex x Direct: one normal per corner
    normals = np.asarray(np.tile([0.0, 1.0, 0.0], 4), np.float64)
    uv = np.array([0, 0, 1, 0, 1, 1, 0, 1], np.float64)
    uv_index = np.array([0, 1, 2, 3], np.int32)

    w = _Writer()

    def objects(w):
        def geometry(w):
            w.node("Vertices", [verts])
            w.node("PolygonVertexIndex", [pvi])

            def len_(w):
                w.node("MappingInformationType", ["ByPolygonVertex"])
                w.node("ReferenceInformationType", ["Direct"])
                w.node("Normals", [normals])

            def leuv(w):
                w.node("MappingInformationType", ["ByPolygonVertex"])
                w.node("ReferenceInformationType", ["IndexToDirect"])
                w.node("UV", [uv])
                w.node("UVIndex", [uv_index])

            w.node("LayerElementNormal", [0], len_)
            w.node("LayerElementUV", [0], leuv)

        w.node("Geometry", [100, "Quad\x00\x01Geometry", "Mesh"], geometry)

        def model(w):
            def p70(w):
                w.node("P", ["Lcl Translation", "Lcl Translation", "", "A",
                             1.0, 2.0, 3.0])
                w.node("P", ["Lcl Scaling", "Lcl Scaling", "", "A",
                             2.0, 2.0, 2.0])
                w.node("P", ["Lcl Rotation", "Lcl Rotation", "", "A",
                             0.0, 0.0, 90.0])

            w.node("Properties70", [], p70)

        w.node("Model", [200, "Quad\x00\x01Model", "Mesh"], model)

        def material(w):
            def p70(w):
                w.node("P", ["DiffuseColor", "Color", "", "A",
                             0.9, 0.4, 0.1])
                w.node("P", ["EmissiveColor", "Color", "", "A",
                             0.0, 0.0, 0.0])

            w.node("Properties70", [], p70)

        w.node("Material", [300, "Mat\x00\x01Material", ""], material)

        def cam_model(w):
            def p70(w):
                w.node("P", ["Lcl Translation", "Lcl Translation", "", "A",
                             5.0, 6.0, 7.0])

            w.node("Properties70", [], p70)

        w.node("Model", [400, "Cam\x00\x01Model", "Camera"], cam_model)

        def cam_attr(w):
            def p70(w):
                w.node("P", ["Position", "Vector", "", "A", 5.0, 6.0, 7.0])
                w.node("P", ["InterestPosition", "Vector", "", "A",
                             0.0, 0.0, 0.0])
                w.node("P", ["FieldOfView", "FieldOfView", "", "A", 60.0])
                w.node("P", ["FilmAspectRatio", "double", "Number", "",
                             1.5])

            w.node("Properties70", [], p70)

        w.node("NodeAttribute", [500, "Cam\x00\x01NodeAttribute", "Camera"],
               cam_attr)

    w.node("Objects", [], objects)

    def connections(w):
        w.node("C", ["OO", 200, 0])
        w.node("C", ["OO", 100, 200])
        w.node("C", ["OO", 300, 200])
        w.node("C", ["OO", 400, 0])
        w.node("C", ["OO", 500, 400])

    w.node("Connections", [], connections)
    with open(path, "wb") as f:
        f.write(w.done())


def test_fixture_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "quad.fbx")
    _build_fixture(path)
    s = fbx.load(path)

    assert len(s.meshes) == 1
    m = s.meshes[0]
    assert m.tris.shape == (2, 3, 3)
    # transform: scale 2, rotate z 90deg, translate (1,2,3)
    v0 = m.primitive.positions[0].astype(np.float64)  # (-1, 0, -1)
    world_v0 = m.world[:3, :3] @ v0 + m.world[:3, 3]
    r = math.radians(90.0)
    expect = np.array([
        2 * (-1) * math.cos(r) - 0.0, 2 * (-1) * math.sin(r) + 0.0, -2.0,
    ]) + np.array([1.0, 2.0, 3.0])
    np.testing.assert_allclose(world_v0, expect, atol=1e-12)
    # normals per corner, uv via IndexToDirect
    np.testing.assert_allclose(m.primitive.normals,
                               np.tile([[0, 1, 0]], (4, 1)))
    np.testing.assert_allclose(m.primitive.uvs[m.tris[0, :, 2]],
                               [[0, 0], [1, 0], [1, 1]])

    assert len(s.materials) == 1
    np.testing.assert_allclose(s.materials[0].base_color, (0.9, 0.4, 0.1))

    cam = s.camera
    assert cam is not None
    np.testing.assert_allclose(cam.position, [5, 6, 7])
    # unrotated camera node: FBX cameras aim along local +X
    np.testing.assert_allclose(cam.look_at, [6, 6, 7])
    hfov = 2 * math.atan(math.tan(cam.yfov / 2) * cam.aspect)
    np.testing.assert_allclose(math.degrees(hfov), 60.0, rtol=1e-6)


def test_fixture_scene_compiles(tmp_path):
    path = os.path.join(tmp_path, "quad.fbx")
    _build_fixture(path)
    scene = model_import.load_model(path)
    pack, static = sc.compile_scene(scene)
    assert pack.tri_v0.shape[0] >= 2
    assert "camera_pos" in scene.config


@pytest.mark.skipif(not os.path.exists(_REF_FBX),
                    reason="reference asset not mounted")
def test_reference_fbx_matches_glb_twin():
    """models/test.fbx and models/test.glb are the same Blender scene
    exported twice; the FBX (cm units) must agree with the glb x100."""
    from rust_raytracer_jax.utils import gltf

    fs = fbx.load(_REF_FBX)
    gs = gltf.load(_REF_GLB)

    fbx_tris = sorted(m.tris.shape[0] for m in fs.meshes)
    glb_tris = sorted(p.indices.shape[0] for p, _, _ in gs.instances)
    assert fbx_tris == glb_tris == [2, 12, 968]

    # world-space mesh translations: cm vs m
    ft = sorted(tuple(np.round(m.world[:3, 3], 1)) for m in fs.meshes)
    gt = sorted(tuple(np.round(w[:3, 3] * 100.0, 1)) for _, w, _ in
                gs.instances)
    np.testing.assert_allclose(np.array(ft), np.array(gt), atol=0.5)

    # materials (sorted by diffuse) and the emissive light match exactly
    f_em = max(np.max(m.emissive) for m in fs.materials)
    g_em = max(np.max(m.emissive) for m in gs.materials)
    np.testing.assert_allclose(f_em, g_em, rtol=1e-6)

    # camera: position x100, same aim direction, same yfov
    np.testing.assert_allclose(np.asarray(fs.camera.position),
                               np.asarray(gs.camera.position) * 100.0,
                               rtol=1e-3)
    f_dir = np.asarray(fs.camera.look_at) - np.asarray(fs.camera.position)
    g_dir = np.asarray(gs.camera.look_at) - np.asarray(gs.camera.position)
    f_dir /= np.linalg.norm(f_dir)
    g_dir /= np.linalg.norm(g_dir)
    np.testing.assert_allclose(f_dir, g_dir, atol=1e-4)
    np.testing.assert_allclose(fs.camera.yfov, gs.camera.yfov, rtol=1e-6)


@pytest.mark.skipif(not os.path.exists(_REF_FBX),
                    reason="reference asset not mounted")
def test_reference_fbx_imports_and_compiles():
    scene = model_import.load_model(_REF_FBX)
    pack, static = sc.compile_scene(scene)
    assert pack.tri_v0.shape[0] >= 982  # 2 + 968 + 12 (pre-padding)
    # the emissive cube produced a proxy sampling light
    assert len(scene.lights) >= 1
    assert "camera_pos" in scene.config

"""COLLADA (.dae) import: generated fixture -> GltfScene -> SceneDef.

Mirrors tests/test_fbx.py's strategy: the fixture is written by the test
(plain XML), so the assertions pin exact geometry — including the Z_UP
world conversion, node transforms, polylist fan triangulation, material
binding and the emissive-proxy-light rule shared with the glTF path
(reference: assimp.rs:29-178 imports COLLADA through Assimp)."""
import math
import os

import numpy as np
import pytest

DAE = """<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><up_axis>Z_UP</up_axis></asset>
  <library_effects>
    <effect id="red-fx"><profile_COMMON><technique sid="common">
      <lambert>
        <diffuse><color>0.8 0.1 0.1 1</color></diffuse>
      </lambert>
    </technique></profile_COMMON></effect>
    <effect id="glow-fx"><profile_COMMON><technique sid="common">
      <phong>
        <emission><color>5 4 3 1</color></emission>
        <diffuse><color>0 0 0 1</color></diffuse>
        <shininess><float>50</float></shininess>
      </phong>
    </technique></profile_COMMON></effect>
  </library_effects>
  <library_materials>
    <material id="red-mat"><instance_effect url="#red-fx"/></material>
    <material id="glow-mat"><instance_effect url="#glow-fx"/></material>
  </library_materials>
  <library_geometries>
    <geometry id="quad"><mesh>
      <source id="quad-pos">
        <float_array id="quad-pos-arr" count="12">
          -1 -1 0  1 -1 0  1 1 0  -1 1 0</float_array>
      </source>
      <source id="quad-nrm">
        <float_array id="quad-nrm-arr" count="3">0 0 1</float_array>
      </source>
      <vertices id="quad-vtx">
        <input semantic="POSITION" source="#quad-pos"/>
      </vertices>
      <polylist material="SYM" count="1">
        <input semantic="VERTEX" source="#quad-vtx" offset="0"/>
        <input semantic="NORMAL" source="#quad-nrm" offset="1"/>
        <vcount>4</vcount>
        <p>0 0 1 0 2 0 3 0</p>
      </polylist>
    </mesh></geometry>
    <geometry id="tri"><mesh>
      <source id="tri-pos">
        <float_array id="tri-pos-arr" count="9">0 0 0  1 0 0  0 1 0</float_array>
      </source>
      <vertices id="tri-vtx">
        <input semantic="POSITION" source="#tri-pos"/>
      </vertices>
      <triangles material="SYM2" count="1">
        <input semantic="VERTEX" source="#tri-vtx" offset="0"/>
        <p>0 1 2</p>
      </triangles>
    </mesh></geometry>
  </library_geometries>
  <library_cameras>
    <camera id="cam"><optics><technique_common><perspective>
      <yfov>40</yfov><aspect_ratio>1.5</aspect_ratio>
    </perspective></technique_common></optics></camera>
  </library_cameras>
  <library_visual_scenes>
    <visual_scene id="vs">
      <node id="floor">
        <translate>0 0 2</translate>
        <scale>3 3 3</scale>
        <instance_geometry url="#quad">
          <bind_material><technique_common>
            <instance_material symbol="SYM" target="#red-mat"/>
          </technique_common></bind_material>
        </instance_geometry>
      </node>
      <node id="lamp">
        <instance_geometry url="#tri">
          <bind_material><technique_common>
            <instance_material symbol="SYM2" target="#glow-mat"/>
          </technique_common></bind_material>
        </instance_geometry>
      </node>
      <node id="camnode">
        <translate>0 -5 1</translate>
        <rotate>1 0 0 90</rotate>
        <instance_camera url="#cam"/>
      </node>
    </visual_scene>
  </library_visual_scenes>
  <scene><instance_visual_scene url="#vs"/></scene>
</COLLADA>
"""


@pytest.fixture(scope="module")
def dae_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("dae") / "test.dae"
    p.write_text(DAE)
    return str(p)


def test_collada_parse(dae_path):
    from rust_raytracer_jax.utils import collada

    gs = collada.load(dae_path)
    assert len(gs.instances) == 2
    assert len(gs.materials) == 2

    # quad: polylist fan-triangulated to 2 tris, expanded corners
    (prim_q, world_q, tpos_q) = [
        i for i in gs.instances if i[0].indices.shape[0] == 2][0]
    assert prim_q.positions.shape == (6, 3)
    assert prim_q.normals.shape == (6, 3)
    # world transform: Z_UP fix (y<->z, negate new z) o translate(0,0,2)
    # o scale(3): local (-1,-1,0) -> scaled (-3,-3,0) -> +t (-3,-3,2)
    # -> Z_UP fix (-3, 2, 3)
    v0 = world_q[:3, :3] @ prim_q.positions[0] + world_q[:3, 3]
    np.testing.assert_allclose(v0, [-3.0, 2.0, 3.0], atol=1e-6)
    np.testing.assert_allclose(tpos_q, [0.0, 2.0, 0.0], atol=1e-6)
    m_q = gs.materials[prim_q.material]
    np.testing.assert_allclose(m_q.base_color, (0.8, 0.1, 0.1))
    assert m_q.roughness == 1.0  # lambert

    # emissive triangle
    (prim_t, _, _) = [
        i for i in gs.instances if i[0].indices.shape[0] == 1][0]
    m_t = gs.materials[prim_t.material]
    np.testing.assert_allclose(m_t.emissive, (5.0, 4.0, 3.0))
    assert abs(m_t.roughness - math.sqrt(2.0 / 52.0)) < 1e-6

    # camera: node at (0,-5,1) with +90deg X rotation; Z_UP fix maps the
    # position to (0, 1, 5); the rotated -Z look direction maps to -Y
    # in COLLADA space = world (0, -1, ...) after the up fix
    assert gs.camera is not None
    np.testing.assert_allclose(gs.camera.position, [0.0, 1.0, 5.0],
                               atol=1e-6)
    assert abs(gs.camera.yfov - math.radians(40)) < 1e-9
    assert gs.camera.aspect == 1.5


def test_collada_scene_assembly(dae_path):
    """model:path.dae -> SceneDef through the shared assembly: meshes
    with baked transforms, emissive mesh -> Emissive material + proxy
    light, camera -> config."""
    from rust_raytracer_jax.scene import graph as g
    from rust_raytracer_jax.utils import model_import

    sd = model_import.load_model(dae_path)
    meshes = [o for o in sd.world.items if isinstance(o, g.Mesh)]
    assert len(meshes) == 2
    tri_counts = sorted(m.triangles.shape[0] for m in meshes)
    assert tri_counts == [1, 2]
    emissive = [m for m in meshes if isinstance(m.material, g.Emissive)]
    assert len(emissive) == 1
    proxies = [l for l in sd.lights if isinstance(l, g.ProxySphereLight)]
    assert len(proxies) == 1
    assert "camera_pos" in sd.config and "focal_length" in sd.config

    # the quad's world-baked vertices survive assembly: scale 3 spans
    # x/z in [-3, 3], the +2 COLLADA-z translate becomes world y = 2
    quad = [m for m in meshes if m.triangles.shape[0] == 2][0]
    np.testing.assert_allclose(quad.vertices[0], [-3.0, 2.0, 3.0],
                               atol=1e-6)
    np.testing.assert_allclose(np.unique(quad.vertices[:, 1]), [2.0],
                               atol=1e-6)

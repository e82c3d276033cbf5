"""Scene DSL parity: load the reference's actual scene files
(reference: scenes/*, grammar: docs/scene_dsl.md, loaders/scene.rs) and
compile them to device packs."""
import os

import numpy as np
import pytest

from rust_raytracer_jax.scene import compiler as sc
from rust_raytracer_jax.scene import dsl

SCENES_DIR = os.environ.get("RRT_SCENES_ROOT", "/root/reference/scenes")

# scene file -> assets it needs (skip if stripped from the mount)
REFERENCE_SCENES = {
    "test": [],
    "cornell": [],
    "tonemap_test": [],
    "earth": ["resource/earthmap.jpg"],
    "light_test": ["resource/monkey.obj"],
    "perlin": ["resource/monkey.obj"],
    "texture_test": ["resource/monkey.obj", "resource/rust_albedo.png"],
    "cornell_dragon": ["resource/dragon_high.obj"],
    "cornell_flircle": ["resource/flircle.obj"],
}


def _available(name):
    path = os.path.join(SCENES_DIR, name)
    if not os.path.exists(path):
        return False
    return all(
        os.path.exists(os.path.join(SCENES_DIR, a))
        for a in REFERENCE_SCENES[name]
    )


@pytest.mark.parametrize("name", sorted(REFERENCE_SCENES))
def test_load_reference_scene(name):
    if not _available(name):
        pytest.skip(f"{name}: file or assets stripped from reference mount")
    scene = dsl.load_scene_file(os.path.join(SCENES_DIR, name))
    assert scene.world is not None and scene.lights
    pack, static = sc.compile_scene(scene)
    # compiled scene has at least one primitive and one light
    n_prims = (
        pack.sph_center.shape[0] + pack.pln_corner.shape[0]
        + pack.tri_v0.shape[0] + pack.vol_kind.shape[0]
        + pack.sky_tex.shape[0] + pack.sun_dir.shape[0]
    )
    assert n_prims > 0
    assert len(static.light_list) > 0


# The reference's scenes/cornell, inlined so the test checks the parser
# rather than a mounted file.
CORNELL_DSL = """
@config output_width = 600
@config aspect_ratio = 1/1
@config focal_length = 33
@config camera_pos = 277.5,277.5,-800
@config camera_target = 277.5,277.5,0

white: lambertian (constant 0.73,0.73,0.73)
green: lambertian (constant 0.12,0.45,0.15)
red: lambertian (constant 0.65,0.05,0.05)
light: emissive (constant 15,15,15)
glass: glass 1.5
floor_rough: checker (constant 0) (constant 1) 0.25
floor_mat: glossy (constant 0.95,0.95,0.95) $floor_rough 1.5

floor: plane 277.5,0,277.5 277.5,0,0 0,0,-277.5 $floor_mat
ceiling: plane 277.5,555,277.5 277.5,0,0 0,0,277.5 $white
back: plane 277.5,277.5,555 0,277.5,0 277.5,0,0 $white
left: plane 555,277.5,277.5 0,277.5,0 0,0,-277.5 $green
right: plane 0,277.5,277.5 0,277.5,0 0,0,277.5 $red
lamp: plane 277.5,554.9,277.5 -65,0,0 0,0,-52.5 $light backface
box: box 0,0,0 165,330,165 $white
box: transform $box t=82.5,165,82.5 ry=18 t=265,0,295
ball: sphere 212.5,82.51,147.5 82.5 $glass

world: list $floor $ceiling $back $left $right $lamp $box $ball
lights: list $lamp $ball
"""


def test_cornell_structure():
    scene = dsl.SceneLoader().load(CORNELL_DSL)
    pack, static = sc.compile_scene(scene)
    # 6 walls/floor/ceiling/back + light + 6 box planes = 12 planes, 1 sphere
    assert pack.pln_corner.shape[0] == 12
    assert pack.sph_center.shape[0] == 1
    assert len(static.light_list) == 2
    # config directives applied
    assert scene.config["output_width"] == 600
    assert scene.config["camera_pos"] == (277.5, 277.5, -800.0)
    np.testing.assert_allclose(scene.config["aspect_ratio"], 1.0)


def test_dsl_errors_and_warnings():
    loader = dsl.SceneLoader()
    # bad lines warn + skip; missing world/lights raises
    with pytest.raises(dsl.DslError):
        loader.load("garbage here\nsky: sky (constant 1,1,1)\n")


def test_dsl_label_rebinding():
    """transform referencing its own label then rebinding (cornell's
    `box: transform $box ...` idiom)."""
    text = """
mat: lambertian (constant 0.5,0.5,0.5)
ball: sphere 0,0,0 1 $mat
ball: transform $ball t=5,0,0
sky: sky (constant 1,1,1)
world: list $ball $sky
lights: list $sky
"""
    scene = dsl.SceneLoader().load(text)
    pack, _ = sc.compile_scene(scene)
    np.testing.assert_allclose(
        np.asarray(pack.sph_center), [[5.0, 0.0, 0.0]], atol=1e-6
    )

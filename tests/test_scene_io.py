"""Scene pipeline tests: JSON parsing schema parity, OBJ loading, scene
compilation, camera math, image codecs."""
import pathlib

import numpy as np
import pytest

from owl_path_tracer.models.camera import make_camera
from owl_path_tracer.models.scene import compile_scene
from owl_path_tracer.utils import image as img_mod
from owl_path_tracer.utils import obj as obj_mod
from owl_path_tracer.utils import parser

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"


@pytest.fixture(scope="module", autouse=True)
def ensure_assets():
    import sys

    sys.path.insert(0, str(ASSETS))
    import generate

    generate.ensure_assets()


def test_parse_settings_reference_schema():
    s = parser.parse_settings(ASSETS / "settings.json")
    assert s.scene == "car"
    assert s.buffer_size == (1080, 1440)
    assert s.max_samples == 12288
    assert s.max_path_depth == 16
    assert s.test is not None
    assert s.test.material_name == "Light"
    assert s.test.attribute_name == "subsurface"
    assert s.test.step_size == 0.25
    assert s.test.flt_values == [0.0, 1.0]


def test_parse_materials_cornell():
    mats = parser.parse_materials(ASSETS / "cornell-box.json")
    names = [m.name for m in mats]
    assert names == ["box", "sphere", "light", "wall_left", "wall_right", "wall_tbb"]
    light = mats[2]
    assert light.params["emission"] == 15.0
    green = mats[3]
    np.testing.assert_allclose(green.base_color, (0.25, 0.886, 0.254))


def test_parse_camera_and_basis():
    cam_desc = parser.parse_camera(ASSETS / "sphere.json")
    cam = make_camera(cam_desc, (640, 480))
    o = np.asarray(cam.origin)
    np.testing.assert_allclose(o, [3, 1, 0])
    # ray through image center ~ towards look_at
    center = np.asarray(cam.llc) + 0.5 * np.asarray(cam.horizontal) + 0.5 * np.asarray(cam.vertical)
    d = center - o
    d /= np.linalg.norm(d)
    want = np.asarray([0, 1, 0.0]) - o
    want /= np.linalg.norm(want)
    np.testing.assert_allclose(d, want, atol=1e-6)
    # vertical extent matches fov: |vertical| = 2*tan(fov/2)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(cam.vertical)), 2 * np.tan(np.deg2rad(50) / 2), rtol=1e-5
    )


def test_obj_loader_cornell():
    meshes = obj_mod.load_obj(ASSETS / "cornell-box.obj.scene")
    names = [n for n, _ in meshes]
    assert names == ["box", "wall_left", "wall_right", "wall_tbb", "sphere", "light"]
    total = sum(len(m.indices) for _, m in meshes)
    assert total == 17974  # SURVEY.md section 2 row 21
    for _, m in meshes:
        assert m.indices.min() >= 0 and m.indices.max() < len(m.vertices)
        assert len(m.normals) == len(m.vertices)


def test_obj_roundtrip(tmp_path):
    meshes = obj_mod.load_obj(ASSETS / "cube.obj.scene")
    p = tmp_path / "rt.obj"
    obj_mod.save_obj(p, meshes)
    again = obj_mod.load_obj(p)
    assert [n for n, _ in again] == [n for n, _ in meshes]
    for (_, a), (_, b) in zip(meshes, again):
        np.testing.assert_allclose(a.vertices, b.vertices, atol=1e-5)
        np.testing.assert_array_equal(a.indices, b.indices)


def test_compile_scene_cornell():
    scene = compile_scene(ASSETS, "cornell-box", (64, 64))
    assert scene.num_tris == 17974
    assert scene.materials.count == 6
    em = np.asarray(scene.emissive_tris)
    assert (em >= 0).all() and len(em) == 2  # the 2-triangle area light
    tri_mat = np.asarray(scene.tri_mat)
    assert set(np.unique(tri_mat)) == {0, 1, 2, 3, 4, 5}


def test_compile_scene_cube_texture():
    scene = compile_scene(ASSETS, "cube", (32, 32))
    mat_tex = np.asarray(scene.mat_tex)
    assert (mat_tex >= 0).any()
    assert scene.textures.shape[-1] == 3 and scene.textures.shape[1] > 1


def test_hdr_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = (rng.random((16, 32, 3)) * 10).astype(np.float32)
    p = tmp_path / "t.hdr"
    img_mod.write_hdr(p, img)
    back = img_mod.read_hdr(p)
    assert back.shape == img.shape
    # RGBE: 8-bit shared-exponent mantissa => error up to max-channel/256
    err = np.abs(back - img)
    bound = img.max(axis=-1, keepdims=True) / 256 + 1e-3
    assert (err <= bound).all()


def test_generated_environment_loads():
    env = img_mod.load_environment(ASSETS / "environment.hdr")
    assert env.ndim == 3 and env.shape[2] == 3
    assert env.max() > 10  # sun disk is HDR-bright
    assert np.isfinite(env).all()


def test_quantize_rgba8_owl_semantics():
    rgb = np.asarray([[[0.0, 0.5, 1.0]], [[2.0, -1.0, 0.999]]], np.float32)
    q = img_mod.quantize_rgba8(rgb)
    assert q[0, 0, 0] == 0 and q[0, 0, 2] == 255
    assert q[1, 0, 0] == 255 and q[1, 0, 1] == 0  # clamped
    assert q[0, 0, 1] == int(0.5 * 255.99)
    assert (q[..., 3] == 255).all()

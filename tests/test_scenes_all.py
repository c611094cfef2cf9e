"""Every reference scene config loads, compiles, and renders finite images --
the closest thing to the reference's de-facto integration test (SURVEY
section 4.2), exercising glass (car: WindowGlassMat st=1), textures (cube,
car Ground), emissives (cornell light, dragon/car Light), and env maps."""
import pathlib

import numpy as np
import pytest

from owl_path_tracer.models.scene import RenderSettings, compile_scene
from owl_path_tracer.ops.debug import validate_scene
from owl_path_tracer.render import film as film_mod

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"


@pytest.fixture(scope="module", autouse=True)
def ensure_assets():
    import sys

    sys.path.insert(0, str(ASSETS))
    import generate

    generate.ensure_assets()


SCENES = ["sphere", "cube", "cornell-box", "dragon", "mitsuba", "car"]


@pytest.mark.parametrize("scene_name", SCENES)
def test_scene_renders_finite(scene_name):
    scene = compile_scene(ASSETS, scene_name, (24, 24))
    assert validate_scene(scene) == []
    s = RenderSettings(width=24, height=24, max_samples=2, max_path_depth=4,
                       environment_auto=True, environment_intensity=1.0)
    accel = film_mod.make_accel(scene, "cluster", cluster_size=64)
    img = film_mod.render_image(scene, s, pixel_chunk=576, accel=accel)
    assert np.isfinite(img).all()
    assert img.mean() > 0.01  # something visible


def test_car_scene_has_glass_and_light():
    scene = compile_scene(ASSETS, "car", (16, 16))
    st = np.asarray(scene.materials.specular_transmission)
    em = np.asarray(scene.materials.emission)
    assert (st == 1.0).any()  # WindowGlassMat
    assert (em > 0).any()  # Light (emission 10)
    assert (np.asarray(scene.mat_tex) >= 0).any()  # Ground texture slot
    # NEE render with its light
    s = RenderSettings(width=16, height=16, max_samples=2, max_path_depth=3,
                       environment_color=(0, 0, 0), environment_intensity=0.0,
                       use_nee=True)
    accel = film_mod.make_accel(scene, "cluster", cluster_size=64)
    img = film_mod.render_image(scene, s, pixel_chunk=256, accel=accel)
    assert np.isfinite(img).all()


def test_mitsuba_material_recovery_smoke():
    """BASELINE config 5 shape: differentiable recovery on the mitsuba scene
    (tiny res / few steps -- the full run is tools/recover_demo.py)."""
    import jax.numpy as jnp

    from owl_path_tracer.render import diff as diff_mod

    scene = compile_scene(ASSETS, "mitsuba", (12, 12))
    s = RenderSettings(width=12, height=12, max_samples=2, max_path_depth=2,
                       environment_auto=True, environment_intensity=1.0)
    accel = film_mod.make_accel(scene, "cluster", cluster_size=128)
    x, y = np.meshgrid(np.arange(12, dtype=np.int32), np.arange(12, dtype=np.int32))
    px = jnp.asarray(np.stack([x.ravel(), y.ravel()], -1))
    target = diff_mod.render_with_materials(scene, scene.materials, s, px, 2, accel)

    # perturb 'outside' albedo, take a few recovery steps, loss must drop
    import jax

    mats0 = scene.materials._replace(
        base_color=scene.materials.base_color.at[0].set(jnp.asarray([0.5, 0.5, 0.5]))
    )
    res = diff_mod.recover_materials(
        scene, s, target, px, mats0, steps=10, lr=0.1, num_samples=2,
        accel=accel, trainable=("base_color",),
    )
    assert res.losses[-1] < res.losses[0]

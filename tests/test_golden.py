"""Golden-IMAGE regression tests: full committed arrays, every intersector.

The renders are deterministic (fixed LCG streams), so low-spp renders are
bit-stable; the committed ``tests/goldens/*.npy`` images (produced by the
brute-force intersector, tools/make_goldens.py) lock in behavior so refactors
(new intersectors, Pallas kernels, sharding) can't silently change output.

brute / bvh / cluster reproduce the goldens BITWISE (shared mt_components op
order).  fused2 computes hit positions as ``o + t*d`` instead of the
barycentric lerp (render/integrator.py _fetch_surface_blob), so it is asserted
within a tight tolerance instead.

This is the repo's version of the reference's image-series verification
(application.cpp:370), made automatic -- the reference had no golden tests at
all (unit_tests/path_tracer_test.cu is a placeholder).
"""
import pathlib

import numpy as np
import pytest

from owl_path_tracer.models.scene import RenderSettings, compile_scene
from owl_path_tracer.render import film as film_mod

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"

CORNELL = RenderSettings(
    width=48, height=48, max_samples=4, max_path_depth=4,
    environment_color=(0, 0, 0), environment_intensity=0.0,
)
SPHERE = RenderSettings(
    width=48, height=48, max_samples=4, max_path_depth=3,
    environment_auto=True, environment_intensity=1.0,
)
CUBE = RenderSettings(  # textured scene (base-color texture lookup path)
    width=48, height=48, max_samples=4, max_path_depth=3,
    environment_auto=True, environment_intensity=1.0,
)

CONFIGS = {
    "cornell-box": ("cornell-box", CORNELL),
    "sphere": ("sphere", SPHERE),
    "cube": ("cube", CUBE),
}


@pytest.fixture(scope="module", autouse=True)
def ensure_assets():
    import sys

    sys.path.insert(0, str(ASSETS))
    import generate

    generate.ensure_assets()


def render(scene_name, settings, intersector):
    scene = compile_scene(ASSETS, scene_name, (settings.width, settings.height))
    accel = film_mod.make_accel(scene, intersector, cluster_size=64)
    return film_mod.render_image(scene, settings, pixel_chunk=4096, accel=accel)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("intersector", ["brute", "bvh", "cluster"])
def test_golden_image_exact(config, intersector):
    scene_name, settings = CONFIGS[config]
    img = render(scene_name, settings, intersector)
    golden = np.load(GOLDENS / f"{config}.npy")
    np.testing.assert_array_equal(img, golden)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_golden_image_fused2(config):
    scene_name, settings = CONFIGS[config]
    img = render(scene_name, settings, "fused2")
    golden = np.load(GOLDENS / f"{config}.npy")
    assert np.isfinite(img).all()
    # o+t*d hit positions perturb secondary rays by ~1 ulp; the estimator is
    # identical, so pixels agree tightly except (rarely) where a bounce ray
    # grazes a silhouette
    close = np.isclose(img, golden, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.995, f"{config}: only {close.mean():.4%} pixels match"
    np.testing.assert_allclose(img.mean(), golden.mean(), rtol=1e-3)

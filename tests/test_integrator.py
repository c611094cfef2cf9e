"""Integrator end-to-end tests: furnace, emissive termination, checkpoint
resume determinism -- the automated versions of the reference's visual-only
checks (SURVEY.md section 4)."""
import numpy as np
import jax.numpy as jnp
import pytest

from owl_path_tracer.models import material as material_mod
from owl_path_tracer.models.camera import CameraData, make_camera
from owl_path_tracer.models.scene import RenderSettings, scene_from_arrays
from owl_path_tracer.render import film as film_mod
from owl_path_tracer.utils.parser import CameraDesc


def make_sphere_mesh(center, radius, n_theta=24, n_phi=48):
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    n = np.stack([np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)], -1).reshape(-1, 3)
    v = center + radius * n
    idx = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = (i + 1) * n_phi + j
            c = (i + 1) * n_phi + (j + 1) % n_phi
            d = i * n_phi + (j + 1) % n_phi
            if i > 0:
                idx.append((a, b, d))
            if i < n_theta - 1:
                idx.append((b, c, d))
    return v.astype(np.float32), np.asarray(idx, np.int32), n.astype(np.float32)


def sphere_scene(mat, radius=1.0):
    v, idx, n = make_sphere_mesh(np.zeros(3), radius)
    cam = make_camera(
        CameraDesc(look_from=(3, 0, 0), look_at=(0, 0, 0), look_up=(0, 1, 0), vertical_fov=45),
        (32, 32),
    )
    return scene_from_arrays(v, idx, mat, np.zeros(len(idx), np.int32), cam, normals=n)


def render(scene, settings, spp=None):
    return film_mod.render_image(scene, settings, spp=spp, pixel_chunk=1024)


def test_white_furnace_diffuse():
    """Convex diffuse sphere (albedo 1, roughness 0) in a unit-white constant
    environment: every path escapes after one bounce, so pixel values equal
    1 * (fd-term) which for roughness 0 is <= 1 and close to 1 on average.
    The image must be finite, positive, and near white."""
    mat = material_mod.single(base_color=(1, 1, 1), roughness=0.0, specular=0.0)
    scene = sphere_scene(mat)
    s = RenderSettings(
        width=32, height=32, max_samples=8, max_path_depth=3,
        environment_color=(1, 1, 1), environment_intensity=1.0,
    )
    img = render(scene, s)
    assert np.isfinite(img).all()
    # background pixels exactly 1
    corner = img[0, 0]
    np.testing.assert_allclose(corner, 1.0, atol=1e-5)
    # sphere pixels: Disney diffuse at roughness 0 loses a little energy at
    # grazing angles, none at normal incidence
    center = img[16, 16]
    assert 0.9 <= center.mean() <= 1.02, center
    assert img.mean() > 0.9


def test_emissive_sphere_monochrome():
    """Emissive hit writes scalar emission as gray radiance and terminates
    (device.cu:157-161) -- even though base_color is red."""
    mat = material_mod.single(base_color=(1, 0, 0), emission=5.0)
    scene = sphere_scene(mat)
    s = RenderSettings(width=32, height=32, max_samples=2, max_path_depth=4,
                       environment_color=(0, 0, 0), environment_intensity=0.0)
    img = render(scene, s)
    center = img[16, 16]
    np.testing.assert_allclose(center, 5.0, atol=1e-4)  # monochrome, not red
    np.testing.assert_allclose(img[0, 0], 0.0, atol=1e-6)  # black background


def test_black_environment_intensity_zero():
    mat = material_mod.single()
    scene = sphere_scene(mat)
    s = RenderSettings(width=32, height=32, max_samples=2, max_path_depth=2,
                       environment_color=(1, 1, 1), environment_intensity=0.0)
    img = render(scene, s)
    np.testing.assert_allclose(img, 0.0, atol=1e-6)


def test_auto_sky_gradient_background():
    mat = material_mod.single()
    scene = sphere_scene(mat, radius=0.1)
    s = RenderSettings(width=32, height=32, max_samples=1, max_path_depth=2,
                       environment_auto=True, environment_intensity=1.0)
    img = render(scene, s)
    # top of image should be bluer than bottom (sky gradient on y direction)
    assert img[0, 0, 2] >= img[-1, 0, 2] - 1e-5
    assert np.isfinite(img).all()


def test_checkpoint_resume_matches_one_shot():
    """spp-chunked accumulation with carried RNG equals one-shot rendering up
    to f32 summation order (the RNG stream itself is bit-identical) -- the
    progressive/checkpoint capability the reference lacks."""
    mat = material_mod.single(base_color=(0.7, 0.5, 0.3), roughness=0.8)
    scene = sphere_scene(mat)
    s = RenderSettings(width=16, height=16, max_samples=8, max_path_depth=3,
                       environment_color=(1, 1, 1), environment_intensity=0.7)
    one_shot = film_mod.render_image(scene, s, pixel_chunk=256)

    film = film_mod.new_film(s)
    film = film_mod.add_samples(scene, s, film, 3, pixel_chunk=256)
    film = film_mod.add_samples(scene, s, film, 5, pixel_chunk=256)
    resumed = film_mod.finalize(film)
    np.testing.assert_allclose(one_shot, resumed, rtol=1e-5, atol=1e-6)


def test_rr_quirk_darkens_deep_paths():
    """Parity RR (inverted, uncompensated, device.cu:209-214) must kick in
    after depth>3: a high-depth render inside a white furnace is darker than
    the theoretical 1.0 -- this asserts the quirk is present, not absent."""
    # concave setup: put camera INSIDE a large sphere so paths keep bouncing
    mat = material_mod.single(base_color=(1, 1, 1), roughness=1.0)
    v, idx, n = make_sphere_mesh(np.zeros(3), 4.0)
    cam = make_camera(
        CameraDesc(look_from=(0, 0, 0), look_at=(1, 0, 0), look_up=(0, 1, 0), vertical_fov=45),
        (8, 8),
    )
    scene = scene_from_arrays(v, idx, mat, np.zeros(len(idx), np.int32), cam, normals=-n)
    s = RenderSettings(width=8, height=8, max_samples=16, max_path_depth=12,
                       environment_color=(1, 1, 1), environment_intensity=1.0)
    img = render(scene, s)
    # every path should be killed by RR (survive prob ~5% per bounce past 3)
    # before escaping the closed sphere; radiance well below 1
    assert img.mean() < 0.5, img.mean()
    assert np.isfinite(img).all()


def test_corrected_mode_furnace_with_metal():
    """Corrected mode (VNDF + mixture pdf + compensated estimator) on a
    smooth metal sphere in a white furnace: metal with base_color 1 and G/F
    energy loss should still land near 1 and never exceed it much."""
    mat = material_mod.single(base_color=(1, 1, 1), metallic=1.0, roughness=0.3, specular=0.0)
    scene = sphere_scene(mat)
    s = RenderSettings(width=32, height=32, max_samples=16, max_path_depth=4,
                       environment_color=(1, 1, 1), environment_intensity=1.0,
                       parity=False)
    img = render(scene, s)
    assert np.isfinite(img).all()
    center = img[12:20, 12:20].mean()
    assert 0.75 <= center <= 1.05, center


def test_corrected_vs_parity_diffuse_identical():
    """For a pure-diffuse scene the corrected sampler degenerates to the
    parity one (p_diff=1, consistent pdf): images must be bit-identical."""
    mat = material_mod.single(base_color=(0.6, 0.5, 0.4), roughness=0.9, specular=0.0)
    scene = sphere_scene(mat)
    base = dict(width=16, height=16, max_samples=4, max_path_depth=3,
                environment_color=(1, 1, 1), environment_intensity=1.0)
    img_p = render(scene, RenderSettings(**base, parity=True))
    img_c = render(scene, RenderSettings(**base, parity=False))
    np.testing.assert_array_equal(img_p, img_c)


@pytest.mark.parametrize("rough,lo,hi", [(0.0, 0.85, 1.05), (1.0, 0.12, 0.45)])
def test_furnace_metal_lobe(rough, lo, hi):
    """Automated version of the thesis furnace images (furnace_test_*.png):
    pure metal sphere, white furnace.  Bounds from the measured directional
    albedo of this single-scattering formulation: ~1 at mirror roughness,
    ~0.19 at alpha=1 (G2/G1 loss + discarded below-horizon reflections; no
    multiple-scattering compensation, same class of darkening the reference
    exhibits)."""
    mat = material_mod.single(base_color=(1, 1, 1), metallic=1.0,
                              roughness=rough, specular=0.0)
    scene = sphere_scene(mat)
    s = RenderSettings(width=24, height=24, max_samples=12, max_path_depth=3,
                       environment_color=(1, 1, 1), environment_intensity=1.0,
                       parity=False)
    img = render(scene, s)
    assert np.isfinite(img).all()
    center = img[8:16, 8:16].mean()
    assert lo <= center <= hi, (rough, center)
    assert img.max() < 2.5


def test_furnace_glass_transmission():
    """Glass sphere in a furnace: transmission+reflection should roughly
    conserve (sqrt(base_color)=1 tint, eta^2 terms cancel over the path)."""
    mat = material_mod.single(base_color=(1, 1, 1), metallic=0.0,
                              specular_transmission=1.0, roughness=0.1,
                              specular_transmission_roughness=0.0, ior=1.5)
    scene = sphere_scene(mat)
    s = RenderSettings(width=24, height=24, max_samples=24, max_path_depth=8,
                       environment_color=(1, 1, 1), environment_intensity=1.0)
    img = render(scene, s)
    assert np.isfinite(img).all()
    center = img[10:14, 10:14].mean()
    assert 0.5 <= center <= 1.6, center

"""NEE + MIS tests: the promoted lights.hpp machinery must agree with the
brute-force (BSDF-sampling-only) estimator in expectation, with less noise."""
import numpy as np
import jax.numpy as jnp
import pytest

from owl_path_tracer.models import lights as lights_mod
from owl_path_tracer.models import material as material_mod
from owl_path_tracer.models.camera import make_camera
from owl_path_tracer.models.scene import RenderSettings, scene_from_arrays
from owl_path_tracer.render import film as film_mod
from owl_path_tracer.utils.parser import CameraDesc
import jax


def box_with_light(emission=20.0, light_size=0.4):
    """Closed diffuse box (side 4) with a small ceiling light."""
    s = 2.0
    # 6 walls, normals inward
    quads = [
        ([-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]),  # floor
        ([-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]),  # ceiling
        ([-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]),  # back
        ([s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]),  # front
        ([-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]),  # left
        ([s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]),  # right
    ]
    verts, idx, mats = [], [], []

    def add_quad(q, mat, want_normal):
        # orient winding so the face normal points along want_normal
        p = np.asarray(q, np.float32)
        n = np.cross(p[1] - p[0], p[2] - p[0])
        if np.dot(n, want_normal) < 0:
            p = p[::-1]
        b = len(verts)
        verts.extend(p.tolist())
        idx.extend([[b, b + 1, b + 2], [b, b + 2, b + 3]])
        mats.extend([mat, mat])

    inward = [(0, 1, 0), (0, -1, 0), (0, 0, -1), (0, 0, 1), (1, 0, 0), (-1, 0, 0)]
    for q, n in zip(quads, inward):
        add_quad(q, 0, np.asarray(n, np.float32))
    # light quad just under the ceiling, facing down
    ls = light_size
    add_quad(
        [[-ls, s - 0.01, -ls], [-ls, s - 0.01, ls], [ls, s - 0.01, ls], [ls, s - 0.01, -ls]],
        1,
        np.asarray((0, -1, 0), np.float32),
    )

    wall = material_mod.single(base_color=(0.7, 0.7, 0.7), roughness=1.0, specular=0.0)
    light = material_mod.single(base_color=(1, 1, 1), emission=emission)
    materials = jax.tree.map(lambda *xs: jnp.concatenate(xs), wall, light)
    cam = make_camera(
        CameraDesc(look_from=(0, 0, 1.8), look_at=(0, 0, -1), look_up=(0, 1, 0), vertical_fov=60),
        (32, 32),
    )
    return scene_from_arrays(
        np.asarray(verts, np.float32), np.asarray(idx, np.int32), materials,
        np.asarray(mats, np.int32), cam,
    )


def test_light_table_extraction():
    scene = box_with_light()
    lt = lights_mod.build_light_table(scene)
    assert lt is not None and lt.count == 2
    np.testing.assert_allclose(np.asarray(lt.emission), 20.0)
    np.testing.assert_allclose(np.asarray(lt.area).sum(), 2 * 0.5 * (0.8 * 0.8), rtol=1e-5)


def test_power_heuristic_properties():
    ph = lights_mod.power_heuristic
    a = np.asarray(ph(1.0, jnp.asarray([2.0]), 1.0, jnp.asarray([2.0])))
    np.testing.assert_allclose(a, 0.5)
    # weights sum to 1
    w1 = np.asarray(ph(1.0, jnp.asarray([3.0]), 1.0, jnp.asarray([0.7])))
    w2 = np.asarray(ph(1.0, jnp.asarray([0.7]), 1.0, jnp.asarray([3.0])))
    np.testing.assert_allclose(w1 + w2, 1.0, atol=1e-6)
    # zero/zero well-defined
    assert np.asarray(ph(1.0, jnp.asarray([0.0]), 1.0, jnp.asarray([0.0])))[0] == 0.0


def test_sample_lights_pdf_geometry():
    scene = box_with_light()
    lt = lights_mod.build_light_table(scene)
    target = jnp.asarray(np.tile([[0.0, -1.9, 0.0]], (4096, 1)).astype(np.float32))
    r = np.random.default_rng(0)
    u3 = jnp.asarray(r.random((4096, 3), np.float32))
    ls = lights_mod.sample_lights(lt, target, u3)
    d = np.asarray(ls.direction)
    assert (d[:, 1] > 0).all()  # light is above
    # MC integral of 1/pdf over light solid angle = solid angle of light
    pdf = np.asarray(ls.pdf)
    assert (pdf > 0).all()
    # solid angle approx: area * cos / dist^2 for a small light
    dist = np.asarray(ls.distance).mean()
    expect_sa = (0.8 * 0.8) / dist**2  # light faces straight down, cos~1
    mc_sa = (1.0 / pdf).mean()
    np.testing.assert_allclose(mc_sa, expect_sa, rtol=0.05)


def test_nee_matches_bsdf_sampling_in_expectation():
    """Same scene, NEE on vs off: means must agree within MC error, and NEE
    variance must be substantially lower (that is the whole point)."""
    scene = box_with_light()
    base = dict(width=32, height=32, max_path_depth=3)
    s_ref = RenderSettings(**base, max_samples=512, environment_intensity=0.0,
                           environment_color=(0, 0, 0))
    s_nee = RenderSettings(**base, max_samples=32, environment_intensity=0.0,
                           environment_color=(0, 0, 0), use_nee=True)
    img_ref = film_mod.render_image(scene, s_ref, pixel_chunk=1024)
    img_nee = film_mod.render_image(scene, s_nee, pixel_chunk=1024)
    # direct-lit floor region must match in expectation (exclude the light
    # itself and deep-shadow corners)
    mask = (img_ref.mean(-1) > 0.01) & (img_ref.mean(-1) < 5.0)
    assert mask.mean() > 0.5
    ref_mean = img_ref[mask].mean()
    nee_mean = img_nee[mask].mean()
    np.testing.assert_allclose(nee_mean, ref_mean, rtol=0.06)
    # noise: pixel-to-pixel variation in a flat region should be far lower for
    # NEE at 16x fewer samples
    flat = img_ref[20:28, 12:20].std()
    flat_nee = img_nee[20:28, 12:20].std()
    assert flat_nee < flat * 1.5


def test_nee_zero_without_lights():
    """No emissive tris -> NEE mode falls back to plain path tracing."""
    mat = material_mod.single(base_color=(0.5, 0.5, 0.5))
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.asarray([[0, 1, 2]], np.int32)
    cam = make_camera(CameraDesc((0, 0, 3), (0, 0, 0), (0, 1, 0), 45), (8, 8))
    scene = scene_from_arrays(v, idx, mat, np.zeros(1, np.int32), cam)
    s = RenderSettings(width=8, height=8, max_samples=2, max_path_depth=2,
                       environment_color=(1, 1, 1), environment_intensity=1.0, use_nee=True)
    img = film_mod.render_image(scene, s, pixel_chunk=64)
    assert np.isfinite(img).all()

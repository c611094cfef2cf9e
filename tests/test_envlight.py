"""Environment importance sampling tests."""
import numpy as np
import jax.numpy as jnp
import pytest

from owl_path_tracer.models import envlight as env_mod
from owl_path_tracer.models import material as material_mod
from owl_path_tracer.models.camera import make_camera
from owl_path_tracer.models.scene import RenderSettings, scene_from_arrays
from owl_path_tracer.ops import texture as tex
from owl_path_tracer.render import film as film_mod
from owl_path_tracer.utils.parser import CameraDesc
from test_integrator import make_sphere_mesh


def sun_env(h=64, w=128, sun_value=200.0):
    env = np.full((h, w, 3), 0.1, np.float32)
    env[40:44, 30:34] = sun_value  # small bright block
    return env


def test_cdf_sampler_distribution():
    env = sun_env()
    el = env_mod.build_env_light(env, 1.0)
    r = np.random.default_rng(0)
    u = jnp.asarray(r.random((50000, 2), np.float32))
    s = env_mod.sample_env(el, u)
    d = np.asarray(s.direction)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    # most samples should land on the sun block (it dominates the luminance)
    uv = np.asarray(tex.uv_on_sphere(jnp.asarray(d)))
    on_sun = (
        (uv[:, 0] * 128 >= 30) & (uv[:, 0] * 128 < 34)
        & (uv[:, 1] * 64 >= 40) & (uv[:, 1] * 64 < 44)
    )
    assert on_sun.mean() > 0.5
    assert (np.asarray(s.pdf) > 0).all()


def test_pdf_integrates_to_one():
    # smooth env (a spiky sun makes uniform-MC variance explode)
    r = np.random.default_rng(1)
    env = (0.2 + r.random((64, 128, 3)).astype(np.float32))
    el = env_mod.build_env_light(env, 1.0)
    # MC over uniform sphere: E[pdf / (1/4pi)] = 1
    v = r.normal(size=(200000, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pdf = np.asarray(env_mod.pdf_env_direction(el, jnp.asarray(v)))
    integral = pdf.mean() * 4 * np.pi
    np.testing.assert_allclose(integral, 1.0, rtol=0.02)
    # exact check: sum over texels of pdf * texel_omega == 1
    h, w = 64, 128
    edges = np.linspace(-np.pi / 2, np.pi / 2, h + 1)
    d_sin = np.sin(edges[1:]) - np.sin(edges[:-1])
    omega = (2 * np.pi / w) * d_sin[:, None]
    np.testing.assert_allclose(
        (np.asarray(el.pdf_map) * omega).sum(), 1.0, rtol=1e-4
    )


def test_sample_radiance_matches_lookup():
    env = sun_env()
    el = env_mod.build_env_light(env, 2.0)
    r = np.random.default_rng(2)
    u = jnp.asarray(r.random((1000, 2), np.float32))
    s = env_mod.sample_env(el, u)
    lookup = np.asarray(env_mod.env_radiance(el, s.direction))
    np.testing.assert_allclose(np.asarray(s.radiance), lookup, rtol=1e-4)


def test_env_nee_matches_bsdf_sampling():
    """Sphere under a sun env: NEE+envIS at low spp matches the BSDF-only
    estimator at high spp, with lower noise."""
    env = sun_env(sun_value=50.0)
    mat = material_mod.single(base_color=(0.8, 0.8, 0.8), roughness=1.0, specular=0.0)
    v, idx, n = make_sphere_mesh(np.zeros(3), 1.0)
    cam = make_camera(CameraDesc((3, 0, 0), (0, 0, 0), (0, 1, 0), 45), (24, 24))
    scene = scene_from_arrays(
        v, idx, mat, np.zeros(len(idx), np.int32), cam, normals=n, env_map=env
    )
    base = dict(width=24, height=24, max_path_depth=3,
                environment_use=True, environment_intensity=1.0)
    s_ref = RenderSettings(**base, max_samples=768)
    s_nee = RenderSettings(**base, max_samples=24, use_nee=True)
    img_ref = film_mod.render_image(scene, s_ref, pixel_chunk=576)
    img_nee = film_mod.render_image(scene, s_nee, pixel_chunk=576)
    # compare on the sphere region (center)
    ref = img_ref[8:16, 8:16].mean()
    nee = img_nee[8:16, 8:16].mean()
    np.testing.assert_allclose(nee, ref, rtol=0.08)
    assert np.isfinite(img_nee).all()

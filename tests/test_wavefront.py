"""Persistent-wavefront (path regeneration) renderer tests."""
import numpy as np
import jax.numpy as jnp

from owl_path_tracer.models import material as material_mod
from owl_path_tracer.models.scene import RenderSettings
from owl_path_tracer.render import film as film_mod
from owl_path_tracer.render import wavefront as wf
from test_integrator import sphere_scene


def test_wavefront_matches_standard_renderer():
    mat = material_mod.single(base_color=(0.7, 0.5, 0.3), roughness=0.8, specular=0.0)
    scene = sphere_scene(mat)
    s = RenderSettings(width=24, height=24, max_samples=16, max_path_depth=3,
                       environment_color=(1.0, 0.9, 0.8), environment_intensity=1.0)
    img_std = film_mod.render_image(scene, s, pixel_chunk=576)
    img_wf, rays = wf.render_image_wavefront(scene, s, lanes=2048, iters_per_launch=8)
    assert rays > 24 * 24 * 16  # primary + bounces
    # different RNG assignment -> MC-level agreement
    np.testing.assert_allclose(img_wf.mean(), img_std.mean(), rtol=0.02)
    # background (deterministic env, no noise) must match closely per-pixel
    np.testing.assert_allclose(img_wf[0, 0], img_std[0, 0], rtol=1e-5)
    assert np.isfinite(img_wf).all()


def test_wavefront_completes_all_work():
    mat = material_mod.single(base_color=(0.5, 0.5, 0.5))
    scene = sphere_scene(mat)
    s = RenderSettings(width=16, height=16, max_samples=3, max_path_depth=2,
                       environment_color=(1, 1, 1), environment_intensity=1.0)
    img, rays = wf.render_image_wavefront(scene, s, lanes=256, iters_per_launch=4)
    # every pixel got all its samples: background pixels exactly env value
    np.testing.assert_allclose(img[0, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(img[-1, -1], 1.0, atol=1e-5)


def test_wavefront_nee_matches_scan_nee():
    from test_nee import box_with_light
    scene = box_with_light()
    s = RenderSettings(width=16, height=16, max_samples=24, max_path_depth=3,
                       environment_intensity=0.0, environment_color=(0, 0, 0),
                       use_nee=True)
    img_std = film_mod.render_image(scene, s, pixel_chunk=256)
    img_wf, _ = wf.render_image_wavefront(scene, s, lanes=1024, iters_per_launch=8)
    lit = img_std.mean(-1) > 0.05
    assert lit.mean() > 0.3
    np.testing.assert_allclose(img_wf[lit].mean(), img_std[lit].mean(), rtol=0.05)


def test_spawn_rng_streams_do_not_collide():
    """(pixel, sample) seeds are two independent tea-hash words (VERDICT r1):
    all streams over a 256-pixel x 16-sample grid must be distinct."""
    import jax.numpy as jnp
    import numpy as np
    from owl_path_tracer.ops import rng as rng_mod

    pixels = jnp.arange(256, dtype=jnp.uint32).repeat(16)
    samples = jnp.tile(jnp.arange(16, dtype=jnp.uint32), 256)
    states = np.asarray(rng_mod.seed(pixels, samples))
    assert len(np.unique(states)) == states.size
    # and the per-sample streams of one pixel start at different draws
    v0, _ = rng_mod.next_f32(rng_mod.seed(jnp.uint32(7), jnp.uint32(0)))
    v1, _ = rng_mod.next_f32(rng_mod.seed(jnp.uint32(7), jnp.uint32(1)))
    assert float(v0) != float(v1)


def test_strided_film_matches_global_queue():
    """The scatter-free strided work assignment (acc [L,P,3]) must render the
    same image as the global-queue mode: per-(pixel,sample) RNG streams are
    work-id-determined, so only f32 film-summation order differs."""
    import numpy as np
    import jax.numpy as jnp
    from owl_path_tracer.render.wavefront import render_image_wavefront
    from test_integrator import make_sphere_mesh
    from owl_path_tracer.models import material as material_mod
    from owl_path_tracer.models.camera import make_camera
    from owl_path_tracer.models.scene import RenderSettings, scene_from_arrays
    from owl_path_tracer.utils.parser import CameraDesc

    mat = material_mod.single(base_color=(0.7, 0.5, 0.3), roughness=0.8)
    v, idx, n = make_sphere_mesh(np.zeros(3), 1.0)
    cam = make_camera(CameraDesc((3, 0, 0), (0, 0, 0), (0, 1, 0), 45), (16, 16))
    scene = scene_from_arrays(v, idx, mat, np.zeros(len(idx), np.int32), cam, normals=n)
    s = RenderSettings(width=16, height=16, max_samples=4, max_path_depth=3,
                       environment_color=(1, 0.9, 0.8), environment_intensity=1.0)
    # lanes=256 divides 16*16*4=1024 work items -> strided (P=1); lanes=1000
    # does not -> global queue
    img_strided, rays_s = render_image_wavefront(scene, s, lanes=256, iters_per_launch=4, strided=True)
    img_queue, rays_q = render_image_wavefront(scene, s, lanes=1000, iters_per_launch=4)
    np.testing.assert_allclose(img_strided, img_queue, rtol=1e-5, atol=1e-6)
    assert rays_s == rays_q


def test_windowed_film_banking_matches_scatter():
    """The one-hot-matmul window banking must equal the scatter path: same
    work items -> same per-item radiance; only f32 sum order differs."""
    import numpy as np
    from owl_path_tracer.render.wavefront import render_image_wavefront
    from test_integrator import make_sphere_mesh
    from owl_path_tracer.models import material as material_mod
    from owl_path_tracer.models.camera import make_camera
    from owl_path_tracer.models.scene import RenderSettings, scene_from_arrays
    from owl_path_tracer.utils.parser import CameraDesc

    mat = material_mod.single(base_color=(0.6, 0.4, 0.3), roughness=0.7)
    v, idx, n = make_sphere_mesh(np.zeros(3), 1.0)
    cam = make_camera(CameraDesc((3, 0, 0), (0, 0, 0), (0, 1, 0), 45), (64, 64))
    scene = scene_from_arrays(v, idx, mat, np.zeros(len(idx), np.int32), cam, normals=n)
    s = RenderSettings(width=64, height=64, max_samples=16, max_path_depth=3,
                       environment_color=(1, 0.9, 0.8), environment_intensity=1.0)
    # lanes=256: window W=(3+2)*256/16+2 -> 128 <= 4096 pixels -> WINDOW path
    # lanes=16384: W > 4096 -> scatter path
    img_win, rays_w = render_image_wavefront(scene, s, lanes=256, iters_per_launch=8)
    img_sc, rays_s = render_image_wavefront(scene, s, lanes=16384, iters_per_launch=8)
    np.testing.assert_allclose(img_win, img_sc, rtol=1e-5, atol=1e-6)
    assert rays_w == rays_s


def test_sorted_render_matches_unsorted():
    """The per-wave coherence sort (fused2_sort, the benchmark default) must
    render the same image as the unsorted path: the sort+unsort permutation
    is semantically the identity, so only f32 sum order differs."""
    import numpy as np
    from owl_path_tracer.ops.fused2 import build_fused2_scene
    from owl_path_tracer.render.wavefront import render_image_wavefront
    from test_integrator import make_sphere_mesh
    from owl_path_tracer.models import material as material_mod
    from owl_path_tracer.models.camera import make_camera
    from owl_path_tracer.models.scene import RenderSettings, scene_from_arrays
    from owl_path_tracer.utils.parser import CameraDesc

    mat = material_mod.single(base_color=(0.6, 0.4, 0.3), roughness=0.7)
    v, idx, n = make_sphere_mesh(np.zeros(3), 1.0)
    cam = make_camera(CameraDesc((3, 0, 0), (0, 0, 0), (0, 1, 0), 45), (16, 16))
    scene = scene_from_arrays(v, idx, mat, np.zeros(len(idx), np.int32), cam, normals=n)
    s = RenderSettings(width=16, height=16, max_samples=4, max_path_depth=3,
                       environment_color=(1, 0.9, 0.8), environment_intensity=1.0)
    fb = build_fused2_scene(scene, cluster_size=64)
    img_sorted, rays_a = render_image_wavefront(
        scene, s, accel=fb, lanes=512, iters_per_launch=4, fused2_sort=True)
    img_plain, rays_b = render_image_wavefront(
        scene, s, accel=fb, lanes=512, iters_per_launch=4, fused2_sort=False)
    np.testing.assert_allclose(img_sorted, img_plain, rtol=1e-5, atol=1e-6)
    assert rays_a == rays_b


def test_checkpoint_kill_and_resume(tmp_path):
    """A killed-and-resumed render reproduces the uninterrupted image.

    Interruption is simulated by capping max_launches after a checkpoint was
    written (checkpoint_every_s=0 saves at every launch boundary); the rerun
    resumes from the file and completes.  Work items are (pixel, sample)-
    seeded so the estimator is identical; only the f32 film summation ORDER
    can differ (samples of a pixel bank in completion order), hence
    allclose, not array_equal.  VERDICT r4 #5."""
    mat = material_mod.single(base_color=(0.6, 0.6, 0.2), roughness=0.6, specular=0.0)
    scene = sphere_scene(mat)
    s = RenderSettings(width=16, height=16, max_samples=8, max_path_depth=3,
                       environment_auto=True, environment_intensity=1.0)
    ck = str(tmp_path / "film.ck")

    img_ref, rays_ref = wf.render_image_wavefront(
        scene, s, lanes=256, iters_per_launch=4)

    # "killed" run: checkpoint at the first launch boundary (2 steps in --
    # only ~a quarter of the work handed out), then stop
    wf.render_image_wavefront(
        scene, s, lanes=256, iters_per_launch=2, max_launches=1,
        checkpoint_path=ck, checkpoint_every_s=0.0)
    import os

    assert os.path.exists(ck)
    mid = np.load(ck)
    assert 0 < int(mid["work_counter"]) < 16 * 16 * 8

    # resumed run: completes from the checkpoint
    img_res, rays_res = wf.render_image_wavefront(
        scene, s, lanes=256, iters_per_launch=4,
        checkpoint_path=ck, checkpoint_every_s=1e9)
    np.testing.assert_allclose(img_res, img_ref, rtol=1e-5, atol=1e-6)


def test_checkpoint_config_guard(tmp_path):
    """Resuming under a different config must refuse, not mis-accumulate."""
    import pytest

    mat = material_mod.single(base_color=(0.6, 0.6, 0.2), roughness=0.6, specular=0.0)
    scene = sphere_scene(mat)
    s = RenderSettings(width=16, height=16, max_samples=4, max_path_depth=2,
                       environment_auto=True, environment_intensity=1.0)
    ck = str(tmp_path / "film.ck")
    wf.render_image_wavefront(
        scene, s, lanes=256, iters_per_launch=4, max_launches=2,
        checkpoint_path=ck, checkpoint_every_s=0.0)
    import dataclasses

    s2 = dataclasses.replace(s, max_samples=8)
    with pytest.raises(ValueError, match="different"):
        wf.render_image_wavefront(
            scene, s2, lanes=256, iters_per_launch=4, checkpoint_path=ck)

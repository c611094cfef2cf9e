"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from owl_path_tracer.models import material as material_mod
from owl_path_tracer.models.camera import make_camera
from owl_path_tracer.models.scene import RenderSettings, scene_from_arrays
from owl_path_tracer.parallel import shard as shard_mod
from owl_path_tracer.render import film as film_mod
from owl_path_tracer.utils.parser import CameraDesc
from test_integrator import make_sphere_mesh


def small_scene():
    mat = material_mod.single(base_color=(0.7, 0.5, 0.3), roughness=0.8)
    v, idx, n = make_sphere_mesh(np.zeros(3), 1.0)
    cam = make_camera(CameraDesc((3, 0, 0), (0, 0, 0), (0, 1, 0), 45), (16, 16))
    return scene_from_arrays(v, idx, mat, np.zeros(len(idx), np.int32), cam, normals=n)


SETTINGS = RenderSettings(
    width=16, height=16, max_samples=4, max_path_depth=3,
    environment_color=(1.0, 0.9, 0.8), environment_intensity=1.0,
)


def test_mesh_has_8_devices():
    mesh = shard_mod.make_pixel_mesh()
    assert mesh.devices.size == 8  # conftest forces 8 virtual CPU devices


def test_sharded_render_matches_single_chip():
    scene = small_scene()
    mesh = shard_mod.make_pixel_mesh()
    img_sharded = shard_mod.render_image_sharded(scene, SETTINGS, mesh=mesh)
    img_single = film_mod.render_image(scene, SETTINGS, pixel_chunk=256)
    # identical RNG streams -> identical images (up to f32 sum order: equal here
    # because per-pixel sums are computed independently in both paths)
    np.testing.assert_allclose(img_sharded, img_single, rtol=1e-6, atol=1e-7)


def test_sharded_render_nee_and_cluster():
    scene = small_scene()
    accel = film_mod.make_accel(scene, "cluster", cluster_size=64)
    mesh = shard_mod.make_pixel_mesh()
    s = SETTINGS
    img = shard_mod.render_image_sharded(scene, s, mesh=mesh, accel=accel)
    img_single = film_mod.render_image(scene, s, pixel_chunk=256, accel=accel)
    np.testing.assert_allclose(img, img_single, rtol=1e-6, atol=1e-7)


def test_sharded_grads_match_single_chip():
    from owl_path_tracer.render import diff as diff_mod

    scene = small_scene()
    mesh = shard_mod.make_pixel_mesh()
    px = film_mod._pixel_grid(16, 16)
    from owl_path_tracer.ops import rng as rng_mod
    state = np.asarray(rng_mod.seed(jnp.asarray(px[:, 0]), jnp.asarray(px[:, 1])))
    target = jnp.zeros((256, 3))

    fn = shard_mod.sharded_loss_and_grad(mesh, scene, SETTINGS, None, 4)
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P("px"))
    loss_sh, grads_sh = fn(
        scene.materials,
        jax.device_put(jnp.asarray(px), sh),
        jax.device_put(jnp.asarray(state), sh),
        jax.device_put(target, sh),
    )

    loss_1, grads_1 = diff_mod.loss_and_grad(
        scene, scene.materials, SETTINGS, jnp.asarray(px), target, 4, None
    )
    np.testing.assert_allclose(float(loss_sh), float(loss_1), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(grads_sh.base_color), np.asarray(grads_1.base_color), rtol=1e-4, atol=1e-7
    )


def test_sharded_wavefront_matches_single_chip():
    """The PRODUCTION path (persistent wavefront pool per chip) under
    shard_map: per-(pixel,sample) RNG streams are work-id-determined, so the
    sharded render equals the single-chip wavefront render up to f32
    film-summation order."""
    from owl_path_tracer.render.wavefront import render_image_wavefront

    scene = small_scene()
    mesh = shard_mod.make_pixel_mesh()
    img_s, rays_s = shard_mod.render_image_wavefront_sharded(
        scene, SETTINGS, mesh=mesh, lanes_per_chip=256, iters_per_launch=4
    )
    img_1, rays_1 = render_image_wavefront(
        scene, SETTINGS, lanes=2048, iters_per_launch=4
    )
    np.testing.assert_allclose(img_s, img_1, rtol=1e-5, atol=1e-6)
    assert rays_s == rays_1  # identical work items -> identical path lengths


def test_sharded_wavefront_cluster_nee():
    from owl_path_tracer.render.wavefront import render_image_wavefront
    import dataclasses

    scene = small_scene()
    accel = film_mod.make_accel(scene, "cluster", cluster_size=64)
    s = dataclasses.replace(SETTINGS, use_nee=True)
    mesh = shard_mod.make_pixel_mesh()
    img_s, _ = shard_mod.render_image_wavefront_sharded(
        scene, s, mesh=mesh, accel=accel, lanes_per_chip=256, iters_per_launch=4
    )
    img_1, _ = render_image_wavefront(scene, s, accel=accel, lanes=2048, iters_per_launch=4)
    np.testing.assert_allclose(img_s, img_1, rtol=1e-5, atol=1e-6)


def test_sharded_wavefront_fused2_smoke():
    """fused2 Pallas traversal under shard_map (interpret mode on the CPU
    mesh): must run and agree with the sharded cluster render."""
    from owl_path_tracer.render.wavefront import render_image_wavefront

    scene = small_scene()
    accel = film_mod.make_accel(scene, "fused2", cluster_size=64)
    mesh = shard_mod.make_pixel_mesh()
    img_s, _ = shard_mod.render_image_wavefront_sharded(
        scene, SETTINGS, mesh=mesh, accel=accel, lanes_per_chip=128, iters_per_launch=4
    )
    img_1, _ = render_image_wavefront(
        scene, SETTINGS, accel=accel, lanes=1024, iters_per_launch=4
    )
    np.testing.assert_allclose(img_s, img_1, rtol=1e-5, atol=1e-6)


def test_sharded_wavefront_sample_split_matches_and_balances():
    """The "sample" work split (round 4, VERDICT r3 #7): chip k renders
    samples [k*spp/n, (k+1)*spp/n) of EVERY pixel.  Must (a) equal the
    single-chip render (same (pixel,sample) set, same per-item RNG streams),
    and (b) balance load ~perfectly even though the scene's work is spatially
    concentrated -- every chip sees the same pixel distribution."""
    import dataclasses

    from owl_path_tracer.render.wavefront import render_image_wavefront

    scene = small_scene()
    s = dataclasses.replace(SETTINGS, max_samples=8)
    mesh = shard_mod.make_pixel_mesh()
    img_s, rays_s, stats = shard_mod.render_image_wavefront_sharded(
        scene, s, mesh=mesh, lanes_per_chip=256, iters_per_launch=4,
        work_split="sample", return_stats=True,
    )
    img_1, rays_1 = render_image_wavefront(
        scene, s, lanes=2048, iters_per_launch=4
    )
    np.testing.assert_allclose(img_s, img_1, rtol=1e-5, atol=1e-6)
    assert rays_s == rays_1
    # same pixels everywhere -> only sampling noise separates the chips
    assert stats["load_balance"] > 0.9, stats

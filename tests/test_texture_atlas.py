"""Regression: stacked textures of DIFFERENT sizes must each be sampled by
their own true (h,w), not the padded atlas extent (round-1 VERDICT weak #4)."""
import numpy as np
import jax.numpy as jnp

from owl_path_tracer.ops import texture as tex


def _atlas():
    # texture 0: 4x4 solid red; texture 1: 2x2 solid green, zero-padded to 4x4
    a = np.zeros((2, 4, 4, 3), np.float32)
    a[0, :, :] = [1.0, 0.0, 0.0]
    a[1, :2, :2] = [0.0, 1.0, 0.0]
    hw = np.asarray([[4, 4], [2, 2]], np.float32)
    return jnp.asarray(a), jnp.asarray(hw)


def test_small_texture_never_samples_padding():
    atlas, hw = _atlas()
    uv = jnp.asarray([[0.99, 0.99], [0.6, 0.6], [0.01, 0.01]], jnp.float32)
    tid = jnp.asarray([1, 1, 1], jnp.int32)
    out = np.asarray(tex.sample_atlas_nearest(atlas, tid, uv, hw))
    np.testing.assert_array_equal(out, np.tile([[0.0, 1.0, 0.0]], (3, 1)))


def test_full_texture_unaffected():
    atlas, hw = _atlas()
    uv = jnp.asarray([[0.99, 0.99], [0.01, 0.01]], jnp.float32)
    tid = jnp.asarray([0, 0], jnp.int32)
    out = np.asarray(tex.sample_atlas_nearest(atlas, tid, uv, hw))
    np.testing.assert_array_equal(out, np.tile([[1.0, 0.0, 0.0]], (2, 1)))


def test_negative_id_returns_zero():
    atlas, hw = _atlas()
    uv = jnp.asarray([[0.5, 0.5]], jnp.float32)
    out = np.asarray(tex.sample_atlas_nearest(atlas, jnp.asarray([-1]), uv, hw))
    np.testing.assert_array_equal(out, np.zeros((1, 3), np.float32))


def test_scene_carries_true_extents():
    """compile_scene records per-texture (h,w) for the lookup path."""
    import pathlib, sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "assets"))
    import generate

    generate.ensure_assets()
    from owl_path_tracer.models.scene import compile_scene

    scene = compile_scene("assets", "cube", (32, 32))
    hw = np.asarray(scene.tex_hw)
    assert hw.shape[1] == 2 and (hw > 0).all()
    assert (hw[:, 0] <= scene.textures.shape[1]).all()
    assert (hw[:, 1] <= scene.textures.shape[2]).all()

"""Debug/sanitizer layer tests (macros.hpp parity, SURVEY section 2 row 17)."""
import numpy as np
import jax.numpy as jnp
import pytest

from owl_path_tracer.ops import debug as dbg


def test_checked_gather_debug_raises():
    dbg.set_debug(True)
    try:
        table = jnp.arange(10.0)
        with pytest.raises(Exception):
            dbg.checked_call(lambda i: dbg.checked_gather(table, i), jnp.asarray([3, 12]))
        # in-range passes
        out = dbg.checked_call(lambda i: dbg.checked_gather(table, i), jnp.asarray([3, 9]))
        np.testing.assert_allclose(np.asarray(out), [3.0, 9.0])
    finally:
        dbg.set_debug(False)


def test_assert_finite():
    dbg.set_debug(True)
    try:
        with pytest.raises(Exception):
            dbg.checked_call(lambda x: dbg.assert_finite(x), jnp.asarray([1.0, np.nan]))
        out = dbg.checked_call(lambda x: dbg.assert_finite(x) * 2, jnp.asarray([1.0, 2.0]))
        np.testing.assert_allclose(np.asarray(out), [2.0, 4.0])
    finally:
        dbg.set_debug(False)


def test_release_mode_zero_cost_clamp():
    dbg.set_debug(False)
    table = jnp.arange(10.0)
    out = dbg.checked_gather(table, jnp.asarray([3, 12]))
    np.testing.assert_allclose(np.asarray(out), [3.0, 9.0])  # clamped


def test_validate_scene_catches_bad_indices():
    from owl_path_tracer.models import material as material_mod
    from owl_path_tracer.models.camera import make_camera
    from owl_path_tracer.models.scene import scene_from_arrays
    from owl_path_tracer.utils.parser import CameraDesc

    mat = material_mod.single()
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.asarray([[0, 1, 2]], np.int32)
    cam = make_camera(CameraDesc((0, 0, 3), (0, 0, 0), (0, 1, 0), 45), (8, 8))
    scene = scene_from_arrays(v, idx, mat, np.zeros(1, np.int32), cam)
    assert dbg.validate_scene(scene) == []

    bad = scene._replace(tri_idx=jnp.asarray([[0, 1, 7]], jnp.int32))
    problems = dbg.validate_scene(bad)
    assert any("tri_idx" in p for p in problems)

    bad2 = scene._replace(materials=scene.materials._replace(roughness=jnp.asarray([1.7])))
    assert any("roughness" in p for p in dbg.validate_scene(bad2))

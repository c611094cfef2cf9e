"""Math substrate tests -- oracle is independent numpy implementations of the
formulas the reference encodes (math.hpp:6-107) and that its analysis notebook
(bsdf_functions.ipynb) plots."""
import numpy as np
import jax.numpy as jnp
import pytest

from owl_path_tracer.ops import math as m


RNG = np.random.default_rng(7)


def rand_unit(n):
    v = RNG.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_shading_frame_trig_identities():
    w = rand_unit(512)
    ct = np.asarray(m.cos_theta(w))
    st = np.asarray(m.sin_theta(w))
    np.testing.assert_allclose(ct**2 + st**2, 1.0, atol=1e-5)
    # tan = sin/cos wherever cos isn't tiny
    mask = np.abs(ct) > 1e-3
    np.testing.assert_allclose(
        np.asarray(m.tan_theta(w))[mask], (st / ct)[mask], rtol=1e-4
    )


def test_cos_sin_phi_recover_azimuth():
    w = rand_unit(512)
    st = np.sqrt(np.maximum(0, 1 - w[:, 2] ** 2))
    mask = st > 1e-4
    cp = np.asarray(m.cos_phi(w))[mask]
    sp = np.asarray(m.sin_phi(w))[mask]
    np.testing.assert_allclose(cp, np.clip(w[mask, 0] / st[mask], -1, 1), atol=1e-5)
    np.testing.assert_allclose(sp, np.clip(w[mask, 1] / st[mask], -1, 1), atol=1e-5)


def test_reflect_matches_formula_and_preserves_angle():
    w = rand_unit(256)
    n = rand_unit(256)
    r = np.asarray(m.reflect(w, n))
    np.testing.assert_allclose(r, 2 * np.sum(w * n, -1, keepdims=True) * n - w, atol=1e-6)
    # angle of incidence == angle of reflection
    np.testing.assert_allclose(
        np.sum(r * n, -1), np.sum(w * n, -1), atol=1e-5
    )


def test_refract_snell_and_tir():
    n = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (256, 1))
    w = rand_unit(256)
    w[:, 2] = np.abs(w[:, 2])  # above surface
    eta = np.float32(1.0 / 1.5)
    ok, wi = m.refract(w, n, jnp.full((256,), eta))
    ok, wi = np.asarray(ok), np.asarray(wi)
    assert ok.all()  # entering denser medium: no TIR
    # Snell: sin_t = eta * sin_i
    sin_i = np.sqrt(np.maximum(0, 1 - np.sum(w * n, -1) ** 2))
    sin_t = np.sqrt(np.maximum(0, 1 - wi[:, 2] ** 2))
    np.testing.assert_allclose(sin_t, eta * sin_i, atol=1e-5)
    assert (wi[:, 2] <= 0).all()  # transmitted below surface

    # TIR going out of dense medium at grazing angle
    w_grz = np.array([[0.99, 0.0, np.sqrt(1 - 0.99**2)]], np.float32)
    ok2, _ = m.refract(w_grz, n[:1], jnp.full((1,), 1.5, jnp.float32))
    assert not bool(np.asarray(ok2)[0])


def test_refract_eta_one_passthrough():
    w = rand_unit(16)
    n = np.tile(np.array([0, 0, 1], np.float32), (16, 1))
    ok, wi = m.refract(w, n, jnp.ones((16,)))
    assert np.asarray(ok).all()
    np.testing.assert_allclose(np.asarray(wi), -w, atol=1e-6)


def test_onb_orthonormal_right_handed():
    n = rand_unit(512)
    t, b = m.onb(n)
    t, b = np.asarray(t), np.asarray(b)
    np.testing.assert_allclose(np.sum(t * n, -1), 0, atol=1e-5)
    np.testing.assert_allclose(np.sum(b * n, -1), 0, atol=2e-5)
    np.testing.assert_allclose(np.sum(t * b, -1), 0, atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1, atol=1e-5)


def test_onb_degenerate_axis_aligned():
    # all-equal components hit the reference's second branch (math.hpp:91)
    for nv in ([0, 0, 1], [0, 1, 0], [1, 0, 0], [0.57735, 0.57735, 0.57735]):
        n = np.array([nv], np.float32)
        n = n / np.linalg.norm(n)
        t, b = m.onb(n)
        assert np.isfinite(np.asarray(t)).all() and np.isfinite(np.asarray(b)).all()
        np.testing.assert_allclose(np.sum(np.asarray(t) * n, -1), 0, atol=1e-5)


def test_local_world_roundtrip():
    n = rand_unit(256)
    t, b = m.onb(n)
    w = rand_unit(256)
    lw = m.to_local(t, b, n, w)
    back = m.to_world(t, b, n, lw)
    np.testing.assert_allclose(np.asarray(back), w, atol=1e-4)
    # z-component in local frame is cos of angle to n
    np.testing.assert_allclose(
        np.asarray(lw)[:, 2], np.sum(w * n, -1), atol=1e-4
    )


def test_luminance_white_is_one():
    c = np.ones((4, 3), np.float32)
    np.testing.assert_allclose(np.asarray(m.luminance(c)), 1.0, atol=1e-4)

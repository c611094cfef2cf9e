"""Sampler distribution tests (chi-square / moment checks) -- the automated
version of what the reference only eyeballed in bsdf_functions.ipynb."""
import numpy as np
import jax.numpy as jnp
from scipy import stats  # scipy ships with the jax test stack

from owl_path_tracer.ops import sampling as sm
from owl_path_tracer.ops import math as m

N = 200_000


def uniforms(n, seed=0):
    r = np.random.default_rng(seed)
    return jnp.asarray(r.random((n, 2), np.float32))


def test_concentric_disk_uniform_area():
    pts = np.asarray(sm.sample_concentric_disk(uniforms(N)))
    r2 = (pts**2).sum(-1)
    assert r2.max() <= 1.0 + 1e-5
    # r^2 should be U[0,1] for uniform area density
    ks = stats.kstest(r2, "uniform").statistic
    assert ks < 0.01, ks


def test_cosine_hemisphere_distribution():
    d = np.asarray(sm.sample_cosine_hemisphere(uniforms(N, 1)))
    assert (d[:, 2] >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    # cos-weighted: cos^2(theta) ~ U[0,1]
    ks = stats.kstest(d[:, 2] ** 2, "uniform").statistic
    assert ks < 0.01, ks
    # azimuthal uniformity
    phi = np.arctan2(d[:, 1], d[:, 0])
    ks = stats.kstest((phi + np.pi) / (2 * np.pi), "uniform").statistic
    assert ks < 0.01, ks


def test_uniform_sphere_distribution():
    d = np.asarray(sm.sample_uniform_sphere(uniforms(N, 2)))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    ks = stats.kstest((d[:, 2] + 1) / 2, "uniform").statistic  # z ~ U[-1,1]
    assert ks < 0.01, ks


def test_uniform_hemisphere_distribution():
    d = np.asarray(sm.sample_uniform_hemisphere(uniforms(N, 3)))
    assert (d[:, 2] >= 0).all()
    ks = stats.kstest(d[:, 2], "uniform").statistic
    assert ks < 0.01, ks


def test_uniform_triangle_barycentric():
    b = np.asarray(sm.sample_uniform_triangle(uniforms(N, 4)))
    assert (b >= 0).all() and (b.sum(-1) <= 1 + 1e-6).all()
    # uniform in the unit right triangle: E[b0] = E[b1] = 1/3
    np.testing.assert_allclose(b.mean(0), [1 / 3, 1 / 3], atol=5e-3)


def test_cosine_pdf_integrates_to_one():
    # integrate |cos|/pi over hemisphere by uniform-hemisphere MC
    d = sm.sample_uniform_hemisphere(uniforms(N, 5))
    pdfs = np.asarray(sm.pdf_cosine_hemisphere(d))
    integral = pdfs.mean() * 2 * np.pi  # domain area
    np.testing.assert_allclose(integral, 1.0, atol=5e-3)

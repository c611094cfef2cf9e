"""Chi-square distribution tests: sampled directions vs analytic pdfs.

SURVEY.md section 4 ("chi-square tests that sampled directions match analytic
pdfs") -- the distribution-level validation the reference never automated
(its verification was visual, thesis implementation.tex:300-304).  Every
directional sampler is histogrammed over a (cos_theta, phi) grid and tested
against the density its pdf function claims, pbrt-style:

  * base samplers (ops/sampling.py): cosine hemisphere, uniform sphere/
    hemisphere vs their closed-form densities;
  * GTR2 NDF half-vector sampler (parity mode, disney_specular.cuh:64-81)
    vs D(wh)|cos wh| -- the classic NDF sampling density;
  * GTR2 VNDF sampler (corrected mode, Heitz 2018; implemented-but-unused in
    the reference at disney_specular.cuh:85-110) vs
    G1(wo) D(wh) max(0, wo.wh) / cos(wo);
  * GTR1 clearcoat half-vector sampler vs D_gtr1(wh)|cos wh|;
  * full corrected METALLIC lobe: wi histogram vs the returned pdf --
    validates sampler and pdf agree as a pair (VNDF + reflection Jacobian);
  * full corrected CLEARCOAT lobe: wi histogram vs the corrected pdf, AND a
    negative control showing the PARITY pdf (the documented reference bug,
    disney_clearcoat.cuh:57, thesis assets/pdf-comparison) FAILS the same
    test -- the bug is real and the fix measurably matters.

Expected bin masses integrate the claimed pdf with a fine midpoint rule per
bin (256 cos-subsamples: NDF peaks are narrow).  Threshold: chi-square critical value at alpha=1e-3 via the
Wilson-Hilferty approximation (no scipy dependency).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from owl_path_tracer.models import material
from owl_path_tracer.ops import disney
from owl_path_tracer.ops import math as m
from owl_path_tracer.ops import sampling as sm

N_SAMPLES = 1 << 17
N_COS, N_PHI = 12, 16


def _uniform2(n, seed):
    r = np.random.default_rng(seed)
    return jnp.asarray(r.random((n, 2), np.float32))


def _chi2_crit(dof, z=3.09):
    """Wilson-Hilferty upper-tail critical value (alpha ~ 1e-3 at z=3.09)."""
    h = 2.0 / (9.0 * dof)
    return dof * (1.0 - h + z * np.sqrt(h)) ** 3


def _chi2_stat(dirs, pdf_fn, n_total, cos_lo=-1.0, min_exp=8.0):
    """Chi-square statistic over a (cos, phi) grid vs the claimed density.

    dirs: [N,3] unit vectors (the BINNED population; n_total >= len(dirs)
    counts discarded/dead draws so the density needs no renormalization).
    pdf_fn: maps [M,3] directions -> density per solid angle.
    """
    dirs = np.asarray(dirs)
    cosb = np.linspace(cos_lo, 1.0, N_COS + 1)
    phib = np.linspace(-np.pi, np.pi, N_PHI + 1)
    ct = np.clip(dirs[:, 2], -1.0, 1.0)
    ph = np.arctan2(dirs[:, 1], dirs[:, 0])
    hist, _, _ = np.histogram2d(ct, ph, bins=[cosb, phib])

    # expected mass: midpoint rule, FINE in cos (peaked NDFs concentrate
    # near cos=1; 256 cos-subsamples resolve alpha^2-width peaks down to
    # alpha ~ 0.05 at these bin widths), coarse in phi (smooth there)
    s_c, s_p = 256, 4
    cc = 0.5 * (cosb[:-1, None] + cosb[1:, None]) + (
        (np.arange(s_c) + 0.5) / s_c - 0.5
    )[None, :] * (cosb[1:, None] - cosb[:-1, None])  # [N_COS, s_c]
    pp = 0.5 * (phib[:-1, None] + phib[1:, None]) + (
        (np.arange(s_p) + 0.5) / s_p - 0.5
    )[None, :] * (phib[1:, None] - phib[:-1, None])  # [N_PHI, s_p]
    ctg = np.broadcast_to(cc[:, None, :, None], (N_COS, N_PHI, s_c, s_p))
    phg = np.broadcast_to(pp[None, :, None, :], (N_COS, N_PHI, s_c, s_p))
    st = np.sqrt(np.maximum(0.0, 1.0 - ctg**2))
    sub = np.stack(
        [st * np.cos(phg), st * np.sin(phg), ctg], axis=-1
    ).reshape(-1, 3)
    pdf = np.asarray(pdf_fn(jnp.asarray(sub, jnp.float32))).reshape(
        N_COS, N_PHI, s_c, s_p
    )
    d_cos = (cosb[1] - cosb[0]) * (phib[1] - phib[0])
    expected = pdf.mean(axis=(2, 3)) * d_cos * n_total

    mask = expected.ravel() >= min_exp
    obs, exp = hist.ravel()[mask], expected.ravel()[mask]
    stat = float(np.sum((obs - exp) ** 2 / exp))
    dof = int(mask.sum()) - 1
    # coverage check: the pdf must account for (almost) all binned samples
    assert expected.sum() == pytest.approx(len(dirs), rel=0.02), (
        "pdf does not integrate to the observed acceptance mass"
    )
    return stat, _chi2_crit(max(dof, 1))


# ── base samplers ──────────────────────────────────────────────────────────


def test_cosine_hemisphere():
    wi = sm.sample_cosine_hemisphere(_uniform2(N_SAMPLES, 1))
    stat, crit = _chi2_stat(
        wi, lambda v: jnp.maximum(v[:, 2], 0.0) * m.INV_PI, N_SAMPLES, 0.0
    )
    assert stat < crit, (stat, crit)


def test_uniform_sphere():
    wi = sm.sample_uniform_sphere(_uniform2(N_SAMPLES, 2))
    stat, crit = _chi2_stat(
        wi, lambda v: jnp.full(v.shape[:1], 0.25 * m.INV_PI), N_SAMPLES, -1.0
    )
    assert stat < crit, (stat, crit)


def test_uniform_hemisphere():
    wi = sm.sample_uniform_hemisphere(_uniform2(N_SAMPLES, 3))
    stat, crit = _chi2_stat(
        wi, lambda v: jnp.full(v.shape[:1], 0.5 * m.INV_PI), N_SAMPLES, 0.0
    )
    assert stat < crit, (stat, crit)


# ── half-vector samplers ───────────────────────────────────────────────────


def _wo(theta_deg=40.0):
    t = np.radians(theta_deg)
    return jnp.asarray([[np.sin(t), 0.0, np.cos(t)]], jnp.float32)


@pytest.mark.parametrize("rough", [0.4, 0.7])
def test_gtr2_ndf_isotropic(rough):
    """Parity NDF sampler draws wh ~ D(wh)|cos wh| (disney_specular.cuh:64)."""
    ax = ay = float(disney.roughness_to_alpha(jnp.float32(rough)))
    u = _uniform2(N_SAMPLES, 4)
    wo = jnp.broadcast_to(_wo(), (N_SAMPLES, 3))
    wh = disney.sample_gtr2_ndf(wo, ax, ay, u)
    stat, crit = _chi2_stat(
        wh,
        lambda v: disney.d_gtr2(v, ax, ay) * jnp.abs(v[:, 2]),
        N_SAMPLES,
        0.0,
    )
    assert stat < crit, (stat, crit)


def test_gtr2_ndf_anisotropic():
    """The reference's idiosyncratic anisotropic phi remap
    (``atan(ay/ax tan(2 pi u + 1/pi))`` with a single u>.5 fixup,
    disney_specular.cuh:66-70) LOOKS wrong -- the textbook mapping has no
    1/pi offset inside the tangent and uses quadrant fixups at u=.25/.75 --
    but is measurably measure-preserving: the constant circular offset only
    permutes which u lands in which quadrant, and the u>.5 branch restores
    the phi+pi half.  Empirical finding of this chi-square (round 4): the
    parity sampler matches D(wh)|cos wh| even at strong anisotropy, so the
    quirk is cosmetic, not a distribution bug."""
    ax, ay = (float(x) for x in disney.roughness_to_alpha_aniso(
        jnp.float32(0.5), jnp.float32(0.8)))
    u = _uniform2(N_SAMPLES, 5)
    wo = jnp.broadcast_to(_wo(), (N_SAMPLES, 3))
    wh = disney.sample_gtr2_ndf(wo, ax, ay, u)
    stat, crit = _chi2_stat(
        wh,
        lambda v: disney.d_gtr2(v, ax, ay) * jnp.abs(v[:, 2]),
        N_SAMPLES,
        0.0,
        min_exp=4.0,
    )
    assert stat < crit, (stat, crit)


@pytest.mark.parametrize("rough", [0.4, 0.7])
@pytest.mark.parametrize("aniso", [0.0, 0.8])
def test_gtr2_vndf(rough, aniso):
    """Corrected-mode VNDF sampler (Heitz 2018): wh ~ G1 D max(0,wo.wh)/cos_o."""
    ax, ay = (float(x) for x in disney.roughness_to_alpha_aniso(
        jnp.float32(rough), jnp.float32(aniso)))
    u = _uniform2(N_SAMPLES, 6)
    wo1 = _wo()
    wo = jnp.broadcast_to(wo1, (N_SAMPLES, 3))
    wh = disney.sample_gtr2_vndf(wo, ax, ay, u)

    def pdf(v):
        n_v = v.shape[0]
        wov = jnp.broadcast_to(wo1, (n_v, 3))
        g1 = disney.g1_smith(wov, ax, ay)
        d = disney.d_gtr2(v, ax, ay)
        return g1 * d * jnp.maximum(0.0, jnp.sum(wov * v, -1)) / wo1[0, 2]

    stat, crit = _chi2_stat(wh, pdf, N_SAMPLES, 0.0)
    assert stat < crit, (stat, crit)


@pytest.mark.parametrize("gloss", [0.0, 0.5])
def test_gtr1_ndf(gloss):
    """Clearcoat GTR1 sampler draws wh ~ D_gtr1(wh)|cos wh| (cuh:23-33)."""
    alpha = float(m.lerp(0.1, 0.001, jnp.float32(gloss)))
    u = _uniform2(N_SAMPLES, 7)
    wo = jnp.broadcast_to(_wo(), (N_SAMPLES, 3))
    wh = disney.sample_gtr1_ndf(wo, alpha, u)
    stat, crit = _chi2_stat(
        wh,
        lambda v: disney.d_gtr1(v, alpha) * jnp.abs(v[:, 2]),
        N_SAMPLES,
        0.0,
    )
    assert stat < crit, (stat, crit)


# ── full lobes: wi histogram vs the pdf the sampler RETURNS ────────────────


def test_metallic_corrected_wi_matches_pdf():
    """Corrected metallic lobe: sampled wi density == returned pdf.

    This is the pair-consistency test the corrected VNDF + mixture-pdf mode
    had no distribution-level coverage for (VERDICT r3 missing #3)."""
    mat = material.single(metallic=1.0, roughness=0.4)
    mat1 = jax.tree.map(lambda a: jnp.broadcast_to(a, (N_SAMPLES,) + a.shape[1:]), mat)
    wo1 = _wo(35.0)
    wo = jnp.broadcast_to(wo1, (N_SAMPLES, 3))
    u = _uniform2(N_SAMPLES, 8)
    wi, f, pdf = disney.sample_specular_brdf(mat1, wo, u, corrected=True)
    keep = np.asarray(pdf) > 0.0
    dirs = np.asarray(wi)[keep]

    matp = jax.tree.map(lambda a: a[:1], mat1)

    def pdf_fn(v):
        n_v = v.shape[0]
        wov = jnp.broadcast_to(wo1, (n_v, 3))
        wh = wov + v
        wh = wh / jnp.linalg.norm(wh, axis=-1, keepdims=True)
        mv = jax.tree.map(lambda a: jnp.broadcast_to(a, (n_v,) + a.shape[1:]), matp)
        _, p = disney.eval_specular_brdf(mv, wov, wh, v, corrected=True)
        # pdf is a density in wi; zero out the lower hemisphere (dead draws)
        return jnp.where(v[:, 2] > 0.0, p, 0.0)

    stat, crit = _chi2_stat(dirs, pdf_fn, N_SAMPLES, 0.0)
    assert stat < crit, (stat, crit)


@pytest.mark.parametrize("corrected,should_pass", [(True, True), (False, False)])
def test_clearcoat_wi_vs_pdf(corrected, should_pass):
    """Corrected clearcoat pdf matches its sampler; the parity pdf (missing
    |cos wh| factor, disney_clearcoat.cuh:57 -- the thesis's documented
    pdf-comparison bug) measurably does NOT."""
    mat = material.single(clearcoat=1.0, clearcoat_gloss=0.5)
    mat1 = jax.tree.map(lambda a: jnp.broadcast_to(a, (N_SAMPLES,) + a.shape[1:]), mat)
    wo1 = _wo(35.0)
    wo = jnp.broadcast_to(wo1, (N_SAMPLES, 3))
    u = _uniform2(N_SAMPLES, 9)
    wi, f, pdf = disney.sample_clearcoat(mat1, wo, u, corrected=corrected)
    keep = np.asarray(pdf) > 0.0
    dirs = np.asarray(wi)[keep]

    matp = jax.tree.map(lambda a: a[:1], mat1)

    def pdf_fn(v):
        n_v = v.shape[0]
        wov = jnp.broadcast_to(wo1, (n_v, 3))
        wh = wov + v
        wh = wh / jnp.linalg.norm(wh, axis=-1, keepdims=True)
        mv = jax.tree.map(lambda a: jnp.broadcast_to(a, (n_v,) + a.shape[1:]), matp)
        _, p = disney.eval_clearcoat(mv, wov, wh, v, corrected=corrected)
        return jnp.where(v[:, 2] > 0.0, p, 0.0)

    if should_pass:
        stat, crit = _chi2_stat(dirs, pdf_fn, N_SAMPLES, 0.0)
        assert stat < crit, (stat, crit)
    else:
        # the buggy pdf doesn't even integrate to the acceptance mass;
        # accept either failure mode (coverage or shape)
        try:
            stat, crit = _chi2_stat(dirs, pdf_fn, N_SAMPLES, 0.0)
        except AssertionError:
            return
        assert stat > crit, (
            "parity clearcoat pdf unexpectedly matches its sampler -- "
            "the documented reference bug should be detectable", stat, crit)

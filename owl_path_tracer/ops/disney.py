"""The 5-lobe Disney BSDF, batched SoA, with exact reference-parity semantics.

Wavefront rebuild of ``/root/reference/path_tracer/src/device/disney/*.cuh``.
Instead of the reference's per-thread CDF branch into one lobe's sampler
(disney.cuh:42-63), *all* lobes are sampled/evaluated for the whole wavefront
and combined with one-hot selects -- lockstep vector work, and exactly what
detached-sampling differentiability needs.

Parity facts deliberately reproduced (SURVEY.md section 3.4; they are
reference *semantics*, some knowingly non-standard):

* the returned pdf is the **per-lobe** pdf, NOT multiplied by the discrete
  lobe-selection probability (disney.cuh:44-63);
* sheen is added additively to any sampled lobe with no pdf term
  (disney.cuh:65);
* the metallic lobe samples the **NDF**, not the VNDF, while using a
  VNDF-style pdf (disney_specular.cuh:157,144);
* ``force_btdf``: when exiting glass (wo below surface and previous lobe was
  glass) the glass lobe is forced (disney.cuh:40);
* glass consumes a branch-dependent number of RNG draws incl. the C++
  short-circuit ``!refract(...) || random() < pr/(pr+pt)`` (TIR draws no
  random; disney_specular.cuh:235) -- reproduced draw-for-draw so the LCG
  stream stays aligned with the CUDA reference;
* ``subsurface`` is parsed but unused in every lobe (disney_diffuse.cuh note).

RNG draw accounting per ``sample`` call (parity mode):
  1 (lobe select) + 2 (sampler) for diffuse/metal/clearcoat = 3;
  glass: 1 + 2 + {TIR: 2 (NDF fallback) = 5; reflect: 1 + 2 = 6; transmit: 1 = 4}.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import math as m
from . import rng as rng_mod
from . import sampling as sm

LOBE_NONE = -1
LOBE_DIFFUSE = 0
LOBE_CLEARCOAT = 1
LOBE_METALLIC = 2
LOBE_GLASS = 3


# ── helpers (disney_helper.cuh) ────────────────────────────────────────────


def schlick_weight(cos_t):
    """(1-cos)^5 clamped -- disney_helper.cuh:19-24."""
    w = jnp.clip(1.0 - cos_t, 0.0, 1.0)
    return w * w * w * w * w


def relative_eta(wo, ior):
    """eta_i, eta_t, eta ratio by travel direction -- disney_helper.cuh:31-37."""
    entering = m.cos_theta(wo) > 0.0
    eta_i = jnp.where(entering, 1.0, ior)
    eta_t = jnp.where(entering, ior, 1.0)
    return eta_i, eta_t, eta_i / eta_t


def roughness_to_alpha(roughness):
    """max(alpha_min, clamp(r^2, 0, 1)) -- disney_helper.cuh:39-42."""
    return jnp.maximum(m.ALPHA_MIN, jnp.clip(m.sqr(roughness), 0.0, 1.0))


def roughness_to_alpha_aniso(roughness, anisotropy):
    """Anisotropic (ax, ay) -- disney_helper.cuh:44-48."""
    aspect = jnp.sqrt(1.0 - 0.9 * anisotropy)
    ax = jnp.maximum(m.ALPHA_MIN, m.sqr(roughness) / aspect)
    ay = jnp.maximum(m.ALPHA_MIN, m.sqr(roughness) * aspect)
    return ax, ay


def fresnel_dielectric(i, mfn, eta_i, eta_t):
    """Full dielectric Fresnel, Disney 2015 eq. 8 -- disney_helper.cuh:52-60.

    Returns 1 on total internal reflection.
    """
    c = jnp.abs(m.dot(i, mfn))
    denom = m.sqr(eta_t / eta_i) - 1.0 + m.sqr(c)
    g = jnp.sqrt(jnp.maximum(denom, 0.0))
    r = (
        0.5
        * m.sqr((g - c) / jnp.where(g + c == 0.0, 1.0, g + c))
        * (1.0 + m.sqr(c * (g + c) - 1.0) / jnp.where(m.sqr(c * (g - c) + 1.0) == 0.0, 1.0, m.sqr(c * (g - c) + 1.0)))
    )
    return jnp.where(denom < 0.0, 1.0, r)


def _tint(base_color):
    """Luminance-normalized tint -- disney_specular.cuh:129-130."""
    lum = m.luminance(base_color)
    safe = jnp.where(lum > 0.0, lum, 1.0)[..., None]
    return jnp.where((lum > 0.0)[..., None], base_color / safe, 1.0)


# ── microfacet distributions (disney_specular.cuh / disney_clearcoat.cuh) ──


def smith_lambda(w, ax, ay):
    """Heitz eq. 86 -- disney_specular.cuh:17-26."""
    tan_t = m.tan_theta(w)
    inf = jnp.isinf(tan_t)
    tan_safe = jnp.where(inf, 1.0, tan_t)
    alpha0 = jnp.sqrt(m.sqr(m.cos_phi(w) * ax) + m.sqr(m.sin_phi(w) * ay))
    inv_a2 = m.sqr(alpha0 * tan_safe)  # = 1/a^2
    lam = (-1.0 + jnp.sqrt(1.0 + inv_a2)) / 2.0
    return jnp.where(inf, 0.0, lam)


def g1_smith(w, ax, ay):
    return 1.0 / (1.0 + smith_lambda(w, ax, ay))


def g2_smith_separable(wo, wi, ax, ay):
    return g1_smith(wo, ax, ay) * g1_smith(wi, ax, ay)


def g2_smith_correlated(wo, wi, ax, ay):
    return 1.0 / (1.0 + smith_lambda(wo, ax, ay) + smith_lambda(wi, ax, ay))


def d_gtr2(wm, ax, ay):
    """Anisotropic GGX NDF -- disney_specular.cuh:53-60."""
    tan2 = m.sqr(m.tan_theta(wm))
    inf = jnp.isinf(tan2)
    tan2_safe = jnp.where(inf, 0.0, tan2)
    cos4 = m.sqr(m.sqr(m.cos_theta(wm)))
    e = 1.0 + tan2_safe * (m.sqr(m.cos_phi(wm)) / m.sqr(ax) + m.sqr(m.sin_phi(wm)) / m.sqr(ay))
    denom = m.PI * ax * ay * cos4 * m.sqr(e)
    d = 1.0 / jnp.where(denom == 0.0, 1.0, denom)
    return jnp.where(inf | (denom == 0.0), 0.0, d)


def d_gtr1(wh, alpha):
    """GTR gamma=1 (clearcoat) -- disney_clearcoat.cuh:13-20."""
    a2 = m.sqr(alpha)
    val = (a2 - 1.0) / (m.PI * jnp.log(a2) * (1.0 + (a2 - 1.0) * m.sqr(m.cos_theta(wh))))
    return jnp.where(alpha >= 1.0, m.INV_PI, val)


def sample_gtr2_ndf(wo, ax, ay, u):
    """Anisotropic GTR2 NDF sample -- disney_specular.cuh:64-81.

    Reproduces the reference's exact (idiosyncratic) phi formula:
    ``phi = atan(ay/ax * tan(2*pi*u1 + inv_pi)); if (u1 > .5) phi += pi``.
    """
    u0, u1 = u[..., 0], u[..., 1]
    phi = jnp.arctan(ay / ax * jnp.tan(m.TWO_PI * u1 + m.INV_PI))
    phi = jnp.where(u1 > 0.5, phi + m.PI, phi)
    sin_phi, cos_phi = jnp.sin(phi), jnp.cos(phi)
    alpha2 = 1.0 / (m.sqr(cos_phi) / m.sqr(ax) + m.sqr(sin_phi) / m.sqr(ay))
    tan_theta2 = alpha2 * u0 / jnp.maximum(1.0 - u0, 1e-20)
    cos_t = 1.0 / jnp.sqrt(1.0 + tan_theta2)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - m.sqr(cos_t)))
    wh = m.spherical_direction_sincos(sin_t, cos_t, phi)
    return wh / jnp.sqrt(m.dot(wh, wh))[..., None]


def sample_gtr2_vndf(wo, ax, ay, u):
    """Heitz 2018 visible-normal sampling -- disney_specular.cuh:85-110.

    Implemented-but-unused in the reference sampler (it calls the NDF variant,
    disney_specular.cuh:157); used here by the corrected (parity=False) mode.
    """
    n = jnp.stack([ax * wo[..., 0], ay * wo[..., 1], wo[..., 2]], axis=-1)
    n = n / jnp.sqrt(m.dot(n, n))[..., None]
    len_sq = m.sqr(n[..., 0]) + m.sqr(n[..., 1])
    inv = 1.0 / jnp.sqrt(jnp.where(len_sq > 0.0, len_sq, 1.0))
    t = jnp.where(
        (len_sq > 0.0)[..., None],
        jnp.stack([-n[..., 1] * inv, n[..., 0] * inv, jnp.zeros_like(inv)], axis=-1),
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], wo.dtype), n.shape),
    )
    b = jnp.cross(n, t)
    r = jnp.sqrt(u[..., 0])
    phi = m.TWO_PI * u[..., 1]
    t1 = r * jnp.cos(phi)
    b1 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + n[..., 2])
    b1 = (1.0 - s) * jnp.sqrt(jnp.maximum(0.0, 1.0 - m.sqr(t1))) + s * b1
    nh = (
        t1[..., None] * t
        + b1[..., None] * b
        + jnp.sqrt(jnp.maximum(0.0, 1.0 - m.sqr(t1) - m.sqr(b1)))[..., None] * n
    )
    wh = jnp.stack(
        [ax * nh[..., 0], ay * nh[..., 1], jnp.maximum(0.0, nh[..., 2])], axis=-1
    )
    return wh / jnp.sqrt(jnp.maximum(m.dot(wh, wh), 1e-20))[..., None]


def sample_gtr1_ndf(wo, alpha, u):
    """GTR1 sample -- disney_clearcoat.cuh:23-33 (flipped into wo hemisphere)."""
    a2 = m.sqr(alpha)
    num = 1.0 - jnp.power(a2, 1.0 - u[..., 0])
    den = jnp.where(a2 == 1.0, 1.0, 1.0 - a2)
    cos_t = jnp.sqrt(jnp.maximum(0.0, num / den))
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - m.sqr(cos_t)))
    phi = m.TWO_PI * u[..., 1]
    wh = m.spherical_direction_sincos(sin_t, cos_t, phi)
    return jnp.where(m.same_hemisphere(wo, wh)[..., None], wh, -wh)


def sample_gtr2_walter(alpha, u):
    """Walter-07 eq. 35/36 microfacet sample -- disney_specular.cuh:175-180."""
    theta = jnp.arctan(alpha * jnp.sqrt(u[..., 0]) / jnp.sqrt(jnp.maximum(1.0 - u[..., 0], 1e-20)))
    phi = m.TWO_PI * u[..., 1]
    return m.spherical_direction(theta, phi)


# ── lobe evals (return f [N,3], pdf [N]) ───────────────────────────────────


def eval_diffuse(mat, wo, wi):
    """2015 refactored diffuse -- disney_diffuse.cuh:26-55. subsurface unused."""
    f_o = schlick_weight(m.cos_theta(wo))
    f_i = schlick_weight(m.cos_theta(wi))
    lambert = mat.base_color * m.INV_PI
    fd = (1.0 - 0.5 * f_o) * (1.0 - 0.5 * f_i)
    rr = mat.roughness * (m.dot(wo, wi) + 1.0)
    fr = rr * (f_i + f_o + f_o * f_i * (rr - 1.0))
    pdf = sm.pdf_cosine_hemisphere(wi)
    return lambert * (fd + fr)[..., None], pdf


def eval_specular_brdf(mat, wo, wh, wi, corrected=False):
    """Metallic GGX lobe -- disney_specular.cuh:125-149.

    Parity pdf is the reference's expression g1*d*max(0,wo.wh)/(4 cos wo),
    which is neither the NDF-sampling density it draws from nor quite the
    VNDF density (an extra wo.wh factor).  ``corrected=True`` returns the
    true VNDF density d*g1/(4|cos wo|), matching the corrected sampler.
    """
    c_tint = _tint(mat.base_color)
    c_spec = m.lerp(
        0.08 * mat.specular[..., None] * m.lerp(jnp.ones_like(c_tint), c_tint, mat.specular_tint[..., None]),
        mat.base_color,
        mat.metallic[..., None],
    )
    ax, ay = roughness_to_alpha_aniso(mat.roughness, mat.anisotropic)
    d = d_gtr2(wh, ax, ay)
    g = g2_smith_correlated(wo, wi, ax, ay)
    f = m.lerp(c_spec, jnp.ones_like(c_spec), schlick_weight(m.dot(wi, wh))[..., None])
    cos_o = m.cos_theta(wo)
    cos_safe = jnp.where(cos_o == 0.0, 1.0, cos_o)
    if corrected:
        pdf = d * g1_smith(wo, ax, ay) / (4.0 * jnp.abs(cos_safe))
    else:
        pdf = d * g1_smith(wo, ax, ay) * jnp.maximum(0.0, m.dot(wo, wh)) / (4.0 * cos_safe)
    pdf = jnp.where(cos_o == 0.0, 0.0, pdf)
    val = d * g / (4.0 * jnp.abs(cos_safe))
    val = jnp.where(cos_o == 0.0, 0.0, val)
    return f * val[..., None], pdf


def eval_specular_bsdf(mat, wo, wh, wi):
    """Glass lobe (Walter-07 style R/T) -- disney_specular.cuh:193-214."""
    eta_i, eta_t, eta = relative_eta(wo, mat.ior)
    r = fresnel_dielectric(wo, wh, eta_i, eta_t)
    t = 1.0 - r
    cos_i = jnp.abs(m.cos_theta(wi))
    cos_safe = jnp.where(cos_i == 0.0, 1.0, cos_i)
    refl = m.same_hemisphere(wo, wi)
    pdf = jnp.where(refl, r / (r + t), t / (r + t))
    f_refl = mat.base_color * (r / cos_safe)[..., None]
    f_trans = jnp.sqrt(jnp.maximum(mat.base_color, 0.0)) * (t / cos_safe / m.sqr(eta))[..., None]
    f = jnp.where(refl[..., None], f_refl, f_trans)
    f = jnp.where((cos_i == 0.0)[..., None], 0.0, f)
    return f, pdf


def eval_clearcoat(mat, wo, wh, wi, corrected=False):
    """GTR1 clearcoat -- disney_clearcoat.cuh:45-59.

    ``corrected=True`` fixes the reference's pdf bug (thesis
    assets/pdf-comparison): NDF sampling's true density is
    d*cos(theta_h)/(4 wh.wi); the reference omits the cosine.
    """
    alpha = m.lerp(0.1, 0.001, mat.clearcoat_gloss)
    d = d_gtr1(wh, alpha)
    f = m.lerp(1.0, schlick_weight(m.cos_theta(wi)), 0.04)
    g = g2_smith_separable(wo, wi, 0.25, 0.25)
    dwh_wi = m.dot(wh, wi)
    num = d * jnp.abs(m.cos_theta(wh)) if corrected else d
    pdf = num / jnp.where(dwh_wi == 0.0, 1.0, 4.0 * dwh_wi)
    pdf = jnp.where(dwh_wi == 0.0, 0.0, pdf)
    denom = 4.0 * jnp.abs(m.cos_theta(wo)) * jnp.abs(m.cos_theta(wi))
    val = d * g * f / jnp.where(denom == 0.0, 1.0, denom)
    val = jnp.where(denom == 0.0, 0.0, val)
    active = mat.clearcoat > 0.0
    fv = jnp.where(active[..., None], val[..., None] * jnp.ones((3,), wo.dtype), 0.0)
    return fv, jnp.where(active, pdf, 0.0)


def eval_sheen(mat, wo, wi):
    """Additive sheen -- disney_sheen.cuh:15-37. No pdf."""
    wh = wi + wo
    wh_zero = m.dot(wh, wh) == 0.0
    wh_n = wh / jnp.sqrt(jnp.where(wh_zero, 1.0, m.dot(wh, wh)))[..., None]
    lum = m.luminance(m.srgb_to_linear_gamma22(mat.base_color))
    tint = jnp.where(
        (lum > 0.0)[..., None],
        mat.base_color / jnp.where(lum > 0.0, lum, 1.0)[..., None],
        1.0,
    )
    cos_d = m.dot(wi, wh_n)
    val = (
        m.lerp(jnp.ones_like(tint), tint, mat.sheen_tint[..., None])
        * mat.sheen[..., None]
        * schlick_weight(cos_d)[..., None]
    )
    inactive = (mat.sheen <= 0.0) | wh_zero
    return jnp.where(inactive[..., None], 0.0, val)


# ── lobe samplers (parity) ─────────────────────────────────────────────────


def sample_specular_brdf(mat, wo, u, corrected=False):
    """disney_specular.cuh:151-170: NDF sample, flip wh to wo side, reflect.

    ``corrected=True`` samples the *visible* normal distribution instead
    (the sampler the reference implemented but never called,
    disney_specular.cuh:85-110,157) -- consistent with the VNDF-style pdf the
    eval already returns, so sampler and pdf finally agree.
    """
    ax, ay = roughness_to_alpha_aniso(mat.roughness, mat.anisotropic)
    if corrected:
        wh = sample_gtr2_vndf(wo, ax, ay, u)
    else:
        wh = sample_gtr2_ndf(wo, ax, ay, u)
    wh = jnp.where((m.dot(wo, wh) < 0.0)[..., None], -wh, wh)
    wi = m.reflect(wo, wh)
    f, pdf = eval_specular_brdf(mat, wo, wh, wi, corrected=corrected)
    dead = m.cos_theta(wi) <= 0.0
    return wi, jnp.where(dead[..., None], 0.0, f), jnp.where(dead, 0.0, pdf)


def sample_clearcoat(mat, wo, u, corrected=False):
    """disney_clearcoat.cuh:61-78."""
    alpha = m.lerp(0.1, 0.001, mat.clearcoat_gloss)
    wh = sample_gtr1_ndf(wo, alpha, u)
    wh = jnp.where((m.dot(wh, wo) < 0.0)[..., None], -wh, wh)
    wh = wh / jnp.sqrt(m.dot(wh, wh))[..., None]
    wi = m.reflect(wo, wh)
    f, pdf = eval_clearcoat(mat, wo, wh, wi, corrected=corrected)
    dead = ~m.same_hemisphere(wo, wi)
    return wi, jnp.where(dead[..., None], 0.0, f), jnp.where(dead, 0.0, pdf)


def sample_diffuse(mat, wo, u):
    """disney_diffuse.cuh:57-62."""
    wi = sm.sample_cosine_hemisphere(u)
    f, pdf = eval_diffuse(mat, wo, wi)
    return wi, f, pdf


def sample_glass(mat, wo, u_wh, u_choice, u_ndf_tir, u_ndf_choice):
    """disney_specular.cuh:216-244 with exact draw accounting.

    Returns (wi, f, pdf, consumed): consumed is 4 (transmit), 5 (TIR->reflect,
    the choice draw short-circuited away), or 6 (Fresnel reflect).
    """
    a_t = roughness_to_alpha(mat.specular_transmission_roughness)
    wh = sample_gtr2_walter(a_t, u_wh)
    flip = (m.cos_theta(wo) < 0.0) & ~m.same_hemisphere(wo, wh)
    wh = jnp.where(flip[..., None], -wh, wh)

    eta_i, eta_t, eta = relative_eta(wo, mat.ior)
    r = fresnel_dielectric(wo, wh, eta_i, eta_t)
    t = 1.0 - r
    ok, wi_refr = m.refract(wo, wh, eta)
    choose_reflect = (~ok) | (u_choice < r / (r + t))

    ax, ay = roughness_to_alpha_aniso(mat.roughness, mat.anisotropic)
    wh_r = jnp.where(
        ok[..., None],
        sample_gtr2_ndf(wo, ax, ay, u_ndf_choice),
        sample_gtr2_ndf(wo, ax, ay, u_ndf_tir),
    )
    wi_refl = m.reflect(wo, wh_r)
    wi_refl = wi_refl / jnp.sqrt(m.dot(wi_refl, wi_refl))[..., None]

    wi = jnp.where(choose_reflect[..., None], wi_refl, wi_refr)
    wh_used = jnp.where(choose_reflect[..., None], wh_r, wh)
    f, pdf = eval_specular_bsdf(mat, wo, wh_used, wi)
    consumed = jnp.where(~ok, 5, jnp.where(choose_reflect, 6, 4))
    return wi, f, pdf, consumed


# ── top-level sample (trace-path entry) ────────────────────────────────────


def lobe_probabilities(mat):
    """disney.cuh:15-29 -- normalized discrete lobe weights."""
    dw = (1.0 - mat.specular_transmission) * (1.0 - mat.metallic)
    mw = mat.metallic
    cw = 0.25 * mat.clearcoat
    gw = (1.0 - mat.metallic) * mat.specular_transmission
    factor = 1.0 / (mw + gw + dw + cw)
    return mw * factor, dw * factor, cw * factor, gw * factor


class BsdfSample(NamedTuple):
    f: jnp.ndarray  # [N,3] reflectance (sheen included)
    wi: jnp.ndarray  # [N,3] local frame
    pdf: jnp.ndarray  # [N] per-lobe pdf (parity: no selection prob)
    lobe: jnp.ndarray  # [N] i32 LOBE_*
    state: jnp.ndarray  # [N] uint32 advanced RNG state


def sample(mat, wo, state, prev_lobe, corrected: bool = False) -> BsdfSample:
    """Parity port of sample_disney (disney.cuh:31-66), wavefront-batched.

    mat: per-ray gathered Materials pytree; wo [N,3] local; state [N] uint32;
    prev_lobe [N] i32 (the across-bounce sampled_lobe, device.cu:127).

    ``corrected=True`` (RenderSettings.parity=False) replaces the reference's
    knowingly-wrong choices: VNDF metal sampling, cosine-complete clearcoat
    pdf, and a returned pdf that includes the discrete lobe-selection
    probability (the proper mixture estimator).  RNG draw accounting is kept
    identical so parity/corrected renders stay stream-aligned.
    """
    u, states = rng_mod.next_f32_n(state, 6)
    p = u[0]
    u2 = jnp.stack([u[1], u[2]], axis=-1)

    p_metal, p_diff, p_cc, p_glass = lobe_probabilities(mat)
    force_btdf = (m.cos_theta(wo) < 0.0) & (prev_lobe == LOBE_GLASS)

    c1 = p_metal
    c2 = p_metal + p_cc
    c3 = p_metal + p_cc + p_diff
    sel_metal = ~force_btdf & (p <= c1)
    sel_cc = ~force_btdf & (p > c1) & (p <= c2)
    sel_diff = ~force_btdf & (p > c2) & (p <= c3)
    sel_glass = ~(sel_metal | sel_cc | sel_diff)  # disney.cuh:59 (p_glass>=0 always true)

    # Double-where input sanitization: each lobe runs on its selected lanes'
    # real inputs and on benign constants elsewhere.  Unselected lanes'
    # values are discarded by the pick below, but their *jacobians* are not:
    # a 0-cotangent meeting an inf/NaN partial (e.g. d wh / d roughness at a
    # degenerate sample) poisons material gradients as 0*inf=NaN.  Sanitized
    # inputs keep every unselected partial finite.
    def lobe_inputs(sel):
        sm = jax.tree.map(
            lambda v: jnp.where(sel[..., None] if v.ndim > sel.ndim else sel, v, 0.5), mat
        )
        sm = sm._replace(ior=jnp.where(sel, mat.ior, 1.5))
        up = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], wo.dtype), wo.shape)
        swo = jnp.where(sel[..., None], wo, up)
        su = jnp.where(sel[..., None], u2, 0.25)
        return sm, swo, su

    mat_m, wo_m, u_m = lobe_inputs(sel_metal)
    mat_c, wo_c, u_c = lobe_inputs(sel_cc)
    mat_d, wo_d, u_d = lobe_inputs(sel_diff)
    mat_g, wo_g, u_g = lobe_inputs(sel_glass)

    wi_m, f_m, pdf_m = sample_specular_brdf(mat_m, wo_m, u_m, corrected=corrected)
    wi_c, f_c, pdf_c = sample_clearcoat(mat_c, wo_c, u_c, corrected=corrected)
    wi_d, f_d, pdf_d = sample_diffuse(mat_d, wo_d, u_d)
    sg3 = sel_glass[..., None]
    wi_g, f_g, pdf_g, consumed_g = sample_glass(
        mat_g,
        wo_g,
        u_g,
        jnp.where(sel_glass, u[3], 0.25),
        jnp.where(sg3, jnp.stack([u[3], u[4]], axis=-1), 0.25),
        jnp.where(sg3, jnp.stack([u[4], u[5]], axis=-1), 0.25),
    )

    def pick(vm, vc, vd, vg):
        expand = vm.ndim > sel_metal.ndim
        sm_ = sel_metal[..., None] if expand else sel_metal
        sc_ = sel_cc[..., None] if expand else sel_cc
        sd_ = sel_diff[..., None] if expand else sel_diff
        return jnp.where(sm_, vm, jnp.where(sc_, vc, jnp.where(sd_, vd, vg)))

    wi = pick(wi_m, wi_c, wi_d, wi_g)
    f = pick(f_m, f_c, f_d, f_g)
    pdf = pick(pdf_m, pdf_c, pdf_d, pdf_g)
    if corrected:
        # mixture estimator: selection probability enters the pdf (the parity
        # path deliberately omits it, disney.cuh:44-63)
        pdf = pdf * pick(p_metal, p_cc, p_diff, p_glass)
    lobe = pick(
        jnp.full_like(prev_lobe, LOBE_METALLIC),
        jnp.full_like(prev_lobe, LOBE_CLEARCOAT),
        jnp.full_like(prev_lobe, LOBE_DIFFUSE),
        jnp.full_like(prev_lobe, LOBE_GLASS),
    )

    consumed = jnp.where(sel_glass, consumed_g, 3)
    # states: [6, N]; select states[consumed-1] per ray.  consumed is in
    # {3,4,5,6}; a where-chain over the four rows instead of a
    # take_along_axis gather
    new_state = jnp.where(
        consumed == 3,
        states[2],
        jnp.where(consumed == 4, states[3], jnp.where(consumed == 5, states[4], states[5])),
    )

    f = f + eval_sheen(mat, wo, wi)
    # Detached-sampling adjoints (radiative-backprop style): the *sample* --
    # direction, pdf, lobe choice, RNG stream -- is treated as a fixed
    # measurement device; gradients flow only through the BSDF value f (and
    # downstream emission/environment terms).  This is what makes the whole
    # integrator differentiable w.r.t. material parameters without score
    # terms (BASELINE.json north star; FD-validated in tests/test_diff.py).
    return BsdfSample(
        f=f,
        wi=jax.lax.stop_gradient(wi),
        pdf=jax.lax.stop_gradient(pdf),
        lobe=lobe,
        state=new_state,
    )


# ── combined eval for NEE/MIS (beyond-reference: its lights.hpp was dead) ──


def eval_all(mat, wo, wi):
    """Full-BSDF eval + combined pdf for a *given* wi.

    Needed by NEE/MIS (models/lights.py; the reference never had a working
    eval-for-direction -- its lights.hpp was dead code).

    Consistency note: because the parity sampler returns the *per-lobe* pdf
    without the discrete selection probability (disney.cuh:44-63), its
    estimator integrates the effective BSDF  f_eff = sum_k p_k f_k (+ sheen).
    eval_all therefore weights each lobe's f by its selection probability so
    NEE and BSDF sampling estimate the *same* transport; pdf is the standard
    mixture pdf sum_k p_k pdf_k.
    """
    p_metal, p_diff, p_cc, p_glass = lobe_probabilities(mat)
    refl = m.same_hemisphere(wo, wi)

    # reflection half-vector (oriented towards wo's hemisphere)
    wh_r = wo + wi
    wh_len = jnp.sqrt(jnp.maximum(m.dot(wh_r, wh_r), 1e-20))
    wh_r = wh_r / wh_len[..., None]
    wh_r = jnp.where((m.dot(wh_r, wo) < 0.0)[..., None], -wh_r, wh_r)

    f_d, pdf_d = eval_diffuse(mat, wo, wi)
    f_m, pdf_m = eval_specular_brdf(mat, wo, wh_r, wi)
    f_c, pdf_c = eval_clearcoat(mat, wo, wh_r, wi)

    up = m.cos_theta(wo) > 0.0
    both_up = refl & up & (m.cos_theta(wi) > 0.0)
    f_d = jnp.where(both_up[..., None], f_d, 0.0)
    pdf_d = jnp.where(both_up, pdf_d, 0.0)
    f_m = jnp.where(both_up[..., None], f_m, 0.0)
    pdf_m = jnp.where(both_up, pdf_m, 0.0)
    f_c = jnp.where(both_up[..., None], f_c, 0.0)
    pdf_c = jnp.where(both_up, pdf_c, 0.0)

    # glass: transmission half-vector -(eta_i wo + eta_t wi), Walter eq.16
    eta_i, eta_t, _ = relative_eta(wo, mat.ior)
    wh_t = -(eta_i[..., None] * wo + eta_t[..., None] * wi)
    wh_t_len = jnp.sqrt(jnp.maximum(m.dot(wh_t, wh_t), 1e-20))
    wh_t = wh_t / wh_t_len[..., None]
    wh_g = jnp.where(refl[..., None], wh_r, wh_t)
    f_g, pdf_g = eval_specular_bsdf(mat, wo, wh_g, wi)

    f = (
        p_diff[..., None] * f_d
        + p_metal[..., None] * f_m
        + p_cc[..., None] * f_c
        + jnp.where((p_glass > 0.0)[..., None], p_glass[..., None] * f_g, 0.0)
    )
    pdf = (
        p_diff * pdf_d
        + p_metal * pdf_m
        + p_cc * pdf_c
        + p_glass * jnp.where(p_glass > 0.0, pdf_g, 0.0)
    )
    f = f + jnp.where(refl[..., None], eval_sheen(mat, wo, wi), 0.0)
    return f, pdf

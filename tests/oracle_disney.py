"""Scalar float32 oracle for the Disney BSDF parity tests.

An independent, straight-line scalar re-derivation of the reference sampler
semantics (/root/reference/path_tracer/src/device/disney/*.cuh) in numpy
float32, including the lazy per-branch RNG consumption.  The batched JAX
implementation (owl_path_tracer.ops.disney) is tested against this for
random materials and directions; agreement of (f, wi, pdf, lobe, rng state)
validates both the math and the draw accounting.
"""
import numpy as np

F = np.float32
M32 = 0xFFFFFFFF
PI = F(3.14159265358979323)
TWO_PI = F(6.28318530717958648)
INV_PI = F(0.31830988618379067)
ALPHA_MIN = F(1e-3)

LOBE_NONE, LOBE_DIFFUSE, LOBE_CLEARCOAT, LOBE_METALLIC, LOBE_GLASS = -1, 0, 1, 2, 3


class Lcg:
    def __init__(self, state):
        self.state = int(state) & M32

    def next(self):
        self.state = (16807 * self.state + 1013904223) & M32
        return F(np.float32(np.uint32(self.state)) * np.float32(2.0**-32))

    def next2(self):
        return self.next(), self.next()


def v3(x=0.0, y=0.0, z=0.0):
    return np.array([x, y, z], np.float32)


def dot(a, b):
    return F(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def cross(a, b):
    return np.cross(a, b).astype(np.float32)


def normalize(v):
    return (v / F(np.sqrt(dot(v, v)))).astype(np.float32)


def cos_theta(w):
    return F(w[2])


def sin_theta(w):
    return F(np.sqrt(max(F(0), F(1) - cos_theta(w) ** 2)))


def tan_theta(w):
    st, ct = sin_theta(w), cos_theta(w)
    if ct == 0:
        return F(np.inf) if st > 0 else F(np.nan)
    return F(st / ct)


def cos_phi(w):
    st = sin_theta(w)
    return F(1.0) if st == 0 else F(np.clip(w[0] / st, -1, 1))


def sin_phi(w):
    st = sin_theta(w)
    return F(1.0) if st == 0 else F(np.clip(w[1] / st, -1, 1))


def same_hemisphere(a, b):
    return a[2] * b[2] > 0


def reflect(w, n):
    return (F(2) * dot(w, n) * n - w).astype(np.float32)


def refract(w, n, eta):
    if eta == 1.0:
        return True, (-w).astype(np.float32)
    ci = dot(w, n)
    s2i = max(F(0), F(1) - ci * ci)
    s2t = F(eta * eta * s2i)
    if s2t > 1.0:
        return False, v3()
    ct = F(np.sqrt(F(1) - s2t))
    return True, (eta * -w + (F(eta * ci) - ct) * n).astype(np.float32)


def lerp(a, b, t):
    return a + (b - a) * t


def sqr(x):
    return x * x


def schlick_weight(c):
    m = F(np.clip(F(1) - c, 0, 1))
    return F(m * m * m * m * m)


def luminance(c):
    return F(F(0.2126) * c[0] + F(0.7152) * c[1] + F(0.0722) * c[2])


def to_sphere(sin_t, cos_t, phi):
    return v3(sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t)


def roughness_to_alpha(r):
    return F(max(ALPHA_MIN, np.clip(sqr(F(r)), 0, 1)))


def roughness_to_alpha2(r, aniso):
    aspect = F(np.sqrt(F(1) - F(0.9) * F(aniso)))
    return F(max(ALPHA_MIN, sqr(F(r)) / aspect)), F(max(ALPHA_MIN, sqr(F(r)) * aspect))


def relative_eta(wo, ior):
    if cos_theta(wo) > 0:
        ei, et = F(1.0), F(ior)
    else:
        ei, et = F(ior), F(1.0)
    return ei, et, F(ei / et)


def fresnel_eq(i, m, ei, et):
    c = F(abs(dot(i, m)))
    den = F(sqr(F(et / ei)) - F(1) + sqr(c))
    if den < 0:
        return F(1.0)
    g = F(np.sqrt(den))
    return F(
        F(0.5)
        * sqr(F((g - c) / (g + c)))
        * (F(1) + sqr(F(c * (g + c) - F(1))) / sqr(F(c * (g - c) + F(1))))
    )


def smith_lambda(w, ax, ay):
    t = tan_theta(w)
    if np.isinf(t):
        return F(0.0)
    alpha0 = F(np.sqrt(sqr(F(cos_phi(w) * ax)) + sqr(F(sin_phi(w) * ay))))
    a = F(1.0 / (alpha0 * t))
    return F((F(-1) + F(np.sqrt(F(1) + F(1) / sqr(a)))) / F(2))


def g1(w, ax, ay):
    return F(1.0 / (1.0 + smith_lambda(w, ax, ay)))


def d_gtr2(wm, ax, ay):
    t2 = sqr(tan_theta(wm))
    if np.isinf(t2):
        return F(0.0)
    cos4 = sqr(sqr(cos_theta(wm)))
    e = F(1) + t2 * (sqr(cos_phi(wm)) / sqr(F(ax)) + sqr(sin_phi(wm)) / sqr(F(ay)))
    return F(1.0 / (PI * ax * ay * cos4 * sqr(e)))


def d_gtr1(wh, alpha):
    if alpha >= 1:
        return INV_PI
    a2 = sqr(F(alpha))
    return F((a2 - F(1)) / (PI * F(np.log(a2)) * (F(1) + (a2 - F(1)) * sqr(cos_theta(wh)))))


def sample_gtr2_ndf(wo, ax, ay, u0, u1):
    phi = F(np.arctan(ay / ax * np.tan(TWO_PI * u1 + INV_PI)))
    if u1 > 0.5:
        phi = F(phi + PI)
    sp, cp = F(np.sin(phi)), F(np.cos(phi))
    alpha2 = F(1.0 / (sqr(cp) / sqr(ax) + sqr(sp) / sqr(ay)))
    tt2 = F(alpha2 * u0 / (1 - u0))
    ct = F(1.0 / np.sqrt(1 + tt2))
    st = F(np.sqrt(max(F(0), F(1) - sqr(ct))))
    return normalize(to_sphere(st, ct, phi))


def sample_gtr1_ndf(wo, a, u0, u1):
    a2 = sqr(F(a))
    ct = F(np.sqrt(max(F(0), (F(1) - F(np.power(a2, F(1) - u0))) / (F(1) - a2))))
    st = F(np.sqrt(max(F(0), F(1) - sqr(ct))))
    phi = F(TWO_PI * u1)
    wh = to_sphere(st, ct, phi)
    if not same_hemisphere(wo, wh):
        wh = -wh
    return wh


def sample_gtr2_walter(a, u0, u1):
    theta = F(np.arctan(a * np.sqrt(u0) / np.sqrt(F(1) - u0)))
    phi = F(TWO_PI * u1)
    return to_sphere(F(np.sin(theta)), F(np.cos(theta)), phi)


def sample_concentric_disk(u0, u1):
    dx, dy = F(2 * u0 - 1), F(2 * u1 - 1)
    if dx == 0 and dy == 0:
        return F(0), F(0)
    if abs(dx) > abs(dy):
        r, phi = dx, F(np.pi / 4) * (dy / dx)
    else:
        r, phi = dy, F(np.pi / 2) - F(np.pi / 4) * (dx / dy)
    return F(r * np.cos(phi)), F(r * np.sin(phi))


def sample_cosine_hemisphere(u0, u1):
    x, y = sample_concentric_disk(u0, u1)
    z = F(np.sqrt(max(F(0), F(1) - sqr(x) - sqr(y))))
    return v3(x, y, z)


def tint(base):
    lum = luminance(base)
    return (base / lum).astype(np.float32) if lum > 0 else v3(1, 1, 1)


def eval_diffuse(mat, wo, wi):
    fo = schlick_weight(cos_theta(wo))
    fi = schlick_weight(cos_theta(wi))
    lamb = (mat["base_color"] * INV_PI).astype(np.float32)
    fd = F((1 - 0.5 * fo) * (1 - 0.5 * fi))
    rr = F(mat["roughness"] * (dot(wo, wi) + 1))
    fr = F(rr * (fi + fo + fo * fi * (rr - 1)))
    pdf = F(abs(cos_theta(wi)) * INV_PI)
    return (lamb * (fd + fr)).astype(np.float32), pdf


def eval_specular_brdf(mat, wo, wh, wi):
    c_tint = tint(mat["base_color"])
    one = v3(1, 1, 1)
    c_spec = lerp(
        F(0.08) * mat["specular"] * lerp(one, c_tint, mat["specular_tint"]),
        mat["base_color"],
        mat["metallic"],
    ).astype(np.float32)
    ax, ay = roughness_to_alpha2(mat["roughness"], mat["anisotropic"])
    d = d_gtr2(wh, ax, ay)
    g = F(1.0 / (1.0 + smith_lambda(wo, ax, ay) + smith_lambda(wi, ax, ay)))
    fr = lerp(c_spec, one, schlick_weight(dot(wi, wh))).astype(np.float32)
    pdf = F(d * g1(wo, ax, ay) * max(F(0), dot(wo, wh)) / (4 * cos_theta(wo)))
    f = (d * g * fr / (4 * abs(cos_theta(wo)))).astype(np.float32)
    return f, pdf


def eval_specular_bsdf(mat, wo, wh, wi):
    ei, et, eta = relative_eta(wo, mat["ior"])
    r = fresnel_eq(wo, wh, ei, et)
    t = F(1 - r)
    if same_hemisphere(wo, wi):
        pdf = F(r / (r + t))
        return (mat["base_color"] * (r / abs(cos_theta(wi)))).astype(np.float32), pdf
    pdf = F(t / (r + t))
    f = (np.sqrt(mat["base_color"]) * (t / abs(cos_theta(wi))) / sqr(eta)).astype(np.float32)
    return f, pdf


def eval_clearcoat(mat, wo, wh, wi):
    if mat["clearcoat"] <= 0:
        return v3(), F(0)
    d = d_gtr1(wh, lerp(F(0.1), F(0.001), mat["clearcoat_gloss"]))
    fr = lerp(F(1.0), schlick_weight(cos_theta(wi)), F(0.04))
    g = g1(wo, F(0.25), F(0.25)) * g1(wi, F(0.25), F(0.25))
    pdf = F(d / (4 * dot(wh, wi)))
    val = F(d * g * fr / (4 * abs(cos_theta(wo)) * abs(cos_theta(wi))))
    return v3(val, val, val), pdf


def eval_sheen(mat, wo, wi):
    if mat["sheen"] <= 0:
        return v3()
    wh = (wi + wo).astype(np.float32)
    if wh[0] == 0 and wh[1] == 0 and wh[2] == 0:
        return v3()
    wh = normalize(wh)
    lin = np.power(mat["base_color"], F(2.2)).astype(np.float32)
    lum = luminance(lin)
    tn = (mat["base_color"] / lum).astype(np.float32) if lum > 0 else v3(1, 1, 1)
    cd = dot(wi, wh)
    return (lerp(v3(1, 1, 1), tn, mat["sheen_tint"]) * mat["sheen"] * schlick_weight(cd)).astype(np.float32)


def sample_disney(mat, wo, rng: Lcg, prev_lobe):
    """Port of disney.cuh:31-66 with exact draw ordering."""
    dw = F((1 - mat["specular_transmission"]) * (1 - mat["metallic"]))
    mw = F(mat["metallic"])
    cw = F(0.25 * mat["clearcoat"])
    gw = F((1 - mat["metallic"]) * mat["specular_transmission"])
    factor = F(1.0 / (mw + gw + dw + cw))
    pm, pg, pd, pc = F(mw * factor), F(gw * factor), F(dw * factor), F(cw * factor)

    force_btdf = cos_theta(wo) < 0 and prev_lobe == LOBE_GLASS
    p = rng.next()

    if not force_btdf and p <= pm:
        ax, ay = roughness_to_alpha2(mat["roughness"], mat["anisotropic"])
        u0, u1 = rng.next2()
        wh = sample_gtr2_ndf(wo, ax, ay, u0, u1)
        if dot(wo, wh) < 0:
            wh = -wh
        wi = reflect(wo, wh)
        if cos_theta(wi) <= 0:
            f, pdf = v3(), F(0)
        else:
            f, pdf = eval_specular_brdf(mat, wo, wh, wi)
        lobe = LOBE_METALLIC
    elif not force_btdf and pm < p <= pm + pc:
        a = lerp(F(0.1), F(0.001), mat["clearcoat_gloss"])
        u0, u1 = rng.next2()
        wh = sample_gtr1_ndf(wo, a, u0, u1)
        if dot(wh, wo) < 0:
            wh = -wh
        wh = normalize(wh)
        wi = reflect(wo, wh)
        if not same_hemisphere(wo, wi):
            f, pdf = v3(), F(0)
        else:
            f, pdf = eval_clearcoat(mat, wo, wh, wi)
        lobe = LOBE_CLEARCOAT
    elif not force_btdf and pm + pc < p <= pm + pc + pd:
        u0, u1 = rng.next2()
        wi = sample_cosine_hemisphere(u0, u1)
        f, pdf = eval_diffuse(mat, wo, wi)
        lobe = LOBE_DIFFUSE
    else:
        u0, u1 = rng.next2()
        wh = sample_gtr2_walter(roughness_to_alpha(mat["specular_transmission_roughness"]), u0, u1)
        if cos_theta(wo) < 0 and not same_hemisphere(wo, wh):
            wh = -wh
        ei, et, eta = relative_eta(wo, mat["ior"])
        r = fresnel_eq(wo, wh, ei, et)
        t = F(1 - r)
        ok, wi = refract(wo, wh, eta)
        if (not ok) or rng.next() < r / (r + t):
            ax, ay = roughness_to_alpha2(mat["roughness"], mat["anisotropic"])
            u0, u1 = rng.next2()
            wh = sample_gtr2_ndf(wo, ax, ay, u0, u1)
            wi = normalize(reflect(wo, wh))
        f, pdf = eval_specular_bsdf(mat, wo, wh, wi)
        lobe = LOBE_GLASS

    f = (f + eval_sheen(mat, wo, wi)).astype(np.float32)
    return f, wi, pdf, lobe

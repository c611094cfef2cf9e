"""Disney BSDF parity tests: batched JAX sampler vs the scalar float32 oracle,
including the branch-dependent RNG draw accounting."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from owl_path_tracer.ops import disney, rng
from owl_path_tracer.models import material as material_mod
import oracle_disney as oracle


def random_material(r: np.random.Generator, **force):
    vals = dict(
        base_color=tuple(r.uniform(0.05, 1.0, 3)),
        subsurface=0.0,
        metallic=float(r.uniform(0, 1)),
        specular=float(r.uniform(0, 1)),
        specular_tint=float(r.uniform(0, 1)),
        roughness=float(r.uniform(0.05, 1)),
        anisotropic=float(r.uniform(0, 0.8)),
        sheen=float(r.uniform(0, 1)),
        sheen_tint=float(r.uniform(0, 1)),
        clearcoat=float(r.uniform(0, 1)),
        clearcoat_gloss=float(r.uniform(0, 1)),
        ior=float(r.uniform(1.1, 2.0)),
        specular_transmission=float(r.uniform(0, 1)),
        specular_transmission_roughness=float(r.uniform(0, 1)),
        emission=0.0,
    )
    vals.update(force)
    return vals


def to_oracle_mat(vals):
    m = {k: np.float32(v) for k, v in vals.items() if k != "base_color"}
    m["base_color"] = np.asarray(vals["base_color"], np.float32)
    return m


def to_jax_mat(list_of_vals):
    mats = [material_mod.single(**v) for v in list_of_vals]
    return jax.tree.map(lambda *xs: jnp.concatenate(xs), *mats)


def rand_dir_upper(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[:, 2] = np.abs(v[:, 2]) + 0.05
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v


N_CASES = 200


def run_parity_case(seed, force_mat=None, wo_sign=+1, prev_lobe=oracle.LOBE_NONE):
    r = np.random.default_rng(seed)
    mats = [random_material(r, **(force_mat or {})) for _ in range(N_CASES)]
    wo = rand_dir_upper(r, N_CASES)
    wo[:, 2] *= wo_sign
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    states = np.asarray(
        rng.seed(jnp.arange(N_CASES, dtype=jnp.uint32), jnp.full((N_CASES,), seed, jnp.uint32))
    )
    prev = np.full(N_CASES, prev_lobe, np.int32)

    # oracle (scalar loop)
    o_f = np.zeros((N_CASES, 3), np.float32)
    o_wi = np.zeros((N_CASES, 3), np.float32)
    o_pdf = np.zeros(N_CASES, np.float32)
    o_lobe = np.zeros(N_CASES, np.int32)
    o_state = np.zeros(N_CASES, np.uint32)
    for i in range(N_CASES):
        lcg = oracle.Lcg(states[i])
        f, wi, pdf, lobe = oracle.sample_disney(to_oracle_mat(mats[i]), wo[i], lcg, int(prev[i]))
        o_f[i], o_wi[i], o_pdf[i], o_lobe[i], o_state[i] = f, wi, pdf, lobe, lcg.state

    # batched jax
    jm = to_jax_mat(mats)
    out = disney.sample(jm, jnp.asarray(wo), jnp.asarray(states), jnp.asarray(prev))
    j_f = np.asarray(out.f)
    j_wi = np.asarray(out.wi)
    j_pdf = np.asarray(out.pdf)
    j_lobe = np.asarray(out.lobe)
    j_state = np.asarray(out.state)

    np.testing.assert_array_equal(j_lobe, o_lobe)
    np.testing.assert_array_equal(j_state, o_state)  # draw accounting must be exact
    # float compare with tolerance (op-order differences); skip non-finite
    fin = np.isfinite(o_f).all(-1) & np.isfinite(j_f).all(-1) & (o_pdf > 1e-6)
    assert fin.mean() > 0.5
    np.testing.assert_allclose(j_wi[fin], o_wi[fin], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(j_pdf[fin], o_pdf[fin], rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(j_f[fin], o_f[fin], rtol=5e-3, atol=1e-4)
    return o_lobe


def test_parity_mixed_materials():
    lobes = run_parity_case(0)
    # mixed params should exercise several lobes
    assert len(np.unique(lobes)) >= 3


def test_parity_pure_diffuse():
    run_parity_case(1, dict(metallic=0.0, specular_transmission=0.0, clearcoat=0.0))


def test_parity_pure_metal():
    run_parity_case(2, dict(metallic=1.0, specular_transmission=0.0, clearcoat=0.0))


def test_parity_glass():
    lobes = run_parity_case(3, dict(metallic=0.0, specular_transmission=1.0, clearcoat=0.0))
    assert (lobes == oracle.LOBE_GLASS).all()


def test_parity_glass_from_inside():
    # wo below surface + prev glass -> force_btdf branch (disney.cuh:40)
    run_parity_case(
        4,
        dict(metallic=0.3, specular_transmission=0.9, clearcoat=0.2),
        wo_sign=-1,
        prev_lobe=oracle.LOBE_GLASS,
    )


def test_parity_clearcoat_heavy():
    run_parity_case(5, dict(metallic=0.0, specular_transmission=0.0, clearcoat=1.0, sheen=0.5))


def test_lobe_probabilities_sum_to_one():
    r = np.random.default_rng(9)
    mats = to_jax_mat([random_material(r) for _ in range(64)])
    pm, pd, pc, pg = disney.lobe_probabilities(mats)
    np.testing.assert_allclose(np.asarray(pm + pd + pc + pg), 1.0, atol=1e-5)


def test_eval_all_matches_diffuse_lobe():
    # pure diffuse material: eval_all should equal the diffuse lobe (+0 others)
    r = np.random.default_rng(10)
    mats = to_jax_mat(
        [random_material(r, metallic=0.0, specular_transmission=0.0, clearcoat=0.0, sheen=0.0)
         for _ in range(64)]
    )
    wo = jnp.asarray(rand_dir_upper(r, 64))
    wi = jnp.asarray(rand_dir_upper(r, 64))
    f_all, pdf_all = disney.eval_all(mats, wo, wi)
    f_d, pdf_d = disney.eval_diffuse(mats, wo, wi)
    np.testing.assert_allclose(np.asarray(pdf_all), np.asarray(pdf_d), rtol=1e-4)
    # metal lobe eval at specular=0,metallic=0 still contributes c_spec=0 -> f equal
    np.testing.assert_allclose(np.asarray(f_all), np.asarray(f_d), rtol=1e-3, atol=1e-5)


def test_eval_all_finite_and_nonnegative_pdf():
    r = np.random.default_rng(11)
    mats = to_jax_mat([random_material(r) for _ in range(256)])
    wo = jnp.asarray(rand_dir_upper(r, 256))
    wi_np = rand_dir_upper(r, 256)
    wi_np[::3, 2] *= -1  # include transmission directions
    wi = jnp.asarray(wi_np / np.linalg.norm(wi_np, axis=-1, keepdims=True))
    f, pdf = disney.eval_all(mats, wo, wi)
    assert np.isfinite(np.asarray(f)).all()
    assert (np.asarray(pdf) >= 0).all()


# ── corrected mode (parity=False) ──────────────────────────────────────────


def test_corrected_metal_sampler_pdf_consistency():
    """VNDF sampling + VNDF pdf must be chi-square consistent: histogram of
    sampled wi matches the returned pdf (this FAILS for the parity NDF
    sampler by design -- the reference's documented mismatch)."""
    r = np.random.default_rng(21)
    n = 200_000
    mat = material_mod.single(metallic=1.0, roughness=0.5, specular_transmission=0.0, clearcoat=0.0)
    mats = jax.tree.map(lambda a: jnp.broadcast_to(a, (n,) + a.shape[1:]), mat)
    wo = jnp.broadcast_to(jnp.asarray([0.3, 0.1, 0.946], jnp.float32), (n, 3))
    wo = wo / jnp.sqrt((wo**2).sum(-1, keepdims=True))
    u = jnp.asarray(r.random((n, 2), np.float32))
    wi, f, pdf = disney.sample_specular_brdf(mats, wo, u, corrected=True)
    wi, pdf = np.asarray(wi), np.asarray(pdf)
    live = pdf > 1e-6
    # MC estimate of integral of pdf over hemisphere via the sampler itself:
    # E[1] = 1 trivially; instead check E[g(wi)] == integral g * pdf via
    # importance identity with g = cos_theta:  E[cos/pdf] ~= integral cos
    est = (np.abs(wi[live, 2]) / pdf[live]).sum() / n
    np.testing.assert_allclose(est, np.pi, rtol=0.03)


def test_corrected_pdf_includes_selection_probability():
    r = np.random.default_rng(22)
    mats_list = [random_material(r, metallic=0.5, specular_transmission=0.0, clearcoat=0.0)
                 for _ in range(256)]
    jm = to_jax_mat(mats_list)
    wo = jnp.asarray(rand_dir_upper(r, 256))
    states = rng.seed(jnp.arange(256, dtype=jnp.uint32), jnp.full((256,), 9, jnp.uint32))
    prev = jnp.full((256,), -1, jnp.int32)
    par = disney.sample(jm, wo, states, prev, corrected=False)
    cor = disney.sample(jm, wo, states, prev, corrected=True)
    # same RNG accounting
    np.testing.assert_array_equal(np.asarray(par.state), np.asarray(cor.state))
    # diffuse-selected lanes: corrected pdf = parity pdf * p_diff < parity pdf
    p_m, p_d, p_c, p_g = disney.lobe_probabilities(jm)
    dsel = np.asarray(par.lobe) == disney.LOBE_DIFFUSE
    np.testing.assert_allclose(
        np.asarray(cor.pdf)[dsel],
        (np.asarray(par.pdf) * np.asarray(p_d))[dsel],
        rtol=1e-5,
    )

"""Wavefront path integrator: ``lax.scan`` over bounces, SoA over rays.

Wavefront replacement for the reference megakernel
(``/root/reference/path_tracer/src/device/device.cu:113-254``): instead of one
OptiX thread per pixel running a serial spp loop around a serial bounce loop,
a chunk of pixels traces in lockstep -- a scan over samples around a scan over
bounces, each bounce a batch of masked tensor ops (intersect -> classify ->
shade -> Russian roulette).  Dead lanes are masked, not compacted, inside a
chunk; compaction happens at the chunk granularity in the film layer.

Parity semantics reproduced exactly (SURVEY.md 3.3):
* miss -> env radiance (map | auto sky | const color) x intensity, terminate
  (device.cu:136-148);
* emissive hit -> radiance = scalar emission (monochrome!), terminate, **no
  light sampling** (device.cu:157-161);
* pdf < 1e-5 -> kill with zero contribution (device.cu:193);
* NaN/Inf f -> retry the bounce without advancing depth (device.cu:196-201;
  here a retry consumes one of the max_path_depth scan steps -- identical
  unless a ray NaNs close to the depth limit);
* inverted Russian roulette without 1/q compensation, skipped for the glass
  lobe, active only at depth > 3 (device.cu:209-214);
* per-pixel LCG stream: seeded from pixel coords only, continuous across spp
  (device.cu:226-229).

The NEE/MIS path (settings.use_nee) is the promoted-to-live version of the
reference's dead lights.hpp machinery -- see models/lights.py.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..models.scene import RenderSettings, Scene
from ..ops import disney
from ..ops import math as m
from ..ops import rng as rng_mod
from ..ops import texture as tex
from ..ops.intersect import HitRecord, closest_hit_brute


class PathState(NamedTuple):
    ray_o: jnp.ndarray  # [N,3]
    ray_d: jnp.ndarray  # [N,3]
    result: jnp.ndarray  # [N,3] final radiance*throughput once terminated
    throughput: jnp.ndarray  # [N,3]
    rng: jnp.ndarray  # [N] uint32
    alive: jnp.ndarray  # [N] bool
    prev_lobe: jnp.ndarray  # [N] i32 (across-bounce, device.cu:127)
    depth: jnp.ndarray  # [N] i32 logical depth (tracks NaN retries)
    prev_pdf: jnp.ndarray  # [N] mixture pdf of the spawning BSDF sample (MIS)


def make_brute_intersector(scene: Scene, tri_chunk: int = 512) -> Callable:
    def intersect(ray_o, ray_d):
        return closest_hit_brute(
            ray_o, ray_d, scene.vertices, scene.tri_idx, tri_chunk=tri_chunk
        )

    return intersect


def _environment_radiance(scene: Scene, settings: RenderSettings, ray_d):
    """Miss shading -- device.cu:136-148 (static branch on settings)."""
    if settings.environment_use and scene.env_map.shape[0] > 1:
        env = tex.sample_environment(scene.env_map, ray_d)
    elif settings.environment_auto:
        env = tex.sky_gradient(ray_d)
    else:
        env = jnp.broadcast_to(
            jnp.asarray(settings.environment_color, jnp.float32),
            ray_d.shape[:-1] + (3,),
        )
    return env * settings.environment_intensity


def _material_blob(scene: Scene):
    """[M,17] fused material table: one gather per wavefront, split after."""
    mt = scene.materials
    cols = [mt.base_color] + [getattr(mt, f)[:, None] for f in mt._fields if f != "base_color"]
    return jnp.concatenate(cols, axis=1)


def _material_lookup(scene: Scene, mat_id):
    """Materials row fetch: one [N,17] gather from the tiny [M,17] table
    (exact on every backend, where a one-hot product could run in TF32)."""
    return _material_blob(scene)[mat_id]


def _split_materials(mblob):
    from ..models.material import Materials

    scalars = {
        f: mblob[:, 3 + i]
        for i, f in enumerate(x for x in Materials._fields if x != "base_color")
    }
    return Materials(base_color=mblob[:, 0:3], **scalars)


def _tex_lookup(scene: Scene, mat_id, tc, base_color):
    tex_id = scene.mat_tex[mat_id]
    tex_color = tex.sample_atlas_nearest(scene.textures, tex_id, tc, scene.tex_hw)
    return jnp.where((tex_id >= 0)[..., None], tex_color, base_color)


def _fetch_surface_blob(scene: Scene, hit: HitRecord, blob, ray_o, ray_d, enable_textures: bool):
    """Surface fetch from the traversal kernel's attribute payload
    (ops/fused2.py attr replay) -- NO per-ray shade-blob gather.

    Hit position is ``o + t*d`` (algebraically equal to the reference's
    barycentric lerp, device.cu:59; differs by rounding only).
    """
    u = hit.uv[..., 0:1]
    v = hit.uv[..., 1:2]
    w = 1.0 - u - v
    pos = ray_o + hit.t[..., None] * ray_d

    sh_n = w * blob[:, 0:3] + u * blob[:, 3:6] + v * blob[:, 6:9]
    # miss lanes carry a ZERO payload; give them a unit default normal so
    # dead-lane BSDF math can't produce NaN partials that poison gradients
    # through the where-masking (0 * NaN = NaN in the backward pass)
    len2 = m.dot(sh_n, sh_n)
    unit = sh_n / jnp.sqrt(jnp.maximum(len2, 1e-20))[..., None]
    sh_n = jnp.where(
        (len2 > 1e-12)[..., None], unit,
        jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), unit.shape),
    )

    mat_id = blob[:, 15].astype(jnp.int32)
    mat = _split_materials(_material_lookup(scene, mat_id))
    if enable_textures:
        tc = w * blob[:, 9:11] + u * blob[:, 11:13] + v * blob[:, 13:15]
        mat = mat._replace(base_color=_tex_lookup(scene, mat_id, tc, mat.base_color))
    return pos, sh_n, sh_n, mat, mat_id


def _intersect(intersect_fn, ray_o, ray_d):
    """Normalize intersector results to (HitRecord, aux-blob-or-None)."""
    res = intersect_fn(ray_o, ray_d)
    if isinstance(res, HitRecord):
        return res, None
    return res


def _surface(scene, hit, aux, ray_o, ray_d, enable_textures):
    if aux is None:
        return _fetch_surface(scene, hit, enable_textures)
    return _fetch_surface_blob(scene, hit, aux, ray_o, ray_d, enable_textures)


def _fetch_surface(scene: Scene, hit: HitRecord, enable_textures: bool):
    """Geometry + material fetch at hit points -- device.cu:150-173.

    One [T,24] shade-blob gather + one [M,17] material gather per wavefront.
    Interpolation formulas match the reference bit-for-bit
    ((1-u-v)*a + u*b + v*c, device.cu:59,72).
    """
    tri = jnp.maximum(hit.tri, 0)
    u = hit.uv[..., 0:1]
    v = hit.uv[..., 1:2]
    w = 1.0 - u - v

    blob = scene.shade_blob[tri]  # [N,24]
    p0 = blob[:, 0:3]
    p1 = blob[:, 3:6]
    p2 = blob[:, 6:9]
    pos = w * p0 + u * p1 + v * p2
    geo_n = jnp.cross(p1 - p0, p2 - p0)
    geo_n = geo_n / jnp.sqrt(jnp.maximum(m.dot(geo_n, geo_n), 1e-20))[..., None]

    n0 = blob[:, 9:12]
    n1 = blob[:, 12:15]
    n2 = blob[:, 15:18]
    sh_n = w * n0 + u * n1 + v * n2
    sh_n = sh_n / jnp.sqrt(jnp.maximum(m.dot(sh_n, sh_n), 1e-20))[..., None]

    mat_id = scene.tri_mat[tri]
    mat = _split_materials(_material_lookup(scene, mat_id))

    if enable_textures:
        tc = w * blob[:, 18:20] + u * blob[:, 20:22] + v * blob[:, 22:24]
        mat = mat._replace(base_color=_tex_lookup(scene, mat_id, tc, mat.base_color))

    return pos, geo_n, sh_n, mat, mat_id


def trace_bounce(
    scene: Scene,
    settings: RenderSettings,
    state: PathState,
    intersect_fn: Callable,
    enable_textures: bool,
) -> PathState:
    """One wavefront bounce -- the body of the reference's depth loop."""
    hit, aux = _intersect(intersect_fn, state.ray_o, state.ray_d)

    # miss -> environment, terminate (device.cu:136-148)
    miss = state.alive & ~hit.hit
    env = _environment_radiance(scene, settings, state.ray_d)
    result = jnp.where(miss[..., None], env * state.throughput, state.result)
    alive = state.alive & hit.hit

    pos, _geo_n, sh_n, mat, _mat_id = _surface(
        scene, hit, aux, state.ray_o, state.ray_d, enable_textures
    )

    # emissive -> monochrome radiance, terminate (device.cu:157-161)
    emissive = alive & (mat.emission > 0.0)
    result = jnp.where(
        emissive[..., None], mat.emission[..., None] * state.throughput, result
    )
    alive = alive & ~emissive

    # local frame + BSDF sample (device.cu:176-190)
    wo = -state.ray_d
    t_b, b_b = m.onb(sh_n)
    local_wo = m.to_local(t_b, b_b, sh_n, wo)
    bs = disney.sample(
        mat, local_wo, state.rng, state.prev_lobe, corrected=not settings.parity
    )
    rng_state = jnp.where(alive, bs.state, state.rng)
    wi_world = m.to_world(t_b, b_b, sh_n, bs.wi)

    # degenerate pdf -> kill with zero contribution (device.cu:193)
    alive = alive & ~(bs.pdf < 1e-5)

    # NaN/Inf f -> retry bounce (device.cu:196-201)
    bad_f = ~jnp.isfinite(bs.f).all(axis=-1)
    ok = alive & ~bad_f

    cos_i = jnp.abs(m.cos_theta(bs.wi))
    # sanitize dead lanes *before* the division so their inf partials can't
    # poison material gradients (0-cotangent x inf = NaN)
    f_safe = jnp.where(ok[..., None], bs.f, 0.0)
    pdf_safe = jnp.where(ok, bs.pdf, 1.0)
    thr_new = state.throughput * f_safe * (cos_i / pdf_safe)[..., None]
    throughput = jnp.where(ok[..., None], thr_new, state.throughput)
    ray_o = jnp.where(ok[..., None], pos, state.ray_o)
    ray_d = jnp.where(ok[..., None], wi_world, state.ray_d)
    prev_lobe = jnp.where(ok, bs.lobe, state.prev_lobe)

    # inverted RR, no 1/q compensation, glass-exempt (device.cu:209-214)
    beta_max = jnp.max(throughput, axis=-1)
    rr_active = ok & (bs.lobe != disney.LOBE_GLASS) & (state.depth > settings.rr_start_depth)
    q = jnp.maximum(0.05, 1.0 - beta_max)
    rr_draw, rr_state = rng_mod.next_f32(rng_state)
    rng_state = jnp.where(rr_active, rr_state, rng_state)
    alive = alive & ~(rr_active & (rr_draw > q))

    depth = jnp.where(ok, state.depth + 1, state.depth)

    return PathState(
        ray_o=ray_o,
        ray_d=ray_d,
        result=result,
        throughput=throughput,
        rng=rng_state,
        alive=alive,
        prev_lobe=prev_lobe,
        depth=depth,
        prev_pdf=state.prev_pdf,
    )


def trace_bounce_nee(
    scene: Scene,
    settings: RenderSettings,
    lights,
    state: PathState,
    intersect_fn: Callable,
    occlude_fn: Callable,
    enable_textures: bool,
    allow_nee: jnp.ndarray | bool = True,
    env_light=None,
):
    """One bounce with next-event estimation + MIS.

    The live version of the reference's dead lighting machinery
    (lights.hpp:15-61 + visibiliy_test, device.cu:97-110): at every diffuse-ish
    vertex a light point is sampled, shadow-tested, and combined with the BSDF
    sample via the power heuristic.  Radiance accumulates additively (unlike
    the parity integrator's terminal-only writes) and Russian roulette is the
    standard compensated kind -- this mode is a better estimator of the same
    transport, not a bit-parity one.

    """
    from ..models import lights as lights_mod

    from ..models import envlight as envlight_mod

    hit, aux = _intersect(intersect_fn, state.ray_o, state.ray_d)

    # miss -> environment; MIS-weighted against env importance sampling when
    # an EnvLight is active (primary rays keep weight 1)
    miss = state.alive & ~hit.hit
    if env_light is not None:
        env = envlight_mod.env_radiance(env_light, state.ray_d)
        pdf_e = envlight_mod.pdf_env_direction(env_light, state.ray_d)
        from ..models import lights as _lm

        w_env = jnp.where(
            (state.depth == 0) | (state.prev_pdf <= 0.0),
            1.0,
            _lm.power_heuristic(1.0, state.prev_pdf, 1.0, pdf_e),
        )
        env = env * w_env[..., None]
    else:
        env = _environment_radiance(scene, settings, state.ray_d)
    result = state.result + jnp.where(miss[..., None], env * state.throughput, 0.0)
    alive = state.alive & hit.hit

    pos, _geo_n, sh_n, mat, _mat_id = _surface(
        scene, hit, aux, state.ray_o, state.ray_d, enable_textures
    )

    # emissive hit -> MIS-weighted emission, terminate (lights stay absorbing,
    # matching the reference's terminate-at-light behavior)
    emissive = alive & (mat.emission > 0.0)
    if lights is not None:
        pdf_l_hit = lights_mod.pdf_hit_light(lights, hit.tri, state.ray_d, hit.t, sh_n)
        w_b = jnp.where(
            (state.depth == 0) | (state.prev_pdf <= 0.0),
            1.0,
            lights_mod.power_heuristic(1.0, state.prev_pdf, 1.0, pdf_l_hit),
        )
    else:
        w_b = jnp.ones_like(hit.t)
    result = result + jnp.where(
        emissive[..., None], (w_b * mat.emission)[..., None] * state.throughput, 0.0
    )
    alive = alive & ~emissive

    wo = -state.ray_d
    t_b, b_b = m.onb(sh_n)
    local_wo = m.to_local(t_b, b_b, sh_n, wo)

    # ── next-event estimation (area lights) ──
    rng_state = state.rng
    if lights is not None:
        u_l, states_l = rng_mod.next_f32_n(rng_state, 3)
        rng_state = jnp.where(alive, states_l[-1], rng_state)
        ls = lights_mod.sample_lights(lights, pos, jnp.stack([u_l[0], u_l[1], u_l[2]], -1))
        wl_local = m.to_local(t_b, b_b, sh_n, ls.direction)
        f_l, pdf_b_l = disney.eval_all(mat, local_wo, wl_local)
        # the final scan iteration skips NEE so a depth-D render integrates
        # exactly transport orders 1..D, same as the BSDF-only estimator
        can_light = alive & (ls.pdf > 0.0) & (ls.emission > 0.0) & allow_nee
        w_l = lights_mod.power_heuristic(1.0, ls.pdf, 1.0, pdf_b_l)
        contrib = (
            f_l
            * (jnp.abs(m.cos_theta(wl_local)) * ls.emission * w_l
               / jnp.where(ls.pdf > 0.0, ls.pdf, 1.0))[..., None]
        )
        occluded = occlude_fn(pos, ls.direction, ls.distance - m.T_MIN)
        contrib = jnp.where((can_light & ~occluded)[..., None], contrib, 0.0)
        result = result + state.throughput * jnp.nan_to_num(contrib, nan=0.0, posinf=0.0)

    # ── environment NEE (CDF importance sampling, models/envlight.py) ──
    if env_light is not None:
        u_e, states_e = rng_mod.next_f32_n(rng_state, 2)
        rng_state = jnp.where(alive, states_e[-1], rng_state)
        es = envlight_mod.sample_env(env_light, jnp.stack([u_e[0], u_e[1]], -1))
        we_local = m.to_local(t_b, b_b, sh_n, es.direction)
        f_e, pdf_b_e = disney.eval_all(mat, local_wo, we_local)
        can_env = alive & (es.pdf > 0.0) & allow_nee
        env_occluded = occlude_fn(pos, es.direction, jnp.full(pos.shape[:1], m.T_MAX))
        from ..models import lights as _lm

        w_e = _lm.power_heuristic(1.0, es.pdf, 1.0, pdf_b_e)
        contrib_e = (
            f_e
            * es.radiance
            * (jnp.abs(m.cos_theta(we_local)) * w_e / jnp.where(es.pdf > 0.0, es.pdf, 1.0))[..., None]
        )
        contrib_e = jnp.where((can_env & ~env_occluded)[..., None], contrib_e, 0.0)
        result = result + state.throughput * jnp.nan_to_num(contrib_e, nan=0.0, posinf=0.0)

    # ── BSDF sample (shared sampler; mixture pdf recorded for MIS) ──
    bs = disney.sample(
        mat, local_wo, rng_state, state.prev_lobe, corrected=not settings.parity
    )
    rng_state = jnp.where(alive, bs.state, rng_state)
    wi_world = m.to_world(t_b, b_b, sh_n, bs.wi)
    _, pdf_mix = disney.eval_all(mat, local_wo, bs.wi)

    alive = alive & ~(bs.pdf < 1e-5)
    bad_f = ~jnp.isfinite(bs.f).all(axis=-1)
    ok = alive & ~bad_f

    cos_i = jnp.abs(m.cos_theta(bs.wi))
    f_safe = jnp.where(ok[..., None], bs.f, 0.0)
    pdf_safe = jnp.where(ok, bs.pdf, 1.0)
    thr_new = state.throughput * f_safe * (cos_i / pdf_safe)[..., None]
    throughput = jnp.where(ok[..., None], thr_new, state.throughput)
    ray_o = jnp.where(ok[..., None], pos, state.ray_o)
    ray_d = jnp.where(ok[..., None], wi_world, state.ray_d)
    prev_lobe = jnp.where(ok, bs.lobe, state.prev_lobe)
    prev_pdf = jnp.where(ok, pdf_mix, state.prev_pdf)

    # standard compensated Russian roulette (survival prob detached so the
    # 1/q compensation doesn't leak score-function terms into material grads)
    beta_max = jnp.max(throughput, axis=-1)
    rr_active = ok & (state.depth > settings.rr_start_depth)
    q = jax.lax.stop_gradient(jnp.clip(beta_max, 0.05, 1.0))
    rr_draw, rr_state = rng_mod.next_f32(rng_state)
    rng_state = jnp.where(rr_active, rr_state, rng_state)
    survive = ~rr_active | (rr_draw < q)
    throughput = jnp.where(
        (rr_active & survive)[..., None], throughput / q[..., None], throughput
    )
    alive = alive & survive

    depth = jnp.where(ok, state.depth + 1, state.depth)

    return PathState(
        ray_o=ray_o,
        ray_d=ray_d,
        result=result,
        throughput=throughput,
        rng=rng_state,
        alive=alive,
        prev_lobe=prev_lobe,
        depth=depth,
        prev_pdf=prev_pdf,
    )


def trace_paths(
    scene: Scene,
    settings: RenderSettings,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    rng_state: jnp.ndarray,
    intersect_fn: Callable,
    enable_textures: bool,
    lights=None,
    occlude_fn: Callable | None = None,
    env_light=None,
):
    """Trace a wavefront to termination; returns (radiance [N,3], rng')."""
    n = ray_o.shape[0]
    init = PathState(
        ray_o=ray_o,
        ray_d=ray_d,
        result=jnp.zeros((n, 3), jnp.float32),
        throughput=jnp.ones((n, 3), jnp.float32),
        rng=rng_state,
        alive=jnp.ones((n,), bool),
        prev_lobe=jnp.full((n,), disney.LOBE_NONE, jnp.int32),
        depth=jnp.zeros((n,), jnp.int32),
        prev_pdf=jnp.zeros((n,), jnp.float32),
    )

    use_nee = (
        settings.use_nee
        and occlude_fn is not None
        and (lights is not None or env_light is not None)
    )

    def body(carry, k):
        st, rays = carry
        rays = rays + jnp.sum(st.alive.astype(jnp.int32))
        if use_nee:
            nxt = trace_bounce_nee(
                scene, settings, lights, st, intersect_fn, occlude_fn, enable_textures,
                allow_nee=k < settings.max_path_depth - 1,
                env_light=env_light,
            )
        else:
            nxt = trace_bounce(scene, settings, st, intersect_fn, enable_textures)
        return (nxt, rays), None

    (final, rays), _ = jax.lax.scan(
        body, (init, jnp.int32(0)), jnp.arange(settings.max_path_depth),
        length=settings.max_path_depth,
    )
    return final.result, final.rng, rays


def sample_sum(
    scene: Scene,
    settings: RenderSettings,
    pixel_xy: jnp.ndarray,
    rng_state: jnp.ndarray,
    num_samples: int,
    intersect_fn: Callable,
    enable_textures: bool,
    lights=None,
    occlude_fn: Callable | None = None,
    env_light=None,
):
    """Accumulate ``num_samples`` per pixel -- the reference ray_gen spp loop
    (device.cu:229-244), resumable: the carried RNG state keeps the per-pixel
    LCG stream continuous across calls (the checkpoint/progressive API the
    reference lacks, SURVEY.md section 5).

    Returns (radiance sum [N,3], advanced rng state [N], rays traced).
    """
    fb = (settings.width, settings.height)

    def sample_body(carry, _):
        st, acc = carry
        j0, st = rng_mod.next_f32(st)
        j1, st = rng_mod.next_f32(st)
        jitter = jnp.stack([j0, j1], axis=-1)
        from ..models.camera import primary_rays

        o, d = primary_rays(scene.camera, pixel_xy, jitter, fb)
        radiance, st, r = trace_paths(
            scene, settings, o, d, st, intersect_fn, enable_textures,
            lights=lights, occlude_fn=occlude_fn, env_light=env_light,
        )
        return (st, acc + radiance), r

    (rng_out, acc), rays_per_sample = jax.lax.scan(
        sample_body,
        (rng_state, jnp.zeros(pixel_xy.shape[:-1] + (3,), jnp.float32)),
        None,
        length=num_samples,
    )
    # [num_samples] i32; summed in int64 on the host to avoid overflow
    return acc, rng_out, rays_per_sample


def render_pixels(
    scene: Scene,
    settings: RenderSettings,
    pixel_xy: jnp.ndarray,
    intersect_fn: Callable,
    enable_textures: bool,
    num_samples: int | None = None,
):
    """Render a chunk of pixels -- the reference ray_gen (device.cu:220-248).

    pixel_xy [N,2] i32 in reference launch coordinates (y=0 bottom row after
    the store flip).  Returns linear color [N,3] (spp-averaged, no gamma --
    gamma was commented out, device.cu:248).
    """
    spp = settings.max_samples if num_samples is None else num_samples
    state0 = rng_mod.seed(pixel_xy[..., 0], pixel_xy[..., 1])
    acc, _, _ = sample_sum(
        scene, settings, pixel_xy, state0, spp, intersect_fn, enable_textures
    )
    return acc / float(spp)


def make_brute_occluder(scene: Scene, tri_chunk: int = 512) -> Callable:
    from ..ops.intersect import any_hit_brute

    def occlude(pos, direction, max_dist):
        return any_hit_brute(
            pos, direction, scene.vertices, scene.tri_idx, t_max=max_dist, tri_chunk=tri_chunk
        )

    return occlude


def make_intersectors(scene: Scene, accel, tri_chunk: int = 512, fused2_block: int | None = None,
                      fused2_sort: bool | str = False, differentiable: bool = False):
    """Accel -> (intersect_fn, occlude_fn) dispatch shared by every renderer
    (film, wavefront, sharded).  ``accel=None`` selects the brute sweep.
    ``fused2_block`` overrides the fused2 kernel's rays-per-block.
    ``fused2_sort`` sorts each wave by a coherence key before the kernel.
    ``differentiable=True`` (the gradient path, render/diff.py) re-derives
    fused2 hit geometry in plain JAX on the kernel's detached winner
    topology, so camera/geometry gradients flow -- costs one [N,3]x3 vertex
    gather per wave, irrelevant at recovery-loop pixel counts."""
    from ..ops.cluster import ClusterBVH, cluster_occluded, make_cluster_intersector
    from ..ops.fused2 import (
        BLOCK_RAYS, Fused2BVH, fused2_occluded, make_fused2_intersector,
        make_fused2_intersector_diff,
    )
    from ..ops.traverse import DeviceBVH, bvh_occluded, make_bvh_intersector

    if isinstance(accel, Fused2BVH):
        blk = fused2_block or BLOCK_RAYS
        if differentiable:
            isect = make_fused2_intersector_diff(
                accel, scene.vertices, scene.tri_idx, block=blk, sort=fused2_sort,
            )
        else:
            isect = make_fused2_intersector(accel, block=blk, sort=fused2_sort)
        return (
            isect,
            lambda p, d, dist: fused2_occluded(
                p, d, accel, t_max=dist, block=blk, sort=fused2_sort
            ),
        )
    if isinstance(accel, ClusterBVH):
        return (
            make_cluster_intersector(accel),
            lambda p, d, dist: cluster_occluded(p, d, accel, t_max=dist),
        )
    if isinstance(accel, DeviceBVH):
        return (
            make_bvh_intersector(accel),
            lambda p, d, dist: bvh_occluded(p, d, accel, t_max=dist),
        )
    return (
        make_brute_intersector(scene, tri_chunk=tri_chunk),
        make_brute_occluder(scene, tri_chunk=tri_chunk),
    )

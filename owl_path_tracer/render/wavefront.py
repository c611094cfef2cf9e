"""Persistent-wavefront renderer with path regeneration.

The parity integrator (render/integrator.py) mirrors the reference's
per-pixel loops: a scan over spp around a scan over bounces, so lane
occupancy decays with depth (a convex-scene wave is ~45% idle by bounce 2).
This renderer keeps a fixed pool of lanes at ~full occupancy instead: every
iteration traces ONE bounce for every lane, scatter-adds finished paths into
the film, and immediately respawns those lanes on the next (pixel, sample)
work item -- the classic wavefront path-regeneration scheme, expressed with
static shapes (cumsum-compacted work assignment, no dynamic allocation).

Trade-off: samples of a pixel no longer run sequentially in one lane, so the
reference's sequential per-pixel LCG stream cannot be reproduced here; lanes
seed per (pixel, sample) instead.  This is the throughput mode the benchmark
uses -- estimator-equivalent to the parity renderer (same transport, same
BSDF), not bit-equal.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.camera import primary_rays
from ..models.scene import RenderSettings, Scene
from ..ops import disney
from ..ops import rng as rng_mod
from . import integrator


class PoolState(NamedTuple):
    pixel: jnp.ndarray  # [L] linear pixel index of each lane's current path
    ray_o: jnp.ndarray
    ray_d: jnp.ndarray
    throughput: jnp.ndarray
    result: jnp.ndarray
    rng: jnp.ndarray
    alive: jnp.ndarray  # lane is tracing a live path
    prev_lobe: jnp.ndarray
    depth: jnp.ndarray
    prev_pdf: jnp.ndarray  # MIS pdf of the spawning BSDF sample (NEE mode)
    work_counter: jnp.ndarray  # scalar i32: next work item (global queue) or
    #                            the pool's work base offset (strided mode)
    acc: jnp.ndarray  # film accumulator: [W*H,3] scatter mode, or
    #                   [L,P,3] per-lane pixel slots (strided mode, no scatter)
    rays: jnp.ndarray  # scalar i32 rays traced
    work_local: jnp.ndarray  # [L] i32 per-lane work cursor (strided mode)


def _spawn(scene, settings, lane_work_id, total_work, sample_base=0):
    """Work item -> (pixel, primary ray, rng state). Per-(pixel,sample) seed.

    ``sample_base`` offsets the GLOBAL sample index of this render's local
    sample ids: an spp-segmented render (production frames whose full
    pixel x sample id space exceeds int32, e.g. 1080x1440x12288 = 19.1G)
    seeds segment k's local sample s as (pixel, base_k + s) -- the union
    over segments draws exactly the stream set a single monolithic run
    would, so segmenting is estimator-identical."""
    spp = settings.max_samples
    pixel_lin = lane_work_id // spp
    sample = lane_work_id % spp
    px = pixel_lin % settings.width
    py = pixel_lin // settings.width
    # decorrelated per-sample stream: seed the tea hash with the two full
    # words (linear pixel id, sample id) -- distinct work items are distinct
    # hash inputs, so streams cannot collide by construction (a previous
    # px + 0x9E3779B1*sample folding aliased (pixel, sample) pairs)
    st = rng_mod.seed(
        pixel_lin.astype(jnp.uint32),
        sample.astype(jnp.uint32) + jnp.uint32(sample_base),
    )
    j0, st = rng_mod.next_f32(st)
    j1, st = rng_mod.next_f32(st)
    pixel_xy = jnp.stack([px, py], -1)
    o, d = primary_rays(
        scene.camera, pixel_xy, jnp.stack([j0, j1], -1), (settings.width, settings.height)
    )
    return pixel_lin, o, d, st


def wavefront_step(
    scene: Scene,
    settings: RenderSettings,
    st: PoolState,
    intersect_fn: Callable,
    enable_textures: bool,
    total_work: int,
    lights=None,
    occlude_fn: Callable | None = None,
    env_light=None,
    film_mode: str = "auto",
    work_map: Callable | None = None,
    local_spp: int | None = None,
    sample_base: int = 0,
) -> PoolState:
    """One bounce for every lane + regeneration of finished lanes.

    Two work-assignment modes, selected by the film layout (st.acc.ndim):

    * **global queue** (acc [W*H,3]): idle lanes take the next ids from a
      shared counter; finished paths bank into the film (a window of
      one-hot products, or a scatter-add).  Fully load-balanced.
    * **strided slices** (acc [L,P,3]): lane l owns work items
      [base + l*S, base + (l+1)*S) (S = P*spp, pixel-aligned), accumulating
      into its own P pixel slots via a one-hot -- NO scatter anywhere.
      Work imbalance averages out over the S items per lane.
    """
    strided = st.acc.ndim == 3  # acc [P,3,L] (lane-minor; see new_pool)
    # the strided film's banking math (lane_first_pixel/slot below) assumes
    # UNMAPPED contiguous global ids; combining it with the sharded "sample"
    # work split's id remapping would bank into wrong pixel slots silently
    assert not (strided and (work_map is not None or local_spp is not None)), (
        "strided film is incompatible with work_map/local_spp (sharded "
        "'sample' split) -- use the queue film there"
    )
    # park dead lanes' rays far outside every scene AABB: the traversal
    # kernel's scene gate then skips parked blocks entirely.  Only matters
    # in the end-of-frame drain (work exhausted, lanes can't respawn).
    # Idempotent: a parked lane re-parks.
    ray_o_t = jnp.where(st.alive[:, None], st.ray_o, 1e8)
    use_nee = settings.use_nee and occlude_fn is not None and (
        lights is not None or env_light is not None
    )
    # --- trace one bounce (parity kernel, or NEE/MIS when lights given) ---
    ps = integrator.PathState(
        ray_o=ray_o_t,
        ray_d=st.ray_d,
        result=st.result,
        throughput=st.throughput,
        rng=st.rng,
        alive=st.alive,
        prev_lobe=st.prev_lobe,
        depth=st.depth,
        prev_pdf=st.prev_pdf,
    )
    # uint32: a 1024-spp production segment traces ~3.8G alive-ray-steps,
    # which wraps int32 (the film was never affected; the counter is metric)
    rays = st.rays + jnp.sum(ps.alive.astype(jnp.uint32))
    if use_nee:
        ps = integrator.trace_bounce_nee(
            scene, settings, lights, ps, intersect_fn, occlude_fn,
            enable_textures, allow_nee=ps.depth < settings.max_path_depth - 1,
            env_light=env_light,
        )
    else:
        ps = integrator.trace_bounce(scene, settings, ps, intersect_fn, enable_textures)
    # depth exhaustion also terminates a path
    exhausted = ps.alive & (ps.depth >= settings.max_path_depth)
    path_done = st.alive & (~ps.alive | exhausted)

    lanes = st.pixel.shape[0]
    idle = path_done | ~st.alive
    if strided:
        # --- bank into per-lane pixel slots (one-hot, scatter-free) ---
        # acc is [P, 3, L]: the lane axis is minor
        p_slots = st.acc.shape[0]
        slice_items = p_slots * settings.max_samples
        lane_idx = jnp.arange(lanes, dtype=jnp.int32)
        lane_first_pixel = (st.work_counter + lane_idx * slice_items) // settings.max_samples
        slot = st.pixel - lane_first_pixel  # [L] in [0,P)
        onehot = (
            jnp.arange(p_slots, dtype=jnp.int32)[:, None] == slot[None, :]
        )  # [P,L]
        contrib = jnp.where(path_done[:, None], ps.result, 0.0).T  # [3,L]
        acc = st.acc + jnp.where(onehot[:, None, :], contrib[None, :, :], 0.0)

        # --- regenerate: each lane walks its own slice ---
        new_ids = st.work_counter + lane_idx * slice_items + st.work_local
        can_spawn = idle & (st.work_local < slice_items)
        work_local = jnp.where(can_spawn, st.work_local + 1, st.work_local)
        work_counter = st.work_counter
    else:
        # --- bank finished paths into the film ---
        # The queue hands ids in order and a path lives <= depth+1 steps, so
        # outstanding ids span < (depth+2)*lanes and all finished pixels fall
        # in a bounded window above the oldest live pixel.  When that window
        # is small, banking is a [3,L]x[L,W] one-hot product + one
        # dynamic-slice row update instead of a film scatter-add.
        n_pix = settings.width * settings.height
        # samples drawn per pixel FROM THIS QUEUE: equals settings.max_samples
        # single-chip; under the sharded "sample" split each chip draws only
        # spp/n_dev of them, so live pixels span proportionally wider
        spp = local_spp or settings.max_samples
        w_win = ((settings.max_path_depth + 2) * lanes // spp + 2 + 127) // 128 * 128
        # factorize the window: rel = q*W2 + r, so the [L,W] one-hot matmul
        # (W~12k -> a multi-GB operand per step) becomes TWO small one-hots
        # [L,3*W1] x [L,W2] contracted over lanes -- ~30x less HBM traffic
        # for identical results (each (q,r) output cell sums exactly the
        # lanes whose rel decomposes to it).  W1 ~ sqrt(W/3) balances the two
        # one-hot operands' traffic (L*(3*W1 + W2)).
        w1 = 64
        while w1 * w1 * 3 < w_win and w1 < 512:
            w1 *= 2
        w2 = (w_win + w1 - 1) // w1
        w_pad = w1 * w2
        contrib = jnp.where(path_done[:, None], ps.result, 0.0)  # [L,3]
        use_window = w_pad <= min(65536, n_pix)
        if film_mode == "scatter":
            use_window = False
        elif film_mode == "window":
            use_window = True
        if use_window:
            base = jnp.min(jnp.where(path_done, st.pixel, jnp.int32(2**30)))
            base = jnp.clip(base, 0, n_pix - w_pad)
            rel = st.pixel - base
            q, r = rel // w2, rel % w2
            q_oh = jnp.where(
                q[:, None] == jnp.arange(w1, dtype=jnp.int32)[None, :], 1.0, 0.0
            )  # [L,W1]
            r_oh = jnp.where(
                (r[:, None] == jnp.arange(w2, dtype=jnp.int32)[None, :])
                & path_done[:, None],
                1.0,
                0.0,
            )  # [L,W2]
            a2 = (contrib[:, :, None] * q_oh[:, None, :]).reshape(
                lanes, 3 * w1
            )  # [L,3*W1]
            # HIGHEST: a default-precision f32 product may run in TF32 and
            # round every radiance contribution to 10 mantissa bits
            part = jax.lax.dot_general(
                a2, r_oh, (((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )  # [3*W1, W2]
            win = (
                part.reshape(3, w1, w2).transpose(1, 2, 0).reshape(w_pad, 3)
            )
            cur = jax.lax.dynamic_slice(st.acc, (base, jnp.int32(0)), (w_pad, 3))
            acc = jax.lax.dynamic_update_slice(st.acc, cur + win, (base, jnp.int32(0)))
            # NaN-retry lanes don't advance depth, so a pathological straggler
            # can outlive the (depth+2)*lanes id-span bound; spill any
            # out-of-window contribution through the exact scatter (the cond
            # branch is never taken in practice and costs nothing)
            unsafe = path_done & (rel >= w_pad)
            acc = jax.lax.cond(
                jnp.any(unsafe),
                lambda a: a.at[st.pixel].add(jnp.where(unsafe[:, None], contrib, 0.0)),
                lambda a: a,
                acc,
            )
        else:
            acc = st.acc.at[st.pixel].add(contrib)

        # --- regenerate finished lanes on fresh work items ---
        order = jnp.cumsum(idle.astype(jnp.int32)) - 1  # rank among idle lanes
        new_ids = st.work_counter + order
        can_spawn = idle & (new_ids < total_work)
        handed_out = jnp.minimum(jnp.sum(idle.astype(jnp.int32)),
                                 jnp.maximum(total_work - st.work_counter, 0))
        work_counter = st.work_counter + handed_out
        work_local = st.work_local

    # ``work_map`` translates LOCAL queue ids to GLOBAL (pixel, sample) work
    # ids -- identity single-chip; under the sharded renderer's "sample"
    # split it maps chip-local ids onto this chip's spp-slice of every pixel
    # (parallel/shard.py).  Mapping here (not at queue level) keeps the
    # window-film locality math in LOCAL id space, where ids stay contiguous.
    mapped_ids = jnp.maximum(new_ids, 0)
    if work_map is not None:
        mapped_ids = work_map(mapped_ids)
    pixel_s, o_s, d_s, rng_s = _spawn(
        scene, settings, mapped_ids, total_work, sample_base=sample_base
    )

    def sel(new, old):
        mask = can_spawn
        if new.ndim > 1:
            mask = mask[:, None]
        return jnp.where(mask, new, old)

    keep_alive = ps.alive & ~path_done
    return PoolState(
        pixel=sel(pixel_s, st.pixel),
        ray_o=sel(o_s, ps.ray_o),
        ray_d=sel(d_s, ps.ray_d),
        throughput=sel(jnp.ones_like(st.throughput), ps.throughput),
        result=sel(jnp.zeros_like(st.result), ps.result),
        rng=sel(rng_s, ps.rng),
        alive=jnp.where(can_spawn, True, keep_alive),
        prev_lobe=sel(jnp.full_like(st.prev_lobe, disney.LOBE_NONE), ps.prev_lobe),
        depth=sel(jnp.zeros_like(st.depth), ps.depth),
        prev_pdf=sel(jnp.zeros_like(st.prev_pdf), ps.prev_pdf),
        work_counter=work_counter,
        acc=acc,
        rays=rays,
        work_local=work_local,
    )


@partial(jax.jit, static_argnames=("settings", "enable_textures", "iters", "fused2_block", "film_mode", "fused2_sort"))
def _run_chunk(scene, settings, st, accel, enable_textures, work_hi, iters, lights, env_light, fused2_block=None, film_mode="auto", fused2_sort=False, sample_base=None):
    """``iters`` wavefront steps.  ``work_hi`` is traced (per-shard bound when
    the pool runs under shard_map); accel dispatch is by python type.
    ``sample_base`` is TRACED (a device scalar), so spp-segmented production
    renders reuse one compiled chunk across segments."""
    if sample_base is None:
        sample_base = jnp.uint32(0)
    intersect_fn, occlude_fn = integrator.make_intersectors(
        scene, accel, fused2_block=fused2_block, fused2_sort=fused2_sort,
    )

    def body(st, _):
        return wavefront_step(
            scene, settings, st, intersect_fn, enable_textures, work_hi,
            lights=lights, occlude_fn=occlude_fn, env_light=env_light,
            film_mode=film_mode, sample_base=sample_base,
        ), None

    st, _ = jax.lax.scan(body, st, None, length=iters)
    # one tiny i32 vector for the host loop-exit test
    if st.acc.ndim == 3:  # strided slices: every lane exhausted its slice
        slice_items = st.acc.shape[0] * settings.max_samples
        work_done = (jnp.min(st.work_local) >= slice_items).astype(jnp.int32)
    else:
        work_done = (st.work_counter >= work_hi).astype(jnp.int32)
    busy = jnp.any(st.alive).astype(jnp.int32)
    status = jnp.stack([work_done, busy])
    return st, status


def render_image_wavefront(
    scene: Scene,
    settings: RenderSettings,
    accel=None,
    lanes: int = 131072,
    iters_per_launch: int = 32,
    max_launches: int = 1000,
    strided: bool = False,
    fused2_block: int | None = None,
    film_mode: str = "auto",
    fused2_sort: bool = False,
    checkpoint_path: str | None = None,
    checkpoint_every_s: float = 600.0,
    progress: bool = False,
    sample_base: int = 0,
) -> tuple:
    """Full-frame render via the persistent pool.

    Returns (image f32 [H,W,3] top-row-first, rays_traced).

    ``iters_per_launch`` wavefront steps run per host launch; the drain
    granularity it adds is cheap because dead lanes park their rays outside
    the scene.

    ``checkpoint_path`` enables crash-safe production rendering (the
    reference's program has no analog -- its 12288-spp frame is
    all-or-nothing): every ``checkpoint_every_s`` seconds the pool is
    DRAINED (work handouts capped at the current queue position, launches
    continue until every in-flight path has banked -- at most ~depth+2
    steps) and (film, work_counter, rays) is written atomically.  A rerun
    with the same path resumes from the last checkpoint with a fresh pool;
    the estimator is unchanged because every (pixel, sample) work item's
    RNG stream is seeded by its id alone (_spawn), so finished items are in
    the film exactly once and pending items render identically after
    resume.  Queue-film mode only (the strided film partitions work
    statically).
    """
    from .film import scene_has_textures

    enable_textures = scene_has_textures(scene)
    assert settings.width * settings.height * settings.max_samples < 2**31, (
        "work-id space exceeds int32: render in spp segments with "
        "sample_base offsets (tools/render_production.py does this)"
    )
    if fused2_sort is True:
        # resolve the scene-adaptive sort mode OUTSIDE jit (needs concrete
        # camera/vertex arrays): interior scenes -> candidate-cluster key,
        # open scenes -> morton (ops/fused2.py auto_sort_mode)
        from ..ops.fused2 import auto_sort_mode

        fused2_sort = auto_sort_mode(scene)
    total_work = settings.width * settings.height * settings.max_samples

    lights = None
    env_light = None
    if settings.use_nee:
        from ..models.envlight import build_env_light
        from ..models.lights import build_light_table

        lights = build_light_table(scene)
        if settings.environment_use:
            env_light = build_env_light(
                np.asarray(scene.env_map), settings.environment_intensity
            )

    # NB: the scatter-free strided film (strided=True) is NOT the default:
    # per-lane pixel partitions put adjacent lanes P pixels apart, so a
    # traversal block spans a whole image row and its cluster union grows.
    # The global queue hands consecutive work ids to idle lanes, keeping
    # blocks ~2 pixels wide.
    spp = settings.max_samples
    strided_pixels = None
    if strided and total_work % lanes == 0 and (total_work // lanes) % spp == 0:
        strided_pixels = total_work // lanes // spp  # P pixels per lane
    st = new_pool(settings, lanes, strided_pixels=strided_pixels)

    # adaptive launch sizing: a SMALL frame must not pay full launch
    # granularity.  The expected completion step count is known up front
    # (work/lanes handouts + path depth + regen slack), so one launch size,
    # capped at iters_per_launch, covers it (scan length is static: one
    # size keeps one jitted graph per render config)
    est_steps = (total_work + lanes - 1) // lanes + settings.max_path_depth + 3
    next_iters = first_iters = max(2, min(iters_per_launch, est_steps))

    # --- checkpoint/resume (queue film only) ---
    import os
    import time as _time

    ck_guard = dict(
        width=settings.width, height=settings.height,
        spp=settings.max_samples, depth=settings.max_path_depth,
        lanes=lanes, nee=int(settings.use_nee), sample_base=sample_base,
    )
    if checkpoint_path is not None:
        assert st.acc.ndim == 2, "checkpointing requires the queue film"
        if os.path.exists(checkpoint_path):
            ck = np.load(checkpoint_path)
            mismatch = [
                kk for kk, vv in ck_guard.items() if int(ck[kk]) != int(vv)
            ]
            if mismatch:
                raise ValueError(
                    f"checkpoint {checkpoint_path} was written by a different "
                    f"config (mismatched: {mismatch}); refusing to resume"
                )
            st = st._replace(
                acc=jnp.asarray(ck["acc"]),
                work_counter=jnp.int32(int(ck["work_counter"])),
                rays=jnp.uint32(int(ck["rays"])),
            )
            if progress:
                print(
                    f"[wavefront] resumed at work item "
                    f"{int(ck['work_counter'])}/{total_work} "
                    f"({100.0 * int(ck['work_counter']) / total_work:.1f}%)",
                    flush=True,
                )

    def save_checkpoint(st):
        """Drain in-flight paths (no new handouts), then write atomically."""
        wc = jnp.int32(int(st.work_counter))  # forced readback = drain cap
        for _ in range(64):
            st, status = _run_chunk(
                scene, settings, st, accel, enable_textures, wc,
                next_iters, lights, env_light, fused2_block=fused2_block,
                film_mode=film_mode, fused2_sort=fused2_sort,
                sample_base=sample_base,
            )
            s = np.asarray(status)
            if not s[1]:  # nothing alive: film is consistent
                break
        tmp = checkpoint_path + ".tmp"
        with open(tmp, "wb") as f:  # file handle: savez won't append .npz
            np.savez(
                f, acc=np.asarray(st.acc),
                work_counter=int(st.work_counter), rays=int(st.rays),
                **ck_guard,
            )
        os.replace(tmp, checkpoint_path)
        if progress:
            done = int(st.work_counter)
            print(
                f"[wavefront] checkpoint @ {done}/{total_work} "
                f"({100.0 * done / total_work:.1f}%), "
                f"{int(st.rays) / 1e6:.0f}M rays", flush=True,
            )
        return st

    # pipelined host loop: dispatch launch i+1 BEFORE reading launch i's
    # status, so host dispatch overlaps device compute (JAX async dispatch;
    # the only forced sync is the one-launch-old status readback).  Costs at
    # most one extra launch of dead steps at the end.
    prev_status = None
    last_ck = _time.time()
    sample_base = jnp.uint32(sample_base)
    for i in range(max_launches):
        st, status = _run_chunk(
            scene, settings, st, accel, enable_textures, jnp.int32(total_work),
            first_iters if i == 0 else next_iters, lights, env_light,
            fused2_block=fused2_block,
            film_mode=film_mode, fused2_sort=fused2_sort,
            sample_base=sample_base,
        )
        if prev_status is not None:
            ps = np.asarray(prev_status)
            if ps[0] and not ps[1]:
                break
        prev_status = status
        if (
            checkpoint_path is not None
            and _time.time() - last_ck > checkpoint_every_s
        ):
            st = save_checkpoint(st)
            prev_status = None  # drained: stale pipeline status is invalid
            last_ck = _time.time()

    acc = np.asarray(st.acc)
    if acc.ndim == 3:  # [P,3,L] -> [L*P, 3] in pixel order
        acc = np.transpose(acc, (2, 0, 1)).reshape(-1, 3)
    img = acc.reshape(settings.height, settings.width, 3)
    img = img / settings.max_samples
    return img[::-1].copy(), int(st.rays)


def new_pool(
    settings: RenderSettings, lanes: int, work_lo=0,
    strided_pixels: int | None = None,
) -> PoolState:
    """Fresh all-idle pool; lanes spawn on the first step starting at
    work item ``work_lo`` (per-shard offset under shard_map).

    ``strided_pixels=P`` selects the scatter-free strided film: lane l owns
    P consecutive pixels x spp work items; acc is [lanes, P, 3]."""
    return PoolState(
        pixel=jnp.zeros((lanes,), jnp.int32),
        ray_o=jnp.zeros((lanes, 3), jnp.float32),
        ray_d=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (lanes, 3)),
        throughput=jnp.ones((lanes, 3), jnp.float32),
        result=jnp.zeros((lanes, 3), jnp.float32),
        rng=jnp.zeros((lanes,), jnp.uint32),
        alive=jnp.zeros((lanes,), bool),  # all lanes idle -> spawn on step 1
        prev_lobe=jnp.full((lanes,), disney.LOBE_NONE, jnp.int32),
        depth=jnp.zeros((lanes,), jnp.int32),
        prev_pdf=jnp.zeros((lanes,), jnp.float32),
        work_counter=jnp.asarray(work_lo, jnp.int32),
        acc=(
            jnp.zeros((strided_pixels, 3, lanes), jnp.float32)
            if strided_pixels
            else jnp.zeros((settings.width * settings.height, 3), jnp.float32)
        ),
        rays=jnp.uint32(0),
        work_local=jnp.zeros((lanes,), jnp.int32),
    )

"""Multi-chip rendering: pixel tiles sharded over a device mesh.

The reference is strictly single-GPU (``create_context(nullptr, 1)``,
application.cpp:62; OWL's multi-device capability unused -- SURVEY.md section
2 "Parallelism").  Here distribution is first-class:

* 1-D mesh over an ``"px"`` (pixels) axis: the scene SoA / BVH / material
  table are **replicated** on every chip, the pixel wavefront (rays, RNG
  streams, film accumulator) is **sharded** -- embarrassing parallelism, no
  per-bounce collectives, so the interconnect carries only the final
  gather;
* the renderer is ``shard_map``-wrapped ``integrator.sample_sum``: each chip
  runs the identical compiled program on its pixel shard;
* gradient rendering all-reduces material-parameter gradients with
  ``pmean`` -- see ``sharded_loss_and_grad``.

Works identically on the virtual CPU mesh used in tests
(``--xla_force_host_platform_device_count``) and on several GPUs of one
host (``python chip_smoke.py --multichip 4``).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.scene import RenderSettings, Scene
from ..ops import rng as rng_mod
from ..render import integrator
from ..render.film import _pixel_grid, scene_has_textures


def make_pixel_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices, axis name 'px'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), ("px",))


def _shard_spec(mesh: Mesh):
    return NamedSharding(mesh, P("px"))


def sharded_sample_sum(
    mesh: Mesh,
    scene: Scene,
    settings: RenderSettings,
    accel,
    lights,
    enable_textures: bool,
    num_samples: int,
    env_light=None,
):
    """Build the pjit'd per-shard sampler: (pixel_xy, rng) -> (sum, rng', rays).

    Scene/accel/lights are closed over (replicated by XLA); pixel arrays are
    sharded along 'px'.
    """
    def local_render(pixel_xy, rng_state):
        intersect_fn, occlude_fn = integrator.make_intersectors(scene, accel)
        return integrator.sample_sum(
            scene, settings, pixel_xy, rng_state, num_samples, intersect_fn,
            enable_textures, lights=lights, occlude_fn=occlude_fn,
            env_light=env_light,
        )

    fn = jax.shard_map(
        local_render,
        mesh=mesh,
        in_specs=(P("px"), P("px")),
        out_specs=(P("px"), P("px"), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def render_image_sharded(
    scene: Scene,
    settings: RenderSettings,
    mesh: Optional[Mesh] = None,
    spp: Optional[int] = None,
    accel=None,
) -> np.ndarray:
    """Full-frame render with pixels sharded across the mesh.

    Pixel count is padded to a multiple of the mesh size; output matches the
    single-chip renderer exactly (same per-pixel RNG streams).
    """
    if mesh is None:
        mesh = make_pixel_mesh()
    n_dev = mesh.devices.size
    spp = settings.max_samples if spp is None else spp

    lights = None
    env_light = None
    if settings.use_nee:
        from ..models.lights import build_light_table

        lights = build_light_table(scene)
        if settings.environment_use:
            # same env treatment as the single-chip film path (film.py); a
            # missing env_light here made env-NEE silently differ multi-chip
            from ..models.envlight import build_env_light

            env_light = build_env_light(
                np.asarray(scene.env_map), settings.environment_intensity
            )
    enable_textures = scene_has_textures(scene)

    px = _pixel_grid(settings.width, settings.height)
    total = px.shape[0]
    pad = (-total) % n_dev
    if pad:
        px = np.concatenate([px, np.tile(px[-1:], (pad, 1))])
    state = np.asarray(rng_mod.seed(jnp.asarray(px[:, 0]), jnp.asarray(px[:, 1])))

    fn = sharded_sample_sum(mesh, scene, settings, accel, lights, enable_textures, spp, env_light=env_light)
    sharding = _shard_spec(mesh)
    px_d = jax.device_put(jnp.asarray(px), sharding)
    st_d = jax.device_put(jnp.asarray(state), sharding)
    acc, _, _ = fn(px_d, st_d)
    acc = np.asarray(acc)[:total]
    img = acc.reshape(settings.height, settings.width, 3) / float(spp)
    return img[::-1].copy()


# ── distributed gradients (material recovery across chips) ─────────────────


def sharded_loss_and_grad(
    mesh: Mesh,
    scene: Scene,
    settings: RenderSettings,
    accel,
    num_samples: int,
):
    """Builds a pjit'd (materials, pixel_xy, rng, target) -> (loss, grads)
    where pixels/targets are sharded and the material gradient is psum'd over
    the mesh."""

    def local_loss(materials, pixel_xy, rng_state, target):
        s2 = scene._replace(materials=materials)
        intersect_fn, occlude_fn = integrator.make_intersectors(s2, accel)
        lights = None
        if settings.use_nee:
            from ..models.lights import build_light_table

            lights = build_light_table(s2)
        acc, _, _ = integrator.sample_sum(
            s2, settings, pixel_xy, rng_state, num_samples, intersect_fn,
            scene_has_textures(s2), lights=lights, occlude_fn=occlude_fn,
        )
        img = acc / float(num_samples)
        # local mean over this shard's pixels; global loss = mean of shard means
        return jnp.mean((img - target) ** 2)

    def shard_body(materials, pixel_xy, rng_state, target):
        loss, grads = jax.value_and_grad(local_loss)(materials, pixel_xy, rng_state, target)
        # all-reduce across devices
        loss = jax.lax.pmean(loss, "px")
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, "px"), grads)
        return loss, grads

    fn = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P("px"), P("px"), P("px")),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


# ── sharded PRODUCTION renderer: persistent wavefront pool per chip ─────────


def sharded_wavefront_chunk(
    mesh: Mesh,
    scene: Scene,
    settings: RenderSettings,
    accel,
    enable_textures: bool,
    iters: int,
    lights,
    env_light,
    work_split: str = "contiguous",
):
    """shard_map'd ``iters`` wavefront steps.  Every chip runs its own
    persistent lane pool over a disjoint slice of the (pixel, sample) work
    queue; the scene/accel (including the fused2 traversal kernel) are
    replicated.  Pool lane arrays are sharded on their leading axis; the
    per-chip film/work-counter/ray-counter carry an explicit [n_dev] leading
    axis.

    ``work_split="sample"``: chip k owns samples [k*spp/n, (k+1)*spp/n) of
    EVERY pixel (local queue ids mapped through ``work_map``); every chip
    then traces the same pixel distribution, so load balance is ~1 by
    construction regardless of where the scene concentrates its bounce work
    -- the rebalancing knob.  "contiguous" keeps per-chip pixel bands
    (disjoint film regions, no overlap in the final film sum)."""
    from ..render.wavefront import PoolState, wavefront_step

    n_dev = mesh.devices.size
    spp = settings.max_samples
    local_spp = None
    if work_split == "sample":
        assert spp % n_dev == 0, (spp, n_dev)
        local_spp = spp // n_dev

    def shard_body(st_g: PoolState, work_hi):
        st = st_g._replace(
            work_counter=st_g.work_counter[0],
            acc=st_g.acc[0],
            rays=st_g.rays[0],
        )
        hi = work_hi[0]

        work_map = None
        if work_split == "sample":
            k = jax.lax.axis_index("px")

            def work_map(l):  # local id -> global (pixel, sample) id
                return (l // local_spp) * spp + k * local_spp + (l % local_spp)

        def body(st, _):
            return wavefront_step(
                scene, settings, st, intersect_fn, enable_textures, hi,
                lights=lights, occlude_fn=occlude_fn, env_light=env_light,
                work_map=work_map, local_spp=local_spp,
            ), None

        intersect_fn, occlude_fn = integrator.make_intersectors(scene, accel)
        st, _ = jax.lax.scan(body, st, None, length=iters)
        status = jnp.stack(
            [(st.work_counter >= hi).astype(jnp.int32),
             jnp.any(st.alive).astype(jnp.int32)]
        )
        st_g = st._replace(
            work_counter=st.work_counter[None],
            acc=st.acc[None],
            rays=st.rays[None],
        )
        return st_g, status[None]

    pool_spec = PoolState(
        pixel=P("px"), ray_o=P("px"), ray_d=P("px"), throughput=P("px"),
        result=P("px"), rng=P("px"), alive=P("px"), prev_lobe=P("px"),
        depth=P("px"), prev_pdf=P("px"), work_counter=P("px"), acc=P("px"),
        rays=P("px"), work_local=P("px"),
    )
    fn = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(pool_spec, P("px")),
        out_specs=(pool_spec, P("px")),
        check_vma=False,
    )
    return jax.jit(fn)


def render_image_wavefront_sharded(
    scene: Scene,
    settings: RenderSettings,
    mesh: Optional[Mesh] = None,
    accel=None,
    lanes_per_chip: int = 131072,
    iters_per_launch: int = 16,
    max_launches: int = 1000,
    return_stats: bool = False,
    work_split: str = "auto",
):
    """Full-frame render: one persistent wavefront pool PER CHIP.

    The (pixel, sample) work queue is split into contiguous per-chip ranges;
    each work item's RNG stream depends only on its (pixel, sample) id
    (render/wavefront.py _spawn), so the sharded render equals the
    single-chip wavefront render up to f32 film-summation order.

    Returns (image f32 [H,W,3] top-row-first, rays_traced).
    """
    from ..render.wavefront import new_pool

    if mesh is None:
        mesh = make_pixel_mesh()
    n_dev = mesh.devices.size
    total_work = settings.width * settings.height * settings.max_samples
    if work_split == "auto":
        work_split = (
            "sample" if settings.max_samples % n_dev == 0 else "contiguous"
        )

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
    enable_textures = scene_has_textures(scene)

    if work_split == "sample":
        # every chip walks a LOCAL queue of total_work/n_dev ids, mapped to
        # its spp-slice of all pixels inside the shard body
        work_lo = np.zeros(n_dev, np.int32)
        work_hi = np.full(n_dev, total_work // n_dev, np.int32)
    else:
        # contiguous per-chip work ranges
        edges = np.linspace(0, total_work, n_dev + 1).round().astype(np.int32)
        work_lo, work_hi = edges[:-1], edges[1:]

    # stack per-chip pools along the sharded leading axis
    pools = [new_pool(settings, lanes_per_chip, work_lo=int(lo)) for lo in work_lo]
    st = jax.tree.map(lambda *xs: jnp.concatenate([x[None] for x in xs]), *pools)
    # lane arrays shard by flattening [n_dev, lanes] -> [n_dev*lanes]
    from ..render.wavefront import PoolState

    st = PoolState(
        *[
            (x.reshape((-1,) + x.shape[2:]) if name not in ("work_counter", "acc", "rays") else x)
            for name, x in zip(PoolState._fields, st)
        ]
    )

    sharding = _shard_spec(mesh)
    st = jax.tree.map(lambda x: jax.device_put(x, sharding), st)
    hi_d = jax.device_put(jnp.asarray(work_hi), sharding)

    fn = sharded_wavefront_chunk(
        mesh, scene, settings, accel, enable_textures, iters_per_launch,
        lights, env_light, work_split=work_split,
    )
    for _ in range(max_launches):
        st, status = fn(st, hi_d)
        status = np.asarray(status)
        if status[:, 0].all() and not status[:, 1].any():
            break

    # contiguous: per-chip pixel sets are disjoint; sample split: every chip
    # holds its spp-slice of every pixel -- either way the film SUM is the
    # full spp accumulation
    acc = np.asarray(st.acc).sum(axis=0)
    img = acc.reshape(settings.height, settings.width, 3) / settings.max_samples
    per_chip = np.asarray(st.rays, np.int64)
    if return_stats:
        stats = {
            "per_chip_rays": per_chip.tolist(),
            # load balance = mean/max: the scaling efficiency bound from work
            # imbalance alone (comm here is one film reduction at the end)
            "load_balance": float(per_chip.mean() / max(per_chip.max(), 1)),
        }
        return img[::-1].copy(), int(per_chip.sum()), stats
    return img[::-1].copy(), int(per_chip.sum())

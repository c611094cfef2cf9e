"""Film: full-frame rendering, progressive accumulation, checkpoint/resume.

The reference computes all spp in one launch and persists nothing but the
final PNG (device.cu:229, SURVEY.md section 5 "checkpoint/resume: none").
Here the film is explicit state -- (sample sum, per-pixel RNG state, spp done)
-- so renders are progressive, resumable from an ``.npz`` checkpoint, and
chunkable over both pixels and spp.  Because the per-pixel LCG stream is
carried in the film, a resumed render draws the exact same sample sequence as
an uninterrupted one (results match up to f32 summation order).

Framebuffer conventions (parity): pixel (x, y=0) is the *bottom* image row;
``finalize`` applies the reference's store-time flip (device.cu:251) so PNG
row 0 is the top; quantization is owl's make_rgba (utils/image.py).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.scene import RenderSettings, Scene
from ..ops import rng as rng_mod
from . import integrator


@dataclasses.dataclass
class Film:
    acc: np.ndarray  # [H*W, 3] f32 radiance sum
    rng: np.ndarray  # [H*W] uint32 per-pixel LCG state
    spp_done: int
    width: int
    height: int
    rays_traced: int = 0  # live rays through the intersector (perf metric)


def _pixel_grid(width: int, height: int) -> np.ndarray:
    """All pixel coords [H*W, 2] in reference launch order (x fastest)."""
    x, y = np.meshgrid(np.arange(width, dtype=np.int32), np.arange(height, dtype=np.int32))
    return np.stack([x.ravel(), y.ravel()], axis=-1)


def new_film(settings: RenderSettings) -> Film:
    px = _pixel_grid(settings.width, settings.height)
    state = np.asarray(rng_mod.seed(jnp.asarray(px[:, 0]), jnp.asarray(px[:, 1])))
    return Film(
        acc=np.zeros((settings.width * settings.height, 3), np.float32),
        rng=state,
        spp_done=0,
        width=settings.width,
        height=settings.height,
    )


@partial(jax.jit, static_argnames=("settings", "num_samples", "enable_textures", "tri_chunk", "fused2_block"))
def _sample_sum_jit(scene, settings, pixel_xy, rng_state, num_samples, enable_textures, tri_chunk, accel, lights, env_light, fused2_block=None):
    # single source of truth for accel -> (intersect, occlude) dispatch
    # (a second hand-maintained copy here had already drifted; VERDICT r2 #3)
    intersect_fn, occlude_fn = integrator.make_intersectors(
        scene, accel, tri_chunk=tri_chunk, fused2_block=fused2_block
    )
    return integrator.sample_sum(
        scene, settings, pixel_xy, rng_state, num_samples, intersect_fn, enable_textures,
        lights=lights, occlude_fn=occlude_fn, env_light=env_light,
    )


def build_scene_bvh(scene: Scene):
    """Build (cached) + upload the per-ray-stack BVH (ops/traverse.py)."""
    from ..ops.bvh import build_bvh_cached
    from ..ops.traverse import device_bvh

    verts = np.asarray(scene.vertices)
    tris = np.asarray(scene.tri_idx)
    return device_bvh(build_bvh_cached(verts, tris), verts, tris)


def make_accel(scene: Scene, kind: str = "cluster", cluster_size: int | None = None):
    """Build the acceleration structure for rendering.

    ``fused2`` is the single-kernel Pallas-Triton traversal (ops/fused2.py);
    ``cluster`` the XLA ray-stream intersector (ops/cluster.py, default
    C=128); ``bvh`` the per-ray-stack traversal; ``brute`` returns None
    (dense sweep, exact reference for tests)."""
    if kind == "fused2":
        from ..ops.fused2 import CLUSTER_SIZE, build_fused2_scene

        if cluster_size is None:
            # small scenes keep at least 64 clusters, so the block frontier
            # still has pruning granularity
            cluster_size = CLUSTER_SIZE
            n_tris = int(scene.tri_idx.shape[0])
            while cluster_size > 32 and n_tris // cluster_size < 64:
                cluster_size //= 2
        return build_fused2_scene(scene, cluster_size=cluster_size)
    if kind == "cluster":
        from ..ops.cluster import build_clusters

        return build_clusters(
            np.asarray(scene.vertices), np.asarray(scene.tri_idx),
            cluster_size=cluster_size or 128,
        )
    if kind == "bvh":
        return build_scene_bvh(scene)
    if kind == "brute":
        return None
    raise ValueError(f"unknown intersector kind {kind!r}")


def scene_has_textures(scene: Scene) -> bool:
    return bool(np.any(np.asarray(scene.mat_tex) >= 0))


def add_samples(
    scene: Scene,
    settings: RenderSettings,
    film: Film,
    num_samples: int,
    pixel_chunk: int = 65536,
    tri_chunk: int = 512,
    accel=None,
    fused2_block: int | None = None,
) -> Film:
    """Accumulate ``num_samples`` more spp into the film (pixel-chunked)."""
    enable_textures = scene_has_textures(scene)
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
    px = _pixel_grid(film.width, film.height)
    total = px.shape[0]
    acc = film.acc.copy()
    state = film.rng.copy()
    # pad to a whole number of chunks so one compiled program serves all chunks
    n_chunks = -(-total // pixel_chunk)
    rays_traced = film.rays_traced
    for c in range(n_chunks):
        lo = c * pixel_chunk
        hi = min(lo + pixel_chunk, total)
        idx = np.arange(lo, hi)
        if hi - lo < pixel_chunk:  # pad final chunk
            idx = np.concatenate([idx, np.full(pixel_chunk - (hi - lo), total - 1)])
        s, r, rays = _sample_sum_jit(
            scene,
            settings,
            jnp.asarray(px[idx]),
            jnp.asarray(state[idx]),
            num_samples,
            enable_textures,
            tri_chunk,
            accel,
            lights,
            env_light,
            fused2_block=fused2_block,
        )
        s = np.asarray(s)[: hi - lo]
        r = np.asarray(r)[: hi - lo]
        acc[lo:hi] += s
        state[lo:hi] = r
        rays_traced += int(np.asarray(rays, np.int64).sum())
    return Film(
        acc=acc, rng=state, spp_done=film.spp_done + num_samples,
        width=film.width, height=film.height, rays_traced=rays_traced,
    )


def finalize(film: Film) -> np.ndarray:
    """Average + store-time vertical flip -> f32 [H,W,3], row 0 = image top."""
    img = film.acc.reshape(film.height, film.width, 3) / max(film.spp_done, 1)
    return img[::-1].copy()


def render_image(
    scene: Scene,
    settings: RenderSettings,
    spp: Optional[int] = None,
    pixel_chunk: int = 65536,
    tri_chunk: int = 512,
    accel=None,
    intersector: Optional[str] = None,
    bvh=None,  # back-compat alias for accel
) -> np.ndarray:
    """One-shot full-frame render -> linear f32 [H,W,3] (top row first)."""
    if accel is None and bvh is not None:
        accel = bvh
    if accel is None and intersector is not None:
        accel = make_accel(scene, intersector)
    film = new_film(settings)
    film = add_samples(
        scene,
        settings,
        film,
        settings.max_samples if spp is None else spp,
        pixel_chunk=pixel_chunk,
        tri_chunk=tri_chunk,
        accel=accel,
    )
    return finalize(film)


def save_checkpoint(path, film: Film):
    np.savez_compressed(
        path, acc=film.acc, rng=film.rng, spp_done=film.spp_done, width=film.width, height=film.height
    )


def load_checkpoint(path) -> Film:
    z = np.load(path)
    return Film(
        acc=z["acc"],
        rng=z["rng"],
        spp_done=int(z["spp_done"]),
        width=int(z["width"]),
        height=int(z["height"]),
    )

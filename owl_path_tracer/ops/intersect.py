"""Ray-triangle intersection: batched Möller-Trumbore over triangle chunks.

Plain-JAX replacement for the hardware BVH traversal the reference gets for
free from OptiX (``owl::traceRay``, device.cu:133; AS build
application.cpp:131-140).  This module is the *reference* intersector: a dense
ray x triangle sweep expressed as a ``lax.scan`` over triangle chunks so the
working set stays bounded while XLA vectorizes each chunk.
Exact for any scene; O(N*T).  The production path for large scenes is the BVH
builder + traversal in ``ops/bvh.py`` / ``ops/traverse.py``, validated against
this one.

Closest-hit semantics match OptiX: smallest t in (t_min, t_max), barycentrics
(u, v) with P = (1-u-v) p0 + u p1 + v p2 (device.cu:260,265), no backface
culling.  The any-hit variant mirrors the shadow-ray flags
OPTIX_RAY_FLAG_TERMINATE_ON_FIRST_HIT (device.cu:97-110).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import math as m

_EPS_DET = 1e-12


class HitRecord(NamedTuple):
    """SoA hit record -- the wavefront analog of hit_data (device.hpp:14-25)."""

    t: jnp.ndarray  # [N] f32, t_max if miss
    tri: jnp.ndarray  # [N] i32, -1 if miss
    uv: jnp.ndarray  # [N,2] barycentrics

    @property
    def hit(self) -> jnp.ndarray:
        return self.tri >= 0


def mt_components(o_c, d_c, p0_c, e1_c, e2_c, t_min, t_max):
    """Möller-Trumbore in component form -- THE canonical op ordering.

    Every intersector (brute, BVH traversal, cluster, Pallas) calls this with
    already-broadcastable per-component operands so (a) no [..,3]-minor-axis
    intermediates exist anywhere on the hot path,
    and (b) float op order is identical across intersectors, keeping renders
    bitwise-equal between them (tests/test_golden.py).

    o_c/d_c/p0_c/e1_c/e2_c: 3-tuples of broadcastable component arrays.
    Returns (t, u, v, valid) in the broadcast shape.
    """
    ox, oy, oz = o_c
    dx, dy, dz = d_c
    p0x, p0y, p0z = p0_c
    e1x, e1y, e1z = e1_c
    e2x, e2y, e2z = e2_c
    # h = d x e2
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    inv = 1.0 / jnp.where(jnp.abs(det) < _EPS_DET, 1.0, det)
    sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
    u = inv * (sx * hx + sy * hy + sz * hz)
    # q = s x e1
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    valid = (
        (jnp.abs(det) >= _EPS_DET)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return t, u, v, valid


def _tri_chunk_hits(ray_o, ray_d, p0, p1, p2, t_min, t_max):
    """All-pairs MT test: rays [N,3] x chunk [C,3] -> t [N,C], u, v, valid."""
    e1 = p1 - p0  # [C,3]
    e2 = p2 - p0
    comp = lambda a, ax: a[None, :, ax]  # [1,C]
    rcomp = lambda a, ax: a[:, ax, None]  # [N,1]
    return mt_components(
        (rcomp(ray_o, 0), rcomp(ray_o, 1), rcomp(ray_o, 2)),
        (rcomp(ray_d, 0), rcomp(ray_d, 1), rcomp(ray_d, 2)),
        (comp(p0, 0), comp(p0, 1), comp(p0, 2)),
        (comp(e1, 0), comp(e1, 1), comp(e1, 2)),
        (comp(e2, 0), comp(e2, 1), comp(e2, 2)),
        t_min,
        t_max,
    )


@partial(jax.jit, static_argnames=("tri_chunk",))
def closest_hit_brute(
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    vertices: jnp.ndarray,
    tri_idx: jnp.ndarray,
    t_min: float = m.T_MIN,
    t_max: float = m.T_MAX,
    tri_chunk: int = 512,
) -> HitRecord:
    """Closest hit of each ray against every triangle.

    rays [N,3]x2; vertices [V,3]; tri_idx [T,3].  Scans over ceil(T/chunk)
    chunks carrying the running best (t, tri, uv).
    """
    n = ray_o.shape[0]
    t_count = tri_idx.shape[0]
    pad = (-t_count) % tri_chunk
    idx_p = jnp.pad(tri_idx, ((0, pad), (0, 0)))  # padded tris are degenerate dup of tri 0
    # mark padded entries invalid via an id array
    ids = jnp.arange(t_count + pad, dtype=jnp.int32)
    idx_chunks = idx_p.reshape(-1, tri_chunk, 3)
    id_chunks = ids.reshape(-1, tri_chunk)

    init = (
        jnp.full((n,), t_max, jnp.float32),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n, 2), jnp.float32),
    )

    def body(carry, chunk):
        best_t, best_tri, best_uv = carry
        cidx, cid = chunk
        p0 = vertices[cidx[:, 0]]
        p1 = vertices[cidx[:, 1]]
        p2 = vertices[cidx[:, 2]]
        t, u, v, valid = _tri_chunk_hits(ray_o, ray_d, p0, p1, p2, t_min, t_max)
        valid &= (cid < t_count)[None, :]
        t = jnp.where(valid, t, jnp.inf)
        # gather-free winner selection (see ops/cluster.py)
        j = jnp.argmin(t, axis=-1)  # [N]
        onehot = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1) == j[:, None]
        tj = jnp.min(t, axis=-1)
        pick = lambda x: jnp.sum(jnp.where(onehot, x, 0.0), axis=-1)
        better = tj < best_t
        best_tri = jnp.where(
            better, jnp.max(jnp.where(onehot, cid[None, :], -1), axis=-1), best_tri
        )
        best_uv = jnp.where(
            better[:, None], jnp.stack([pick(u), pick(v)], axis=-1), best_uv
        )
        best_t = jnp.where(better, tj, best_t)
        return (best_t, best_tri, best_uv), None

    (bt, btri, buv), _ = jax.lax.scan(body, init, (idx_chunks, id_chunks))
    return HitRecord(t=bt, tri=btri, uv=buv)


@partial(jax.jit, static_argnames=("tri_chunk",))
def any_hit_brute(
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    vertices: jnp.ndarray,
    tri_idx: jnp.ndarray,
    t_min: float = m.T_MIN,
    t_max: float = m.T_MAX,
    tri_chunk: int = 512,
) -> jnp.ndarray:
    """Occlusion test (shadow rays): True where *any* hit in (t_min, t_max).

    Mirrors visibiliy_test's flags (device.cu:97-110); note the reference
    passes max_distance - t_min as t_max (device.cu:102).
    """
    n = ray_o.shape[0]
    t_count = tri_idx.shape[0]
    pad = (-t_count) % tri_chunk
    idx_p = jnp.pad(tri_idx, ((0, pad), (0, 0)))
    ids = jnp.arange(t_count + pad, dtype=jnp.int32)
    idx_chunks = idx_p.reshape(-1, tri_chunk, 3)
    id_chunks = ids.reshape(-1, tri_chunk)

    def body(occluded, chunk):
        cidx, cid = chunk
        p0 = vertices[cidx[:, 0]]
        p1 = vertices[cidx[:, 1]]
        p2 = vertices[cidx[:, 2]]
        tm = t_max if jnp.ndim(t_max) == 0 else t_max
        t, _, _, valid = _tri_chunk_hits(ray_o, ray_d, p0, p1, p2, t_min, tm)
        valid &= (cid < t_count)[None, :]
        return occluded | valid.any(axis=-1), None

    if jnp.ndim(t_max) > 0:
        # per-ray max distance: inline without scan-over-chunk t_max capture
        def body2(occluded, chunk):
            cidx, cid = chunk
            p0 = vertices[cidx[:, 0]]
            p1 = vertices[cidx[:, 1]]
            p2 = vertices[cidx[:, 2]]
            t, _, _, valid = _tri_chunk_hits(ray_o, ray_d, p0, p1, p2, t_min, jnp.inf)
            valid &= (cid < t_count)[None, :]
            valid &= t < t_max[:, None]
            return occluded | valid.any(axis=-1), None

        occ, _ = jax.lax.scan(body2, jnp.zeros((n,), bool), (idx_chunks, id_chunks))
        return occ

    occ, _ = jax.lax.scan(body, jnp.zeros((n,), bool), (idx_chunks, id_chunks))
    return occ

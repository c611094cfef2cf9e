"""Wavefront BVH traversal in pure JAX (lax.while_loop, per-ray short stack).

Not on the default path: the default traversal is ops/fused2.py.  This
module is the exact reference that faster intersectors are validated
against (tests/test_bvh, test_scenes_all), and one of the plain-XLA
traversals the fused2 kernel is measured against (PERF.md).

Replaces the hardware traversal the reference gets from OptiX
(``owl::traceRay``, device.cu:105,133).  The whole wavefront steps in
lockstep: one ``lax.while_loop`` whose body pops one node per ray, tests both
child AABBs (ordered near-first with t-culling), or intersects the <=max_leaf
triangles of a leaf -- all as masked [N]-shaped tensor ops.  The
loop runs until every ray's stack is empty; divergence costs idle lanes.

Correctness contract is identical to ops/intersect.py (closest hit in
(t_min, t_max), MT barycentrics, no culling) and is tested against it on
every scene.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import math as m
from .intersect import HitRecord

STACK_DEPTH = 64
_EPS_DET = 1e-12


class DeviceBVH(NamedTuple):
    """FlatBVH moved to device (jnp arrays) + triangle soup in leaf order."""

    node_min: jnp.ndarray  # [NN,3]
    node_max: jnp.ndarray  # [NN,3]
    node_a: jnp.ndarray  # [NN]
    node_b: jnp.ndarray  # [NN]
    tri_p0: jnp.ndarray  # [T,3] pre-gathered, in tri_order layout
    tri_e1: jnp.ndarray  # [T,3] p1-p0
    tri_e2: jnp.ndarray  # [T,3] p2-p0
    tri_id: jnp.ndarray  # [T] original triangle id per leaf-order slot


def device_bvh(bvh, vertices, tri_idx) -> DeviceBVH:
    """Reorder triangles into leaf-contiguous layout and pre-compute edges --
    one gather at build time instead of three per traversal step."""
    import numpy as np

    order = np.asarray(bvh.tri_order)
    t = np.asarray(tri_idx)[order]
    v = np.asarray(vertices)
    p0 = v[t[:, 0]]
    p1 = v[t[:, 1]]
    p2 = v[t[:, 2]]
    return DeviceBVH(
        node_min=jnp.asarray(bvh.node_min),
        node_max=jnp.asarray(bvh.node_max),
        node_a=jnp.asarray(bvh.node_a),
        node_b=jnp.asarray(bvh.node_b),
        tri_p0=jnp.asarray(p0),
        tri_e1=jnp.asarray(p1 - p0),
        tri_e2=jnp.asarray(p2 - p0),
        tri_id=jnp.asarray(order.astype(np.int32)),
    )


def _slab_test(o, inv_d, bmin, bmax, t_min, t_far):
    """Ray-AABB: returns (hit, t_enter). Shapes broadcast over leading dims."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    t_enter = jnp.maximum(jnp.max(tn, axis=-1), t_min)
    t_exit = jnp.minimum(jnp.min(tf, axis=-1), t_far)
    return t_enter <= t_exit, t_enter


def _leaf_hits(ray_o, ray_d, bvh: DeviceBVH, start, count, t_min, best_t, max_leaf):
    """Intersect the (padded) triangles of each ray's leaf; returns best-of-leaf."""
    n = ray_o.shape[0]
    offs = jnp.arange(max_leaf, dtype=jnp.int32)  # [L]
    slot = start[:, None] + offs[None, :]  # [N,L]
    in_leaf = offs[None, :] < count[:, None]
    slot = jnp.clip(slot, 0, bvh.tri_p0.shape[0] - 1)

    p0 = bvh.tri_p0[slot]  # [N,L,3]
    e1 = bvh.tri_e1[slot]
    e2 = bvh.tri_e2[slot]
    tid = bvh.tri_id[slot]  # [N,L]

    from .intersect import mt_components

    rc = lambda a, ax: a[:, ax, None]  # [N,1]
    cc = lambda a, ax: a[..., ax]  # [N,L]
    t, u, v, ok = mt_components(
        (rc(ray_o, 0), rc(ray_o, 1), rc(ray_o, 2)),
        (rc(ray_d, 0), rc(ray_d, 1), rc(ray_d, 2)),
        (cc(p0, 0), cc(p0, 1), cc(p0, 2)),
        (cc(e1, 0), cc(e1, 1), cc(e1, 2)),
        (cc(e2, 0), cc(e2, 1), cc(e2, 2)),
        t_min,
        best_t[:, None],
    )
    ok &= in_leaf
    t = jnp.where(ok, t, jnp.inf)
    # gather-free winner selection (same as ops/cluster.py)
    j = jnp.argmin(t, axis=-1)
    onehot = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1) == j[:, None]
    tj = jnp.min(t, axis=-1)
    hit = jnp.isfinite(tj)
    pick = lambda x: jnp.sum(jnp.where(onehot, x, 0.0), axis=-1)
    tri = jnp.max(jnp.where(onehot, tid, -1), axis=-1)
    tri = jnp.where(hit, tri, -1)
    uv = jnp.stack([pick(u), pick(v)], axis=-1)
    return tj, tri, uv, hit


@partial(jax.jit, static_argnames=("max_leaf", "any_hit"))
def bvh_closest_hit(
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    bvh: DeviceBVH,
    t_min: float = m.T_MIN,
    t_max: float = m.T_MAX,
    max_leaf: int = 4,
    any_hit: bool = False,
) -> HitRecord:
    """Closest-hit traversal; with ``any_hit`` terminates rays on first hit
    (the shadow-ray TERMINATE_ON_FIRST_HIT semantics, device.cu:106-107)."""
    n = ray_o.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(ray_d) < 1e-12, jnp.where(ray_d < 0, -1e-12, 1e-12), ray_d)

    stack = jnp.zeros((n, STACK_DEPTH), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)  # root (node 0) pre-pushed

    if jnp.ndim(t_max) == 0:
        best_t0 = jnp.full((n,), t_max, jnp.float32)
    else:
        best_t0 = jnp.asarray(t_max, jnp.float32)
    state = (
        stack,
        sp,
        best_t0,
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n, 2), jnp.float32),
    )

    col = jnp.arange(STACK_DEPTH, dtype=jnp.int32)[None, :]
    rows = jnp.arange(n)

    def cond(state):
        _, sp, _, _, _ = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, best_t, best_tri, best_uv = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = stack[rows, top]
        node = jnp.where(active, node, 0)
        sp = jnp.where(active, sp - 1, sp)

        a = bvh.node_a[node]
        b = bvh.node_b[node]
        is_leaf = b < 0

        # ── internal: test both children, push far then near ──
        # (leaf nodes carry tri offsets in a/b -- mask them to node 0 so the
        # gathers stay in range; results are discarded via `internal`)
        ca = jnp.where(is_leaf, 0, a)
        cb = jnp.where(is_leaf, 0, b)
        hit_a, ta = _slab_test(ray_o, inv_d, bvh.node_min[ca], bvh.node_max[ca], t_min, best_t)
        hit_b, tb = _slab_test(ray_o, inv_d, bvh.node_min[cb], bvh.node_max[cb], t_min, best_t)
        internal = active & ~is_leaf
        hit_a &= internal
        hit_b &= internal
        a_near = ta <= tb
        near = jnp.where(a_near, ca, cb)
        far = jnp.where(a_near, cb, ca)
        near_ok = jnp.where(a_near, hit_a, hit_b)
        far_ok = jnp.where(a_near, hit_b, hit_a)

        # push far (guard against overflow; STACK_DEPTH=64 covers any sane tree)
        push1 = far_ok & (sp < STACK_DEPTH)
        stack = jnp.where((col == sp[:, None]) & push1[:, None], far[:, None], stack)
        sp = sp + push1.astype(jnp.int32)
        # push near (popped next -> near-first order)
        push2 = near_ok & (sp < STACK_DEPTH)
        stack = jnp.where((col == sp[:, None]) & push2[:, None], near[:, None], stack)
        sp = sp + push2.astype(jnp.int32)

        # ── leaf: intersect triangles ──
        at_leaf = active & is_leaf
        start = jnp.where(at_leaf, a, 0)
        count = jnp.where(at_leaf, -b, 0)
        lt, ltri, luv, lhit = _leaf_hits(
            ray_o, ray_d, bvh, start, count, t_min, best_t, max_leaf
        )
        better = at_leaf & lhit & (lt < best_t)
        best_t = jnp.where(better, lt, best_t)
        best_tri = jnp.where(better, ltri, best_tri)
        best_uv = jnp.where(better[:, None], luv, best_uv)

        if any_hit:
            sp = jnp.where(best_tri >= 0, 0, sp)  # first hit ends the ray

        return (stack, sp, best_t, best_tri, best_uv)

    _, _, bt, btri, buv = jax.lax.while_loop(cond, body, state)
    return HitRecord(t=bt, tri=btri, uv=buv)


def make_bvh_intersector(bvh: DeviceBVH, max_leaf: int = 4):
    def intersect(ray_o, ray_d):
        return bvh_closest_hit(ray_o, ray_d, bvh, max_leaf=max_leaf)

    return intersect


def bvh_occluded(ray_o, ray_d, bvh: DeviceBVH, t_min=m.T_MIN, t_max=m.T_MAX, max_leaf: int = 4):
    """Shadow-ray occlusion: any hit in (t_min, t_max) -- device.cu:97-110."""
    rec = bvh_closest_hit(ray_o, ray_d, bvh, t_min=t_min, t_max=t_max, max_leaf=max_leaf, any_hit=True)
    return rec.tri >= 0

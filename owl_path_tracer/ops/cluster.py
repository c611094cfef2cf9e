"""Cluster (ray-stream) intersector -- traversal as dense, batched XLA ops.

Per-ray stack traversal (ops/traverse.py) expressed as whole-batch XLA ops
degenerates into pointer-chasing gathers and [N,stack] masked writes.  This
module restructures intersection into dense, regular, batched work:

  * the SAH BVH's leaves (ops/bvh.py, built with max_leaf=C) become fixed-size
    **triangle clusters**: [K, C] pre-gathered, padded SoA in HBM;
  * **phase A** tests every ray against every cluster AABB -- one dense
    [N, K] slab test, pure elementwise work, no control flow;
  * **phase B** repeatedly takes each ray's nearest untested cluster
    (masked argmin over [N, K]) and intersects its C triangles densely --
    a [N, C] Moller-Trumbore batch per step, with exact closest-hit early
    exit (a ray stops once its best t is closer than its next cluster entry).

Everything is fixed-shape tensor math: phase A is one dense pass + ``top_k``,
phase B a fixed-trip ``fori_loop`` over each ray's sorted candidate list with
full masking, plus an exact argmin fallback for the rare ray whose candidate
list overflows.  Semantics are identical to
ops/intersect.py and are tested against it.  This is the same capability as
the reference's OptiX hardware traversal (owl::traceRay, device.cu:133),
re-derived as batched tensor math.  It is the plain-XLA reference for the
fused2 kernel (ops/fused2.py), which shares its clusters.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import math as m
from .bvh import build_bvh
from .intersect import HitRecord

_EPS_DET = 1e-12


class ClusterBVH(NamedTuple):
    cmin: jnp.ndarray  # [K,3] cluster AABB min (K padded to 128; pads empty)
    cmax: jnp.ndarray  # [K,3]
    tri_planes: jnp.ndarray  # [K,9,C] component planes p0x,p0y,p0z,e1x..e2z
    tri_id: jnp.ndarray  # [K,C] original tri ids, -1 = padding

    @property
    def num_clusters(self) -> int:
        return self.cmin.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.tri_planes.shape[2]


def build_clusters(vertices: np.ndarray, tri_idx: np.ndarray, cluster_size: int = 128) -> ClusterBVH:
    """SAH-build with max_leaf=cluster_size; each leaf becomes one cluster.

    Uses the native C++ builder + extractor (native/bvh.cpp, ~200x faster)
    when its shared library builds; falls back to the numpy reference path.
    """
    vertices = np.asarray(vertices, np.float32)
    tri_idx = np.asarray(tri_idx, np.int32)
    c = cluster_size
    # build with FINER leaves than the cluster capacity, then pack (below):
    # SAH stops splitting at ~60% of max_leaf on average, so building at
    # max_leaf=c directly strands ~40% of every [*,C] lane downstream
    leaf = max(c // 8, 8)
    try:
        from ..native import native_build_bvh, native_extract_clusters

        bvh = native_build_bvh(vertices, tri_idx, max_leaf=leaf)
        cmin, cmax, blob, tid = native_extract_clusters(vertices, tri_idx, bvh, c)
        k = len(cmin)
    except Exception:
        bvh = build_bvh(vertices, tri_idx, max_leaf=leaf)
        leaves = np.nonzero(bvh.node_b < 0)[0]
        k = len(leaves)
        cmin = bvh.node_min[leaves]
        cmax = bvh.node_max[leaves]
        blob = np.zeros((k, c * 9), np.float32)
        tid = np.full((k, c), -1, np.int32)
        v = vertices
        for j, n in enumerate(leaves):
            start, cnt = bvh.node_a[n], -bvh.node_b[n]
            ids = bvh.tri_order[start : start + cnt]
            t = tri_idx[ids]
            a = v[t[:, 0]]
            rows = blob[j].reshape(c, 9)
            rows[:cnt, 0:3] = a
            rows[:cnt, 3:6] = v[t[:, 1]] - a
            rows[:cnt, 6:9] = v[t[:, 2]] - a
            tid[j, :cnt] = ids

    # ── leaf packing: greedily merge consecutive (DFS-ordered, spatially
    # coherent) SAH leaves up to the cluster capacity.  SAH leaves average
    # ~60% of max_leaf, so without packing every downstream [*,C] MT sweep
    # wastes ~40% of its lanes on padding AND phase A tests ~1.6x more
    # cluster boxes than needed.  Merged boxes are unions of neighbors in
    # tree order, so the per-block cluster-union blowup is small. ──
    counts = (tid >= 0).sum(1)
    if k > 1:
        groups, cur, cur_n = [], [], 0
        for j in range(k):
            cj = int(counts[j])
            if cur and cur_n + cj > c:
                groups.append(cur)
                cur, cur_n = [], 0
            cur.append(j)
            cur_n += cj
        groups.append(cur)
        if len(groups) < k:
            k2 = len(groups)
            cmin2 = np.empty((k2, 3), np.float32)
            cmax2 = np.empty((k2, 3), np.float32)
            blob2 = np.zeros((k2, c * 9), np.float32)
            tid2 = np.full((k2, c), -1, np.int32)
            for g, mem in enumerate(groups):
                cmin2[g] = cmin[mem].min(0)
                cmax2[g] = cmax[mem].max(0)
                rows = blob2[g].reshape(c, 9)
                pos = 0
                for j in mem:
                    cj = int(counts[j])
                    rows[pos : pos + cj] = blob[j].reshape(c, 9)[:cj]
                    tid2[g, pos : pos + cj] = tid[j, :cj]
                    pos += cj
            cmin, cmax, blob, tid, k = cmin2, cmax2, blob2, tid2, k2

    # pad K to a multiple of 128 with never-hit boxes.
    # NB: pads must be DEGENERATE POINTS AT INFINITY (bmin == bmax == +big),
    # not inverted boxes (bmin=+big, bmax=-big): the slab test's per-axis
    # min/max turns an inverted box into an ALWAYS-hit box at t_min, which
    # made every ray walk every pad cluster and trip the exact-overflow
    # continuation on every wave (~12x traversal cost before this fix).
    k_pad = (-k) % 128
    if k_pad:
        inf = np.float32(3e37)
        cmin = np.concatenate([cmin, np.full((k_pad, 3), inf, np.float32)])
        cmax = np.concatenate([cmax, np.full((k_pad, 3), inf, np.float32)])
        blob = np.concatenate([blob, np.zeros((k_pad, c * 9), np.float32)])
        tid = np.concatenate([tid, np.full((k_pad, c), -1, np.int32)])

    # component-plane layout: [K,9,C] so every slice is a contiguous [*,C]
    # plane (no [*,C,3] layout with a 3-wide minor axis)
    planes = np.ascontiguousarray(blob.reshape(-1, c, 9).transpose(0, 2, 1))
    return ClusterBVH(
        cmin=jnp.asarray(cmin),
        cmax=jnp.asarray(cmax),
        tri_planes=jnp.asarray(planes),
        tri_id=jnp.asarray(tid),
    )


def _cluster_entries(ray_o, ray_d, cb: ClusterBVH, t_min, t_max):
    """Dense [N,K] slab test -> entry distance (+inf where missed).

    Layout-aware: per-axis rank-1 expressions (``inv[:,None]*bmin[None,:]``)
    keep every intermediate [N,K] with K in the minor dimension -- never a
    [N,K,3] array with a 3-wide minor axis.
    """
    inv_d = 1.0 / jnp.where(jnp.abs(ray_d) < 1e-12, jnp.where(ray_d < 0, -1e-12, 1e-12), ray_d)
    oi = ray_o * inv_d  # [N,3]
    tn = jnp.full((ray_o.shape[0], cb.cmin.shape[0]), -jnp.inf, jnp.float32)
    tf = jnp.full_like(tn, jnp.inf)
    for a in range(3):
        t0 = inv_d[:, a:a + 1] * cb.cmin[None, :, a] - oi[:, a:a + 1]  # [N,K]
        t1 = inv_d[:, a:a + 1] * cb.cmax[None, :, a] - oi[:, a:a + 1]
        tn = jnp.maximum(tn, jnp.minimum(t0, t1))
        tf = jnp.minimum(tf, jnp.maximum(t0, t1))
    t_enter = jnp.maximum(tn, t_min)
    t_far = t_max[:, None] if jnp.ndim(t_max) == 1 else t_max  # per-ray shadow t_max
    hit = t_enter <= jnp.minimum(tf, t_far)
    return jnp.where(hit, t_enter, jnp.inf)


def _intersect_cluster(ray_o, ray_d, cb: ClusterBVH, cid, t_min, best_t):
    """Dense [N,C] MT test of each ray against its chosen cluster.

    Triangle data arrives via ONE plane gather ([N,9,C], 36*C contiguous
    bytes per ray), ALL math is component-form [N,C] (never a [N,C,3]
    intermediate), and the winner is selected gather-free (min + argmin
    one-hot masked reductions).
    """
    n = ray_o.shape[0]
    c = cb.cluster_size
    pl = cb.tri_planes[cid]  # [N,9,C]
    p0x, p0y, p0z = pl[:, 0], pl[:, 1], pl[:, 2]
    e1x, e1y, e1z = pl[:, 3], pl[:, 4], pl[:, 5]
    e2x, e2y, e2z = pl[:, 6], pl[:, 7], pl[:, 8]
    tid = cb.tri_id[cid]  # [N,C]

    from .intersect import mt_components

    rc = lambda a, ax: a[:, ax, None]  # [N,1]
    t, u, v, ok = mt_components(
        (rc(ray_o, 0), rc(ray_o, 1), rc(ray_o, 2)),
        (rc(ray_d, 0), rc(ray_d, 1), rc(ray_d, 2)),
        (p0x, p0y, p0z),
        (e1x, e1y, e1z),
        (e2x, e2y, e2z),
        t_min,
        best_t[:, None],
    )
    ok &= tid >= 0
    t = jnp.where(ok, t, jnp.inf)
    # gather-free winner selection: argmin one-hot resolved by masked reductions
    j = jnp.argmin(t, axis=-1)
    onehot = jax.lax.broadcasted_iota(jnp.int32, (n, c), 1) == j[:, None]
    tj = jnp.min(t, axis=-1)
    hit = jnp.isfinite(tj)
    pick = lambda x: jnp.sum(jnp.where(onehot, x, 0.0), axis=-1)
    tri = jnp.max(jnp.where(onehot, tid, -1), axis=-1)
    return tj, jnp.where(hit, tri, -1), jnp.stack([pick(u), pick(v)], -1), hit


MAX_CANDIDATES = 16

# Phase-B strategy (API parameter of cluster_closest_hit):
#   direct -- per-ray blob gather (N * C*9 floats per step)
#   sorted -- argsort rays by cluster id first (coherent gather runs)
#   binned -- cluster-aligned bins, one blob gather per bin (~50x fewer bytes)
DEFAULT_PHASE_B = "direct"

# The exact overflow continuation guarantees closest-hit exactness for rays
# with >max_candidates intersected clusters.  Disable (exact_overflow=False)
# to measure its cost (rays beyond the candidate list then terminate on the
# list's best hit).
DEFAULT_EXACT_OVERFLOW = True


def _sorted_intersect(ray_o, ray_d, cb, cid, t_min, best_t):
    perm = jnp.argsort(cid)
    inv = jnp.argsort(perm)
    lt, ltri, luv, lhit = _intersect_cluster(
        ray_o[perm], ray_d[perm], cb, cid[perm], t_min, best_t[perm]
    )
    return lt[inv], ltri[inv], luv[inv], lhit[inv]


def _binned_intersect(ray_o, ray_d, cb, cid, t_min, best_t, block: int = 64):
    """Cluster-aligned binned MT: gather each cluster's blob once per *block*
    instead of once per *ray*.

    Rays are sorted by cluster id and packed into [NB, block] bins that never
    span two clusters, so the triangle blob gather shrinks from N*(C*9) floats
    to NB*(C*9) with NB <= N/block + K -- typically ~50x fewer bytes, at the
    price of sort/segment index math and <= (1 + K*block/N)x padded MT lanes.
    Results are bit-identical to _intersect_cluster.
    """
    n = ray_o.shape[0]
    c = cb.cluster_size
    nb = n // block + cb.num_clusters  # static worst-case bin count

    perm = jnp.argsort(cid)
    scid = cid[perm]
    # position of each sorted ray within its cluster run
    run_start = jnp.searchsorted(scid, scid, side="left")
    within = jnp.arange(n, dtype=jnp.int32) - run_start.astype(jnp.int32)
    is_block_start = (within % block) == 0
    block_idx = jnp.cumsum(is_block_start.astype(jnp.int32)) - 1  # [N]
    slot = within % block

    # per-block cluster id
    block_cid = jnp.zeros((nb,), jnp.int32).at[block_idx].max(scid)

    def pack(x, fill=0.0):
        shape = (nb, block) + x.shape[1:]
        return jnp.full(shape, fill, x.dtype).at[block_idx, slot].set(x[perm])

    o_b = pack(ray_o)
    d_b = pack(ray_d)
    bt_b = pack(best_t, fill=-1.0)  # fill<t_min => padded lanes can't hit
    valid_b = jnp.zeros((nb, block), bool).at[block_idx, slot].set(True)

    pl = cb.tri_planes[block_cid]  # [NB,9,C]
    comp = lambda p: pl[:, p, None, :]  # [NB,1,C]
    p0x, p0y, p0z = comp(0), comp(1), comp(2)
    e1x, e1y, e1z = comp(3), comp(4), comp(5)
    e2x, e2y, e2z = comp(6), comp(7), comp(8)
    tid = cb.tri_id[block_cid]  # [NB,C]

    from .intersect import mt_components

    rc = lambda a, ax: a[..., ax, None]  # [NB,B,1]
    t, u, v, ok = mt_components(
        (rc(o_b, 0), rc(o_b, 1), rc(o_b, 2)),
        (rc(d_b, 0), rc(d_b, 1), rc(d_b, 2)),
        (p0x, p0y, p0z),
        (e1x, e1y, e1z),
        (e2x, e2y, e2z),
        t_min,
        bt_b[:, :, None],
    )
    ok &= valid_b[:, :, None] & (tid[:, None, :] >= 0)
    t = jnp.where(ok, t, jnp.inf)
    # gather-free winner selection over the C axis
    j = jnp.argmin(t, axis=-1)  # [NB,B]
    onehot = jax.lax.broadcasted_iota(jnp.int32, t.shape, 2) == j[..., None]
    tj = jnp.min(t, axis=-1)
    hit_b = jnp.isfinite(tj)
    pick3 = lambda x: jnp.sum(jnp.where(onehot, x, 0.0), axis=-1)
    tri_b = jnp.max(jnp.where(onehot, tid[:, None, :], -1), axis=-1)
    tri_b = jnp.where(hit_b, tri_b, -1)
    u_b = pick3(u)
    v_b = pick3(v)

    # unpack back to original ray order
    inv_perm = jnp.argsort(perm)

    def unpack(x):
        flat = x[block_idx, slot]  # sorted-ray order
        return flat[inv_perm]

    return unpack(tj), unpack(tri_b), jnp.stack([unpack(u_b), unpack(v_b)], -1), unpack(hit_b)


@partial(jax.jit, static_argnames=("any_hit", "max_candidates", "phase_b", "exact_overflow"))
def cluster_closest_hit(
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    cb: ClusterBVH,
    t_min: float = m.T_MIN,
    t_max: float = m.T_MAX,
    any_hit: bool = False,
    max_candidates: int = MAX_CANDIDATES,
    phase_b: str = DEFAULT_PHASE_B,
    exact_overflow: bool = DEFAULT_EXACT_OVERFLOW,
) -> HitRecord:
    """Exact closest hit (or first hit with ``any_hit``).

    Phase A produces each ray's near-to-far candidate-cluster list ONCE via
    ``top_k`` (no [N,K] work inside the hot loop); phase B walks the lists in
    lockstep with early exit: a ray stops as soon as its best t is closer
    than its next cluster entry.  Rays that exhaust their ``max_candidates``
    list while still unresolved continue in an exact argmin-over-[N,K]
    fallback loop -- which compiles to nothing at runtime when (as in real
    scenes) no ray overflows.
    """
    n = ray_o.shape[0]
    kc = min(max_candidates, cb.num_clusters)
    entries = _cluster_entries(ray_o, ray_d, cb, t_min, t_max)  # [N,K]
    # nearest kc clusters, ascending entry distance
    neg_top, top_idx = jax.lax.top_k(-entries, kc)  # [N,kc]
    cand_t = -neg_top

    if jnp.ndim(t_max) == 0:
        best0 = jnp.full((n,), t_max, jnp.float32)
    else:
        best0 = jnp.asarray(t_max, jnp.float32)

    state = (
        best0,
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n, 2), jnp.float32),
    )
    rows = jnp.arange(n)

    # Fixed-trip fori over candidate-list COLUMNS: since each ray's list is
    # sorted ascending and best_t only shrinks, "process column i iff
    # cand_t[:,i] < best_t" is exactly the early-exit cursor walk -- but the
    # per-iteration candidate reads are dynamic slices instead of per-ray
    # gathers.
    def body(i, state):
        best_t, best_tri, best_uv = state
        cur_t = jax.lax.dynamic_slice_in_dim(cand_t, i, 1, axis=1)[:, 0]
        cid = jax.lax.dynamic_slice_in_dim(top_idx, i, 1, axis=1)[:, 0]
        if any_hit:
            active = jnp.isfinite(cur_t) & (best_tri < 0)
        else:
            active = cur_t < best_t
        cid_safe = jnp.where(active, cid, 0)
        isect = {
            "direct": _intersect_cluster,
            "sorted": _sorted_intersect,
            "binned": _binned_intersect,
        }[phase_b]
        lt, ltri, luv, lhit = isect(ray_o, ray_d, cb, cid_safe, t_min, best_t)
        better = active & lhit & (lt < best_t)
        best_t = jnp.where(better, lt, best_t)
        best_tri = jnp.where(better, ltri, best_tri)
        best_uv = jnp.where(better[:, None], luv, best_uv)
        return (best_t, best_tri, best_uv)

    best_t, best_tri, best_uv = jax.lax.fori_loop(0, kc, body, state)

    if not exact_overflow:
        return HitRecord(t=best_t, tri=best_tri, uv=best_uv)

    # ── exact overflow continuation (rare; skipped entirely when unneeded) ──
    last_t = cand_t[:, kc - 1]
    if any_hit:
        overflow = jnp.isfinite(last_t) & (best_tri < 0)
    else:
        overflow = jnp.isfinite(last_t) & (last_t < best_t)

    def run_overflow(args):
        best_t, best_tri, best_uv = args
        k_iota = jax.lax.broadcasted_iota(jnp.int32, entries.shape, 1)

        def retire(ent, idx):
            # gather/scatter-free: mask out the kc candidate columns in idx
            vis = jnp.zeros(ent.shape, bool)
            for i in range(kc):
                vis |= k_iota == jax.lax.dynamic_slice_in_dim(idx, i, 1, 1)
            return jnp.where(vis, jnp.inf, ent)

        ent0 = retire(entries, top_idx)

        def walk(ent, best_t, best_tri, best_uv):
            """One batch: next-kc-nearest clusters per ray, column walk."""
            neg, ti = jax.lax.top_k(-ent, kc)
            ct = -neg

            def body(i, st):
                best_t, best_tri, best_uv = st
                cur_t = jax.lax.dynamic_slice_in_dim(ct, i, 1, axis=1)[:, 0]
                cid = jax.lax.dynamic_slice_in_dim(ti, i, 1, axis=1)[:, 0]
                if any_hit:
                    active = jnp.isfinite(cur_t) & (best_tri < 0)
                else:
                    active = cur_t < best_t
                cid_safe = jnp.where(active, cid, 0)
                lt, ltri, luv, lhit = _intersect_cluster(ray_o, ray_d, cb, cid_safe, t_min, best_t)
                better = active & lhit & (lt < best_t)
                best_t = jnp.where(better, lt, best_t)
                best_tri = jnp.where(better, ltri, best_tri)
                best_uv = jnp.where(better[:, None], luv, best_uv)
                return (best_t, best_tri, best_uv)

            best_t, best_tri, best_uv = jax.lax.fori_loop(0, kc, body, (best_t, best_tri, best_uv))
            return retire(ent, ti), best_t, best_tri, best_uv

        def need2(ent, best_t, best_tri):
            nearest = ent.min(axis=-1)
            if any_hit:
                return jnp.isfinite(nearest) & (best_tri < 0)
            return nearest < best_t

        def cond2(st):
            ent, best_t, best_tri, _ = st
            return jnp.any(need2(ent, best_t, best_tri))

        def body2(st):
            return walk(*st)

        _, bt, btri, buv = jax.lax.while_loop(cond2, body2, (ent0, best_t, best_tri, best_uv))
        return bt, btri, buv

    best_t, best_tri, best_uv = jax.lax.cond(
        jnp.any(overflow), run_overflow, lambda a: a, (best_t, best_tri, best_uv)
    )
    return HitRecord(t=best_t, tri=best_tri, uv=best_uv)


def make_cluster_intersector(cb: ClusterBVH, **kw):
    def intersect(ray_o, ray_d):
        return cluster_closest_hit(ray_o, ray_d, cb, **kw)

    return intersect


def cluster_occluded(ray_o, ray_d, cb: ClusterBVH, t_min=m.T_MIN, t_max=m.T_MAX):
    rec = cluster_closest_hit(ray_o, ray_d, cb, t_min=t_min, t_max=t_max, any_hit=True)
    return rec.tri >= 0

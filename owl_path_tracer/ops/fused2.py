"""Fused wavefront traversal: one Pallas-Triton kernel per wave of rays.

A block of ``BLOCK_RAYS`` rays shares every triangle cluster it visits, so
the cluster's triangles are read once per block rather than once per ray
(the XLA ``cluster`` intersector gathers a ``[rays, 9, C]`` plane slab on
every candidate step).  Per block:

  * **scene gate**: a slab test against the scene AABB; blocks of parked or
    sky-bound rays do no traversal at all;
  * **frontier**: a ``[B, KT]``-tiled slab test of the block's rays against
    every cluster AABB, reduced to the nearest entry over the block and kept
    in a per-block ``[Kp]`` row of device memory;
  * **retirement loop**: pick the nearest unretired cluster whose entry
    beats some ray's best ``t``, intersect its C triangles in ``[B, CT]``
    sub-tiles (component-form Moller-Trumbore, the shared ``mt_components``
    op order), and every ``REFRESH_CLUSTERS`` retirements re-run the slab
    test with per-ray caps so one far ray cannot keep the block walking
    clusters behind every other ray's hit;
  * **winner replay**: the winning slot's float32 attributes (shading
    payload, tri id, and triangle geometry) are loaded directly, and
    ``(t, u, v)`` are recomputed once from that geometry with the same
    formula the cluster intersector uses.

Any-hit mode (shadow rays) stops a ray at its first valid hit and retires
the block once every ray is occluded or out of candidates, the equivalent
of OPTIX_RAY_FLAG_TERMINATE_ON_FIRST_HIT (reference device.cu:106-107).
A block that exceeds ``MAX_STEPS`` retirements is flagged unresolved and
its rays fall back to the exact XLA cluster intersector.

On a GPU the kernel is compiled through Triton; on the CPU (tests) it runs
in the Pallas interpreter; any other backend is refused.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import math as m
from .cluster import ClusterBVH, build_clusters, cluster_closest_hit, cluster_occluded
from .intersect import HitRecord, mt_components

# Rays per kernel program.  Triton wants powers of two for every block.
BLOCK_RAYS = 32
# Element budgets of the two [B, *] temporaries: the triangle sub-tile
# [B, CT] (Moller-Trumbore keeps ~15 such values live) and the slab-test
# tile [B, KT].  At 4 warps, 1024 elements are 8 registers a value a thread.
MT_TILE_ELEMS = 1024
SLAB_TILE_ELEMS = 2048
NUM_WARPS = 4
NUM_STAGES = 2
# Default triangles per cluster (make_accel halves it for small scenes).
CLUSTER_SIZE = 256
# Retirement-loop bound before a block falls back to the exact XLA path.
MAX_STEPS = 512
# Frontier refresh with per-ray caps, every this many retired clusters.
REFRESH_CLUSTERS = 16

# Per-slot attribute row layout (ATTR_ROWS float32 values per triangle):
#   0:3 n0.xyz   3:6 n1.xyz   6:9 n2.xyz
#   9:11 tc0.uv  11:13 tc1.uv 13:15 tc2.uv
#   15  material id (exact small-int f32)
#   16  tri id (exact f32 < 2^24)
#   17:20 p0.xyz  20:23 e1.xyz  23:26 e2.xyz (winner geometry for the replay)
#   26:32 zero padding
ATTR_ROWS = 32
PAYLOAD_ROWS = 16

# Kernel output rows ([32, N]):
#   0 t   1 u   2 v   3 tri(f32)   4 hit   5 resolved   6 clusters retired
#   7 winner cluster   8 winner slot-in-cluster   9:16 zero
#   16:32 shading payload of the winning triangle (attr rows 0:16)
OUT_ROWS = 32


class Fused2BVH(NamedTuple):
    boxes: jnp.ndarray  # [8,Kp]: rows 0-2 cmin.xyz, 3-5 cmax.xyz; pads never hit
    planes: jnp.ndarray  # [Kp,9,C] component planes p0 e1 e2 (pads all zero)
    attrs: jnp.ndarray  # [Kp*C,ATTR_ROWS] per-slot payload (row layout above)
    attr_table: jnp.ndarray  # [T,ATTR_ROWS] same payload by tri id (fallback)
    bounds: jnp.ndarray  # [2,3] scene AABB (scene gate, ray-sort keys)
    cluster: ClusterBVH  # exact XLA fallback path

    @property
    def num_clusters(self) -> int:
        return self.boxes.shape[1]

    @property
    def cluster_size(self) -> int:
        return self.planes.shape[2]


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def build_fused2(
    vertices: np.ndarray,
    tri_idx: np.ndarray,
    cluster_size: int = CLUSTER_SIZE,
    normals: np.ndarray | None = None,
    texcoords: np.ndarray | None = None,
    tri_mat: np.ndarray | None = None,
) -> Fused2BVH:
    """SAH-leaf clusters, padded to a power-of-two count, + attribute slots."""
    vertices = np.asarray(vertices, np.float32)
    tri_idx = np.asarray(tri_idx, np.int32)
    assert cluster_size & (cluster_size - 1) == 0, "cluster_size must be a power of two"
    cb = build_clusters(vertices, tri_idx, cluster_size)
    k, c = cb.num_clusters, cb.cluster_size
    kp = _next_pow2(max(k, 16))

    # pads are degenerate points at +3e37, never inside any ray's window
    # (the ops/cluster.py pad convention)
    boxes = np.full((8, kp), 3e37, np.float32)
    boxes[6:8] = 0.0
    boxes[0:3, :k] = np.asarray(cb.cmin).T
    boxes[3:6, :k] = np.asarray(cb.cmax).T
    planes = np.zeros((kp, 9, c), np.float32)
    planes[:k] = np.asarray(cb.tri_planes)
    tid = np.full((kp, c), -1, np.int32)
    tid[:k] = np.asarray(cb.tri_id)
    assert tid.max() < (1 << 24), "tri ids exceed exact f32 range"

    # per-triangle shading payload (zeros when the caller has no attributes,
    # e.g. geometry-only tests)
    t_count = tri_idx.shape[0]
    attr_table = np.zeros((t_count, ATTR_ROWS), np.float32)
    if normals is None:
        normals = np.zeros((vertices.shape[0], 3), np.float32)
    if texcoords is None:
        texcoords = np.zeros((vertices.shape[0], 2), np.float32)
    if tri_mat is None:
        tri_mat = np.zeros((t_count,), np.int32)
    nrm = np.asarray(normals, np.float32)
    tc = np.asarray(texcoords, np.float32)
    for v_i in range(3):
        attr_table[:, 3 * v_i : 3 * v_i + 3] = nrm[tri_idx[:, v_i]]
        attr_table[:, 9 + 2 * v_i : 11 + 2 * v_i] = tc[tri_idx[:, v_i]]
    attr_table[:, 15] = np.asarray(tri_mat, np.float32)
    attr_table[:, 16] = np.arange(t_count, dtype=np.float32)
    # winner-geometry rows come from the SAME plane arrays the cluster
    # intersector reads (not re-derived from vertices), so the replay
    # reproduces the cluster intersector's t/u/v for the same winner
    tp = planes.transpose(0, 2, 1)  # [Kp,C,9]
    valid = tid >= 0
    attr_table[tid[valid], 17:26] = tp[valid]
    attrs = np.where(valid[..., None], attr_table[np.maximum(tid, 0)], 0.0)

    bounds = np.stack([vertices.min(0), vertices.max(0)]).astype(np.float32)
    return Fused2BVH(
        boxes=jnp.asarray(boxes),
        planes=jnp.asarray(planes),
        attrs=jnp.asarray(attrs.reshape(kp * c, ATTR_ROWS).astype(np.float32)),
        attr_table=jnp.asarray(attr_table),
        bounds=jnp.asarray(bounds),
        cluster=cb,
    )


def build_fused2_scene(scene, cluster_size: int = CLUSTER_SIZE) -> Fused2BVH:
    """Build from a compiled Scene (models/scene.py) including shading attrs."""
    return build_fused2(
        np.asarray(scene.vertices),
        np.asarray(scene.tri_idx),
        cluster_size=cluster_size,
        normals=np.asarray(scene.normals),
        texcoords=np.asarray(scene.texcoords),
        tri_mat=np.asarray(scene.tri_mat),
    )


def interpret_mode() -> bool:
    """Pallas interpreter on the CPU (tests), compiled Triton on a GPU;
    no other backend runs this kernel."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise NotImplementedError(f"fused2 has no kernel for the {backend!r} backend")


def _safe_inv(x):
    return 1.0 / jnp.where(jnp.abs(x) < 1e-12, jnp.where(x < 0, -1e-12, 1e-12), x)


def _kernel(b, kp, c, ct, kt, max_steps, any_hit, with_attrs,
            rays_ref, scene_ref, boxes_ref, planes_ref, attrs_ref, out_ref, front_ref):
    o = [rays_ref[a, :] for a in range(3)]  # [B] each
    d = [rays_ref[3 + a, :] for a in range(3)]
    tmax = rays_ref[6, :]
    inv = [_safe_inv(x) for x in d]
    oi = [o[a] * inv[a] for a in range(3)]
    t_min = m.T_MIN
    inf = float("inf")

    def entries(lo, hi, cap):
        """Slab entry distance of each ray into boxes [lo, hi] (+inf where
        the ray misses the box inside its window or its cap).  lo/hi are
        per-axis [1, KT] rows or scalars; the result is [B, KT] or [B]."""
        expand = jnp.ndim(lo[0]) > 0
        col = (lambda x: x[:, None]) if expand else (lambda x: x)
        tn, tf = -inf, inf
        for a in range(3):
            t0 = col(inv[a]) * lo[a] - col(oi[a])
            t1 = col(inv[a]) * hi[a] - col(oi[a])
            tn = jnp.maximum(tn, jnp.minimum(t0, t1))
            tf = jnp.minimum(tf, jnp.maximum(t0, t1))
        t_enter = jnp.maximum(tn, t_min)
        need = t_enter <= jnp.minimum(tf, col(tmax))
        if cap is not None:
            need &= t_enter < col(cap)
        return jnp.where(need, t_enter, inf)

    def frontier_update(cap):
        """Per-cluster nearest entry over the block's rays.  ``cap=None`` is
        the initial pass (window [t_min, tmax] only); with per-ray caps the
        pass is a refresh, and already-retired (inf) clusters stay retired."""

        def tile(j, carry):
            k0 = pl.multiple_of(j * kt, kt)
            lo = [boxes_ref[a, pl.ds(k0, kt)][None, :] for a in range(3)]
            hi = [boxes_ref[3 + a, pl.ds(k0, kt)][None, :] for a in range(3)]
            fresh = jnp.min(entries(lo, hi, cap), axis=0)  # [KT]
            if cap is not None:
                fresh = jnp.where(front_ref[0, pl.ds(k0, kt)] == inf, inf, fresh)
            front_ref[0, pl.ds(k0, kt)] = fresh
            return carry

        jax.lax.fori_loop(0, kp // kt, tile, 0)

    def ray_caps(best, slot):
        # any-hit rays that already hit need nothing more
        return jnp.where(slot >= 0, 0.0, best) if any_hit else best

    iota_k = jax.lax.broadcasted_iota(jnp.int32, (kp,), 0)

    def pick(best, slot):
        """Nearest unretired cluster whose block entry beats the block prune
        bound (the largest cap over the block's rays); kp when none."""
        f = front_ref[0, :]
        mn = jnp.min(f)
        cid = jnp.min(jnp.where(f == mn, iota_k, kp))
        return jnp.where(mn < jnp.max(ray_caps(best, slot)), cid, kp)

    iota_ct = jax.lax.broadcasted_iota(jnp.int32, (b, ct), 1)
    o_col = [x[:, None] for x in o]
    d_col = [x[:, None] for x in d]

    def intersect_cluster(cid, best, slot):
        front_ref[0, pl.ds(cid, 1)] = jnp.full((1,), inf)  # retire

        def sub_tile(j, carry):
            best, slot = carry
            c0 = pl.multiple_of(j * ct, ct)
            p = [planes_ref[cid, r, pl.ds(c0, ct)][None, :] for r in range(9)]
            # padding slots have all-zero planes: det = 0 rejects them
            t, _, _, ok = mt_components(
                o_col, d_col, p[0:3], p[3:6], p[6:9], t_min, best[:, None]
            )
            base = cid * c + c0
            if any_hit:
                got = jnp.max(jnp.where(ok, 1, 0), axis=1) > 0
                return best, jnp.where(got & (slot < 0), base, slot)
            t = jnp.where(ok, t, inf)
            tc = jnp.min(t, axis=1)  # [B]
            w = jnp.min(jnp.where(t == tc[:, None], iota_ct, ct), axis=1)
            better = tc < best
            return jnp.where(better, tc, best), jnp.where(better, base + w, slot)

        return jax.lax.fori_loop(0, c // ct, sub_tile, (best, slot))

    best0 = tmax
    slot0 = jnp.full((b,), -1, jnp.int32)
    scene_lo = [scene_ref[a] for a in range(3)]
    scene_hi = [scene_ref[3 + a] for a in range(3)]
    live = jnp.min(entries(scene_lo, scene_hi, None)) < inf

    pl.when(live)(lambda: frontier_update(None))
    # a dead block's pick reads its unwritten frontier row; the select drops it
    cid0 = jnp.where(live, pick(best0, slot0), kp)

    def loop_cond(carry):
        i, cid, _, _ = carry
        return (cid < kp) & (i < max_steps)

    def loop_body(carry):
        i, cid, best, slot = carry
        best, slot = intersect_cluster(cid, best, slot)
        i = i + 1

        @pl.when(jax.lax.rem(i, REFRESH_CLUSTERS) == 0)
        def _():
            frontier_update(ray_caps(best, slot))

        return i, pick(best, slot), best, slot

    steps, cid_end, best, slot = jax.lax.while_loop(
        loop_cond, loop_body, (jnp.int32(0), cid0, best0, slot0)
    )

    zeros = jnp.zeros((b,), jnp.float32)
    hit = slot >= 0
    # a block that ran out of steps with candidates left is unresolved
    resolved = jnp.where(jnp.full((b,), cid_end) < kp, 0.0, 1.0)
    out_ref[4, :] = jnp.where(hit, 1.0, 0.0)
    out_ref[5, :] = resolved
    out_ref[6, :] = zeros + steps.astype(jnp.float32)
    for r in range(9, 16):
        out_ref[r, :] = zeros
    if any_hit:
        out_ref[0, :] = best
        for r in (1, 2, 7, 8):
            out_ref[r, :] = zeros
        out_ref[3, :] = zeros - 1.0
        for r in range(PAYLOAD_ROWS):
            out_ref[PAYLOAD_ROWS + r, :] = zeros
        return

    safe = jnp.maximum(slot, 0)

    def attr(r):
        return attrs_ref[safe, r]  # [B] gather of the winner's row

    # winner replay: (t, u, v) from the winner's geometry with the canonical
    # mt_components op order.  Authoritative whenever the winner's
    # determinant is non-degenerate (gating on its window tests would make
    # the value depend on FMA contraction at knife edges); a degenerate
    # replay keeps the in-loop t and reports uv = (0, 0).
    g = [attr(17 + r) for r in range(9)]
    t3, u3, v3, _ = mt_components(o, d, g[0:3], g[3:6], g[6:9], t_min, inf)
    e1, e2 = g[3:6], g[6:9]
    hx = d[1] * e2[2] - d[2] * e2[1]
    hy = d[2] * e2[0] - d[0] * e2[2]
    hz = d[0] * e2[1] - d[1] * e2[0]
    det3 = e1[0] * hx + e1[1] * hy + e1[2] * hz
    use3 = hit & (jnp.abs(det3) > 1e-12)
    out_ref[0, :] = jnp.where(use3, t3, best)
    out_ref[1, :] = jnp.where(use3, u3, 0.0)
    out_ref[2, :] = jnp.where(use3, v3, 0.0)
    out_ref[3, :] = jnp.where(hit, attr(16), -1.0)
    out_ref[7, :] = jnp.where(hit, (slot // c).astype(jnp.float32), -1.0)
    out_ref[8, :] = jnp.where(hit, (slot % c).astype(jnp.float32), -1.0)
    for r in range(PAYLOAD_ROWS):
        out_ref[PAYLOAD_ROWS + r, :] = (
            jnp.where(hit, attr(r), 0.0) if with_attrs else zeros
        )


# Pallas is imported lazily so that importing the package never pulls it in
pl = None
plt = None


def _ensure_pallas():
    global pl, plt
    if pl is None:
        from jax.experimental import pallas as _pl
        from jax.experimental.pallas import triton as _plt

        pl, plt = _pl, _plt


@partial(jax.jit, static_argnames=("block", "max_steps", "with_attrs", "any_hit", "interpret"))
def sweep(rays, fb: Fused2BVH, block: int, max_steps: int, with_attrs: bool,
          any_hit: bool, interpret: bool):
    """One kernel launch over packed rays [8, N] (pack_rays) -> [32, N]
    (rows as in OUT_ROWS).  ``interpret`` selects the Pallas interpreter;
    callers take it from ``interpret_mode()``."""
    _ensure_pallas()
    n = rays.shape[1]
    kp, c = fb.num_clusters, fb.cluster_size
    assert block & (block - 1) == 0 and n % block == 0, (n, block)
    ct = min(c, max(MT_TILE_ELEMS // block, 1))
    kt = min(kp, max(SLAB_TILE_ELEMS // block, 1))
    g = n // block
    scene = jnp.concatenate([fb.bounds.reshape(6), jnp.zeros((2,), jnp.float32)])
    whole = lambda x: pl.BlockSpec(x.shape, lambda i: (0,) * x.ndim)
    out, _ = pl.pallas_call(
        partial(_kernel, block, kp, c, ct, kt, max_steps, any_hit, with_attrs),
        grid=(g,),
        in_specs=[
            pl.BlockSpec((8, block), lambda i: (0, i)),
            whole(scene),
            whole(fb.boxes),
            whole(fb.planes),
            whole(fb.attrs),
        ],
        out_specs=[
            pl.BlockSpec((OUT_ROWS, block), lambda i: (0, i)),
            pl.BlockSpec((1, kp), lambda i: (i, 0)),  # per-block frontier
        ],
        out_shape=[
            jax.ShapeDtypeStruct((OUT_ROWS, n), jnp.float32),
            jax.ShapeDtypeStruct((g, kp), jnp.float32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name="fused2_any_hit" if any_hit else "fused2_closest_hit",
    )(jax.lax.stop_gradient(rays), scene, fb.boxes, fb.planes, fb.attrs)
    return out


def pack_rays(ray_o, ray_d, t_max):
    """[8, N] kernel ray layout: rows o(3) d(3) tmax 0.  Detached: traversal
    is not differentiable (hit records are parameter-independent for
    material/env gradients; camera/geometry gradients use the
    differentiable refit, fused2_closest_hit_diff)."""
    ray_o, ray_d, t_max = jax.lax.stop_gradient((ray_o, ray_d, t_max))
    n = ray_o.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    return jnp.concatenate(
        [ray_o.T, ray_d.T, t_max[None], jnp.zeros((1, n), jnp.float32)]
    )


def fused2_traverse(ray_o, ray_d, t_max, fb: Fused2BVH, block: int = BLOCK_RAYS,
                    max_steps: int = MAX_STEPS, with_attrs: bool = True,
                    any_hit: bool = False):
    """Raw kernel sweep: [N] rays (N a multiple of ``block``) -> [N, 32]:
    cols 0:16 best state (t,u,v,tri,hit,resolved,steps,wcid,wslot,..);
    cols 16:32 shading attr payload of the winning triangle."""
    out = sweep(
        pack_rays(ray_o, ray_d, t_max), fb, block=block, max_steps=max_steps,
        with_attrs=with_attrs, any_hit=any_hit, interpret=interpret_mode(),
    )
    return out.T


def _sweep_rays(ray_o, ray_d, t_max, fb, sort, block, max_steps, with_attrs, any_hit):
    """Pad to whole blocks, optionally coherence-sort, run the kernel, undo
    both -> [32, N]."""
    n0 = ray_o.shape[0]
    ray_o, ray_d, t_max = _pad_rays(ray_o, ray_d, t_max, block)
    rays = pack_rays(ray_o, ray_d, t_max)
    run = partial(
        sweep, fb=fb, block=block, max_steps=max_steps, with_attrs=with_attrs,
        any_hit=any_hit, interpret=interpret_mode(),
    )
    mode = resolve_sort(sort)
    if mode:
        keys = wave_sort_keys(ray_o, ray_d, t_max, fb, mode=mode)
        perm = jnp.argsort(keys, stable=True)
        out = run(rays[:, perm])[:, _inverse_perm(perm)]
    else:
        out = run(rays)
    return out[:, :n0]


# ── optional wave sort (plain XLA, outside the kernel) ──────────────────────


def _morton3(x, y, z, bits: int = 4):
    key = jnp.zeros_like(x)
    for i in range(bits):
        key = (
            key
            | (((x >> i) & 1) << (3 * i + 2))
            | (((y >> i) & 1) << (3 * i + 1))
            | (((z >> i) & 1) << (3 * i))
        )
    return key


# sort-key resolution: origin Morton bits per axis and direction bits per
# axis; keys occupy bits [0, 30)
SORT_O_BITS = 5
SORT_D_BITS = 4
assert 3 * (SORT_O_BITS + SORT_D_BITS) <= 30

# wave sort mode: "cid2" sorts by the ray's first TWO candidate clusters
# (nearest slab entries), morton cell as the minor key; "morton" is the
# origin/direction key; "auto" lets the renderers pick per scene
# (auto_sort_mode).  Tests force a mode by assigning this attribute.
SORT_MODE = "auto"
# candidate-scan K-chunk width (memory bound: [N,chunk] slab temps)
CID_CHUNK = 512
# candidate coarsening: the key scan runs over META-boxes, each the union of
# CID_META SAH-consecutive (hence spatially adjacent) clusters
CID_META = 4


def ray_sort_keys(ray_o, ray_d, bounds) -> jnp.ndarray:
    """Coherence key: origin Morton cell (major) + direction cell (minor).

    Sorting a wave by this key (STABLY, so spawn-order coherence survives
    ties) packs rays that will walk the same clusters into the same kernel
    block, so each block retires fewer distinct clusters.
    """
    ob, db = SORT_O_BITS, SORT_D_BITS
    lo = bounds[0]
    ext = jnp.maximum(bounds[1] - bounds[0], 1e-6)
    cells = float(1 << ob)
    q = jnp.clip(((ray_o - lo) / ext) * cells, 0.0, cells - 1.0).astype(jnp.int32)
    mk = _morton3(q[:, 0], q[:, 1], q[:, 2], bits=ob)
    dcells = float(1 << db)
    dq = jnp.clip((ray_d * 0.5 + 0.5) * dcells, 0.0, dcells - 1.0).astype(jnp.int32)
    dk = (dq[:, 0] << (2 * db)) | (dq[:, 1] << db) | dq[:, 2]
    return (mk << (3 * db)) | dk


def _top2_candidates(ray_o, ray_d, t_max, boxes, k: int):
    """Per-ray ids of the two nearest candidate clusters (slab entry order).

    Entry = max(slab t_near, T_MIN), valid iff entry <= min(t_far, t_max).
    Rays with no (or one) candidate get the sentinel id ``k`` -- they sort
    last.  Computed as a lax.scan over K-chunks so memory stays
    [N, CID_CHUNK] at any K.  The ids are only an ordering key, so slab
    rounding is irrelevant to correctness.
    """
    n = ray_o.shape[0]
    ch = min(CID_CHUNK, k)
    kp = (k + ch - 1) // ch * ch
    bx = boxes
    if kp != k:
        # far point-boxes (the ops/cluster.py pad convention) are never a
        # valid entry.  NB inverted boxes (cmin > cmax) do NOT work -- the
        # per-axis min/max reorders the planes and matches everything.
        pad = jnp.concatenate(
            [
                jnp.full((6, kp - k), 3e37, jnp.float32),
                jnp.zeros((2, kp - k), jnp.float32),
            ]
        )
        bx = jnp.concatenate([boxes, pad], 1)
    bx = bx.reshape(8, kp // ch, ch).transpose(1, 0, 2)  # [nchunk,8,ch]

    ia = [_safe_inv(ray_d[:, a : a + 1]) for a in range(3)]
    oa = [ray_o[:, a : a + 1] for a in range(3)]
    tmax_col = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))[:, None]
    col = jax.lax.broadcasted_iota(jnp.int32, (n, ch), 1)

    def body(carry, args):
        e1, i1, e2, i2 = carry
        cb, k0 = args
        tn = jnp.full((n, ch), -jnp.inf)
        tf = jnp.full((n, ch), jnp.inf)
        for a in range(3):
            t0 = ia[a] * cb[a : a + 1] - oa[a] * ia[a]
            t1 = ia[a] * cb[3 + a : 4 + a] - oa[a] * ia[a]
            tn = jnp.maximum(tn, jnp.minimum(t0, t1))
            tf = jnp.minimum(tf, jnp.maximum(t0, t1))
        enter = jnp.maximum(tn, m.T_MIN)
        ent = jnp.where(enter <= jnp.minimum(tf, tmax_col), enter, jnp.inf)
        c1 = jnp.min(ent, axis=1, keepdims=True)
        a1 = jnp.min(jnp.where(ent == c1, col, ch), axis=1, keepdims=True)
        ent2 = jnp.where(col == a1, jnp.inf, ent)
        c2 = jnp.min(ent2, axis=1, keepdims=True)
        a2 = jnp.min(jnp.where(ent2 == c2, col, ch), axis=1, keepdims=True)
        g1, g2 = a1 + k0, a2 + k0
        # merge {(e1,i1),(e2,i2)} with {(c1,g1),(c2,g2)} (each pair ordered):
        # ties break toward the EARLIER chunk (carry)
        take_c = c1 < e1
        ne1 = jnp.where(take_c, c1, e1)
        ni1 = jnp.where(take_c, g1, i1)
        lo2 = jnp.where(take_c, e1, c1)  # loser of the first merge
        li2 = jnp.where(take_c, i1, g1)
        take_c2 = jnp.minimum(e2, c2) < lo2
        use_e2 = e2 <= c2
        ne2 = jnp.where(take_c2, jnp.minimum(e2, c2), lo2)
        ni2 = jnp.where(take_c2, jnp.where(use_e2, i2, g2), li2)
        return (ne1, ni1, ne2, ni2), None

    inf1 = jnp.full((n, 1), jnp.inf)
    sent = jnp.full((n, 1), kp, jnp.int32)
    (e1, i1, e2, i2), _ = jax.lax.scan(
        body, (inf1, sent, inf1, sent),
        (bx, jnp.arange(0, kp, ch, dtype=jnp.int32)),
    )
    first = jnp.where(jnp.isinf(e1[:, 0]), k, jnp.minimum(i1[:, 0], k))
    second = jnp.where(jnp.isinf(e2[:, 0]), k, jnp.minimum(i2[:, 0], k))
    return first, second


def _meta_boxes(boxes, k: int, meta: int):
    """[8,K] cluster AABBs -> [8,KM] unions of ``meta`` consecutive clusters.
    Pad clusters (cmin >= 1e30) are excluded; all-pad groups become far
    point boxes (the never-hit convention)."""
    if meta <= 1:
        return boxes, k
    km = (k + meta - 1) // meta
    kp = km * meta
    bx = boxes
    if kp != k:
        bx = jnp.concatenate([boxes, jnp.full((8, kp - k), 3e37, jnp.float32)], 1)
    real = bx[0:1] < 1e30  # [1,kp]
    lo = jnp.min(jnp.where(real, bx[0:3], jnp.inf).reshape(3, km, meta), axis=-1)
    hi = jnp.max(jnp.where(real, bx[3:6], -jnp.inf).reshape(3, km, meta), axis=-1)
    none = ~jnp.any(real.reshape(1, km, meta), axis=-1)
    lo = jnp.where(none, 3e37, lo)
    hi = jnp.where(none, 3e37, hi)
    return jnp.concatenate([lo, hi, jnp.zeros((2, km), jnp.float32)]), km


def auto_sort_mode(scene) -> str:
    """Scene-adaptive sort mode for ``sort=True`` (resolved OUTSIDE jit:
    needs concrete vertex arrays).  ENCLOSED scenes -- geometry tiles the
    scene AABB's faces, so bounce rays cannot escape (cornell) -- get the
    candidate-cluster key; open scenes keep morton.  Enclosure proxy: total
    triangle area vs AABB surface area -- cornell ~1.0+, dragon/car/mitsuba
    ~0.35 (pure numpy, build-time)."""
    if SORT_MODE != "auto":
        return SORT_MODE
    v = np.asarray(scene.vertices)
    tri = np.asarray(scene.tri_idx)
    p0 = v[tri[:, 0]]
    e1 = v[tri[:, 1]] - p0
    e2 = v[tri[:, 2]] - p0
    tri_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1).sum()
    ext = np.maximum(v.max(0) - v.min(0), 1e-6)
    aabb_area = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])
    return "cid2" if tri_area / aabb_area > 0.6 else "morton"


def resolve_sort(sort) -> str | None:
    """Normalize a ``sort`` static arg: False -> None, True -> "morton"
    (renderers resolve True via auto_sort_mode before jit), else the mode
    string.  A forced SORT_MODE wins everywhere."""
    if not sort:
        return None
    mode = "morton" if sort is True else sort
    if SORT_MODE != "auto":
        mode = SORT_MODE
    assert mode in ("cid2", "morton"), mode
    return mode


def wave_sort_keys(ray_o, ray_d, t_max, fb: Fused2BVH, mode: str = "morton") -> jnp.ndarray:
    """Coherence key for ``mode`` (< 2^30).  ``cid2``: (first candidate
    meta-cluster, second candidate, coarse morton) lexicographic;
    ``morton``: the origin/direction key."""
    if mode == "morton":
        return ray_sort_keys(ray_o, ray_d, fb.bounds)
    boxes, k = _meta_boxes(fb.boxes, fb.num_clusters, CID_META)
    first, second = _top2_candidates(ray_o, ray_d, t_max, boxes, k)
    kb = max(1, (k + 1).bit_length())  # bits for ids in [0, k]
    mb = 30 - 2 * kb  # leftover minor-key bits
    if mb < 0:  # K beyond ~23k clusters: first candidate only
        kb = min(kb, 30)
        return (first << (30 - kb)).astype(jnp.int32)
    key = (first << (kb + mb)) | (second << mb)
    if mb > 0:
        morton = ray_sort_keys(ray_o, ray_d, fb.bounds)
        mshift = max(0, 3 * (SORT_O_BITS + SORT_D_BITS) - mb)
        key = key | (morton >> mshift)
    return key.astype(jnp.int32)


def _inverse_perm(perm):
    """inv[perm[i]] = i via ONE scatter (argsort(perm) would sort again)."""
    n = perm.shape[0]
    return jnp.zeros((n,), perm.dtype).at[perm].set(
        jnp.arange(n, dtype=perm.dtype), unique_indices=True,
        indices_are_sorted=False,
    )


def _pad_rays(ray_o, ray_d, t_max, block):
    """Pad to a multiple of ``block`` with rays whose window is empty."""
    n = ray_o.shape[0]
    pad = (-n) % block
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    if not pad:
        return ray_o, ray_d, t_max
    ray_o = jnp.concatenate([ray_o, jnp.zeros((pad, 3), jnp.float32)])
    ray_d = jnp.concatenate(
        [ray_d, jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (pad, 3))]
    )
    t_max = jnp.concatenate([t_max, jnp.full((pad,), m.T_MIN, jnp.float32)])
    return ray_o, ray_d, t_max


@partial(jax.jit, static_argnames=("sort", "block", "max_steps", "with_attrs"))
def fused2_closest_hit(
    ray_o, ray_d, fb: Fused2BVH,
    t_min: float = m.T_MIN, t_max=m.T_MAX,
    sort: bool | str = False,
    block: int = BLOCK_RAYS, max_steps: int = MAX_STEPS,
    with_attrs: bool = True,
):
    """Exact closest hit + shading payload.

    Returns (HitRecord, attr_blob [N,16]).  ``sort`` stably sorts the rays
    by a coherence key before the kernel and unsorts after.  Rays of an
    unresolved block (MAX_STEPS overflow) fall back to the exact XLA cluster
    intersector + an attr-table gather.
    """
    out = _sweep_rays(ray_o, ray_d, t_max, fb, sort, block, max_steps, with_attrs, False)
    t = out[0]
    hit = out[4] > 0.0
    tri = jnp.where(hit, out[3].astype(jnp.int32), -1)
    uv = out[1:3].T
    blob = out[PAYLOAD_ROWS:].T
    resolved = out[5] > 0.0

    def with_fallback(args):
        t, tri, uv, blob = args
        rec = cluster_closest_hit(ray_o, ray_d, fb.cluster, t_min=t_min, t_max=t_max)
        fb_blob = fb.attr_table[jnp.maximum(rec.tri, 0)][:, :PAYLOAD_ROWS]
        keep = resolved
        return (
            jnp.where(keep, t, rec.t),
            jnp.where(keep, tri, rec.tri),
            jnp.where(keep[:, None], uv, rec.uv),
            jnp.where(keep[:, None], blob, fb_blob),
        )

    t, tri, uv, blob = jax.lax.cond(
        jnp.all(resolved), lambda a: a, with_fallback, (t, tri, uv, blob)
    )
    t = jnp.where(tri >= 0, t, jnp.asarray(t_max, jnp.float32))
    # hit records are detached even when the (differentiable) XLA fallback
    # produced them
    t, uv, blob = jax.lax.stop_gradient((t, uv, blob))
    return HitRecord(t=t, tri=tri, uv=uv), blob


@partial(jax.jit, static_argnames=("sort", "block", "max_steps"))
def fused2_occluded(
    ray_o, ray_d, fb: Fused2BVH, t_min: float = m.T_MIN, t_max=m.T_MAX,
    sort: bool | str = False, block: int = BLOCK_RAYS, max_steps: int = MAX_STEPS,
):
    """Any-hit occlusion: the first valid hit retires the ray
    (TERMINATE_ON_FIRST_HIT semantics, device.cu:106-107)."""
    out = _sweep_rays(ray_o, ray_d, t_max, fb, sort, block, max_steps, False, True)
    hit = out[4] > 0.0
    resolved = out[5] > 0.0

    def with_fallback(hit):
        occ = cluster_occluded(ray_o, ray_d, fb.cluster, t_min=t_min, t_max=t_max)
        return jnp.where(resolved, hit, occ)

    return jax.lax.cond(jnp.all(resolved), lambda h: h, with_fallback, hit)


def make_fused2_intersector(fb: Fused2BVH, **kw):
    """Intersector returning (HitRecord, attr_blob) -- the integrator uses the
    blob instead of gathering scene.shade_blob."""

    def intersect(ray_o, ray_d):
        return fused2_closest_hit(ray_o, ray_d, fb, **kw)

    return intersect


def fused2_closest_hit_diff(ray_o, ray_d, fb: Fused2BVH, vertices, tri_idx, **kw):
    """fused2 traversal with DIFFERENTIABLE hit geometry.

    The kernel finds the winning triangle with detached rays (hit TOPOLOGY is
    a discrete choice -- correctly non-differentiable); (t, u, v) are then
    re-derived in plain JAX from the live ray and the winner's vertices, so
    camera-basis (and, if ``vertices`` is traced, geometry) gradients flow
    through hit positions and interpolated normals.

    The refit uses the classic pvec/qvec Moller-Trumbore (within rounding of
    the kernel's scalar-triple-product form; tests pin the agreement), so the
    forward VALUE changes only at ulp scale vs ``fused2_closest_hit``.
    """
    rec, blob = fused2_closest_hit(ray_o, ray_d, fb, **kw)
    hit = rec.tri >= 0
    safe = jnp.maximum(rec.tri, 0)
    tri = tri_idx[safe]  # [N,3]
    p0 = vertices[tri[:, 0]]
    e1 = vertices[tri[:, 1]] - p0
    e2 = vertices[tri[:, 2]] - p0
    pvec = jnp.cross(ray_d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    det_ok = jnp.abs(det) > 1e-12
    inv = 1.0 / jnp.where(det_ok, det, 1.0)
    tvec = ray_o - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(ray_d * qvec, axis=-1) * inv
    t = jnp.sum(e2 * qvec, axis=-1) * inv
    use = hit & det_ok
    t = jnp.where(use, t, rec.t)
    uv = jnp.where(use[:, None], jnp.stack([u, v], axis=-1), rec.uv)
    return HitRecord(t=t, tri=rec.tri, uv=uv), blob


def make_fused2_intersector_diff(fb: Fused2BVH, vertices, tri_idx, **kw):
    """Differentiable-hit-geometry variant of make_fused2_intersector."""

    def intersect(ray_o, ray_d):
        return fused2_closest_hit_diff(ray_o, ray_d, fb, vertices, tri_idx, **kw)

    return intersect

"""BVH builder + traversal tests: structural invariants and exact agreement
with the brute-force intersector on every scene shape we have."""
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest

from owl_path_tracer.ops import bvh as bvh_mod
from owl_path_tracer.ops import traverse
from owl_path_tracer.ops.intersect import closest_hit_brute, any_hit_brute
from owl_path_tracer.utils import obj as obj_mod

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"


def random_tris(n, seed=0, spread=4.0):
    r = np.random.default_rng(seed)
    base = r.uniform(-spread, spread, (n, 1, 3))
    tri = base + r.normal(0, 0.4, (n, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return verts, idx


def random_rays(n, seed=1, spread=6.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def check_agreement(verts, idx, n_rays=512, seed=1):
    bvh = bvh_mod.build_bvh(verts, idx)
    bvh_mod.validate_bvh(bvh, verts, idx)
    dev = traverse.device_bvh(bvh, verts, idx)
    o, d = random_rays(n_rays, seed)
    brute = closest_hit_brute(o, d, jnp.asarray(verts), jnp.asarray(idx))
    fast = traverse.bvh_closest_hit(o, d, dev)
    bt, bh = np.asarray(brute.t), np.asarray(brute.tri)
    ft, fh = np.asarray(fast.t), np.asarray(fast.tri)
    # same hit/miss classification
    np.testing.assert_array_equal(fh >= 0, bh >= 0)
    hit = bh >= 0
    # same t (ties between coplanar tris may pick either index)
    np.testing.assert_allclose(ft[hit], bt[hit], rtol=1e-5, atol=1e-6)
    same_tri = fh[hit] == bh[hit]
    assert same_tri.mean() > 0.99  # allow exact-tie differences
    np.testing.assert_allclose(
        np.asarray(fast.uv)[hit][same_tri],
        np.asarray(brute.uv)[hit][same_tri],
        rtol=1e-4,
        atol=1e-5,
    )
    return bvh


def test_random_soup_small():
    verts, idx = random_tris(50)
    check_agreement(verts, idx)


def test_random_soup_medium():
    verts, idx = random_tris(3000, seed=5)
    check_agreement(verts, idx, n_rays=1024, seed=7)


def test_cornell_box_agreement():
    meshes = obj_mod.load_obj(ASSETS / "cornell-box.obj.scene")
    v_list, i_list, base = [], [], 0
    for _, m in meshes:
        v_list.append(m.vertices)
        i_list.append(m.indices + base)
        base += len(m.vertices)
    verts = np.concatenate(v_list)
    idx = np.concatenate(i_list)
    # rays from inside the box
    r = np.random.default_rng(3)
    o = np.tile(np.array([1.0, 1.0, 0.0], np.float32), (512, 1))
    d = r.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    bvh = bvh_mod.build_bvh(verts, idx)
    dev = traverse.device_bvh(bvh, verts, idx)
    brute = closest_hit_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(verts), jnp.asarray(idx))
    fast = traverse.bvh_closest_hit(jnp.asarray(o), jnp.asarray(d), dev)
    # exact agreement with brute force (box is open towards the camera, so
    # some rays legitimately escape)
    np.testing.assert_array_equal(np.asarray(fast.tri) >= 0, np.asarray(brute.tri) >= 0)
    hit = np.asarray(brute.tri) >= 0
    assert hit.mean() > 0.3  # scene only partially encloses the origin point
    np.testing.assert_allclose(np.asarray(fast.t)[hit], np.asarray(brute.t)[hit], rtol=1e-5, atol=1e-6)


def test_single_triangle_and_degenerate():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]], np.float32)
    idx = np.array([[0, 1, 2], [3, 4, 5]], np.int32)  # second tri degenerate
    bvh = bvh_mod.build_bvh(verts, idx)
    dev = traverse.device_bvh(bvh, verts, idx)
    o = jnp.asarray([[0.2, 0.2, 1.0], [2.0, 2.0, 1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], jnp.float32)
    rec = traverse.bvh_closest_hit(o, d, dev)
    tri = np.asarray(rec.tri)
    assert tri[0] == 0 and tri[1] == -1
    np.testing.assert_allclose(np.asarray(rec.t)[0], 1.0, rtol=1e-6)


def test_any_hit_matches_brute():
    verts, idx = random_tris(500, seed=11)
    bvh = bvh_mod.build_bvh(verts, idx)
    dev = traverse.device_bvh(bvh, verts, idx)
    o, d = random_rays(512, seed=13)
    brute = np.asarray(any_hit_brute(o, d, jnp.asarray(verts), jnp.asarray(idx), t_max=5.0))
    fast = np.asarray(traverse.bvh_occluded(o, d, dev, t_max=5.0))
    np.testing.assert_array_equal(fast, brute)


def test_cache_roundtrip(tmp_path):
    verts, idx = random_tris(100, seed=17)
    b1 = bvh_mod.build_bvh_cached(verts, idx, cache_dir=tmp_path)
    b2 = bvh_mod.build_bvh_cached(verts, idx, cache_dir=tmp_path)
    np.testing.assert_array_equal(b1.tri_order, b2.tri_order)
    np.testing.assert_array_equal(b1.node_a, b2.node_a)
    assert len(list(tmp_path.glob("*.npz"))) == 1

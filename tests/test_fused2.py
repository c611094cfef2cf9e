"""Fused traversal kernel (ops/fused2.py): interpret-mode correctness vs
the exact intersectors, attribute-replay payloads, any-hit semantics, and
the kernel's lowering for the GPU (Triton), checked on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest

from owl_path_tracer.ops import cluster as cl
from owl_path_tracer.ops import fused2 as f2
from owl_path_tracer.ops.intersect import closest_hit_brute


def _soup(n_tris=3000, seed=0, spread=4.0):
    r = np.random.default_rng(seed)
    base = r.uniform(-spread, spread, (n_tris, 1, 3))
    tri = base + r.normal(0, 0.4, (n_tris, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    return verts, idx, r


@pytest.fixture(scope="module")
def setup():
    verts, idx, r = _soup()
    normals = r.normal(size=verts.shape).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    texcoords = r.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    tri_mat = r.integers(0, 5, len(idx)).astype(np.int32)
    fb = f2.build_fused2(
        verts, idx, cluster_size=64,
        normals=normals, texcoords=texcoords, tri_mat=tri_mat,
    )
    n = 512
    o = jnp.asarray(r.uniform(-6, 6, (n, 3)).astype(np.float32))
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return fb, verts, idx, o, jnp.asarray(d), r


def test_matches_cluster_exact(setup):
    """Same winners as the XLA cluster intersector; t/uv to 1-2 ulp.

    Round 4: the kernel's output (t,u,v) come from the post-loop
    winner-geometry REPLAY (same mt_components formula, same plane bits as
    the cluster path), but XLA fuses the triple-product FMAs differently for
    [B,1]-shaped operands than for the cluster path's [B,C] sweep, so the
    last float ulp can differ -- exact-equality across differently-shaped
    evaluations of the same expression is not a guarantee XLA makes.  Winner
    CHOICE (tri) must still match exactly."""
    fb, verts, idx, o, d, r = setup
    ref = cl.cluster_closest_hit(o, d, fb.cluster)
    rec, _ = f2.fused2_closest_hit(o, d, fb, sort=False)
    np.testing.assert_array_equal(np.asarray(rec.tri), np.asarray(ref.tri))
    np.testing.assert_allclose(
        np.asarray(rec.t), np.asarray(ref.t), rtol=5e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(rec.uv), np.asarray(ref.uv), rtol=5e-6, atol=1e-6
    )


def test_sorted_equals_unsorted(setup):
    fb, verts, idx, o, d, r = setup
    a, blob_a = f2.fused2_closest_hit(o, d, fb, sort=False)
    b, blob_b = f2.fused2_closest_hit(o, d, fb, sort=True)
    np.testing.assert_array_equal(np.asarray(a.tri), np.asarray(b.tri))
    np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))
    np.testing.assert_array_equal(np.asarray(blob_a), np.asarray(blob_b))


def test_cid2_sorted_equals_unsorted(setup):
    """The candidate-cluster (cid2) sort -- the enclosed-scene sort -- must
    only permute block composition, never results.  Covers closest-hit and
    occlusion under a forced SORT_MODE=cid2 (auto_sort_mode would pick per
    scene)."""
    fb, verts, idx, o, d, r = setup
    old = f2.SORT_MODE
    try:
        f2.SORT_MODE = "cid2"
        a, blob_a = f2.fused2_closest_hit(o, d, fb, sort=False)
        b, blob_b = f2.fused2_closest_hit(o, d, fb, sort=True)
        np.testing.assert_array_equal(np.asarray(a.tri), np.asarray(b.tri))
        np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))
        np.testing.assert_array_equal(np.asarray(blob_a), np.asarray(blob_b))
        occ_a = f2.fused2_occluded(o, d, fb, t_max=2.0, sort=False)
        occ_b = f2.fused2_occluded(o, d, fb, t_max=2.0, sort=True)
        np.testing.assert_array_equal(np.asarray(occ_a), np.asarray(occ_b))
    finally:
        f2.SORT_MODE = old


def test_matches_brute(setup):
    fb, verts, idx, o, d, r = setup
    ref = closest_hit_brute(o, d, jnp.asarray(verts), jnp.asarray(idx))
    rec, _ = f2.fused2_closest_hit(o, d, fb)
    np.testing.assert_array_equal(np.asarray(rec.tri), np.asarray(ref.tri))
    hit = np.asarray(ref.tri) >= 0
    np.testing.assert_allclose(
        np.asarray(rec.t)[hit], np.asarray(ref.t)[hit], rtol=5e-6
    )


def test_attr_blob_matches_table(setup):
    fb, verts, idx, o, d, r = setup
    rec, blob = f2.fused2_closest_hit(o, d, fb)
    hit = np.asarray(rec.tri) >= 0
    want = np.asarray(fb.attr_table)[:, :16][np.asarray(rec.tri)[hit]]
    np.testing.assert_array_equal(np.asarray(blob)[hit], want)
    # misses keep a zero payload
    assert (np.asarray(blob)[~hit] == 0.0).all()


def test_any_hit_occlusion(setup):
    fb, verts, idx, o, d, r = setup
    ref = cl.cluster_occluded(o, d, fb.cluster)
    occ = f2.fused2_occluded(o, d, fb)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))


def test_per_ray_tmax(setup):
    fb, verts, idx, o, d, r = setup
    rec, _ = f2.fused2_closest_hit(o, d, fb)
    hit = np.asarray(rec.tri) >= 0
    # cap t_max just below each ray's closest hit: ray must now miss it
    tm = np.where(hit, np.asarray(rec.t) * 0.99, 1e10).astype(np.float32)
    rec2, _ = f2.fused2_closest_hit(o, d, fb, t_max=jnp.asarray(tm))
    t2 = np.asarray(rec2.t)
    assert ((t2[hit] < np.asarray(rec.t)[hit] * 0.99) | (np.asarray(rec2.tri)[hit] < 0)).all()
    occ = f2.fused2_occluded(o, d, fb, t_max=jnp.asarray(tm))
    occ_ref = cl.cluster_occluded(o, d, fb.cluster, t_max=jnp.asarray(tm))
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ_ref))


def test_small_scene_and_padding():
    # fewer tris than one cluster + ray count not a block multiple
    verts, idx, r = _soup(n_tris=10, seed=3)
    fb = f2.build_fused2(verts, idx, cluster_size=64)
    n = 37
    o = jnp.asarray(r.uniform(-6, 6, (n, 3)).astype(np.float32))
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    ref = closest_hit_brute(o, d, jnp.asarray(verts), jnp.asarray(idx))
    rec, _ = f2.fused2_closest_hit(o, d, fb)
    np.testing.assert_array_equal(np.asarray(rec.tri), np.asarray(ref.tri))


def test_overflow_fallback_is_exact(setup):
    """max_steps=1 forces unresolved rays through the XLA fallback."""
    fb, verts, idx, o, d, r = setup
    ref = cl.cluster_closest_hit(o, d, fb.cluster)
    rec, blob = f2.fused2_closest_hit(o, d, fb, max_steps=1)
    np.testing.assert_array_equal(np.asarray(rec.tri), np.asarray(ref.tri))
    hit = np.asarray(rec.tri) >= 0
    want = np.asarray(fb.attr_table)[:, :16][np.asarray(rec.tri)[hit]]
    np.testing.assert_array_equal(np.asarray(blob)[hit], want)


def test_multi_tile_phase_a():
    """Many clusters: the frontier slab test runs over many [B, KT] tiles and
    the retirement loop passes several per-ray-cap refreshes.  Must stay
    exact vs the cluster intersector across init AND refresh paths."""
    verts, idx, r = _soup(n_tris=20000, seed=7, spread=8.0)
    fb = f2.build_fused2(verts, idx, cluster_size=16)
    assert fb.num_clusters > 1024, fb.num_clusters  # really multi-tile
    n = 512
    o = jnp.asarray(r.uniform(-10, 10, (n, 3)).astype(np.float32))
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    ref = cl.cluster_closest_hit(o, d, fb.cluster)
    rec, _ = f2.fused2_closest_hit(o, d, fb)
    np.testing.assert_array_equal(np.asarray(rec.tri), np.asarray(ref.tri))
    occ = f2.fused2_occluded(o, d, fb)
    occ_ref = cl.cluster_occluded(o, d, fb.cluster)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ_ref))


def test_make_accel_adaptive_cluster_size():
    """make_accel picks the cluster size per scene: CLUSTER_SIZE for large
    scenes, halved for small ones until K >= 64 clusters (floor 32) so the
    block frontier keeps pruning granularity.  The choice does not depend on
    the wave-sort mode."""
    from owl_path_tracer.models import material as material_mod
    from owl_path_tracer.render import film as film_mod
    from test_integrator import sphere_scene  # reuse a real Scene shell

    def fake_scene(n_tris):
        verts, idx, r = _soup(n_tris=n_tris, seed=1)
        sc = sphere_scene(material_mod.single())
        return sc._replace(
            vertices=jnp.asarray(verts), tri_idx=jnp.asarray(idx),
            normals=jnp.zeros((len(verts), 3), jnp.float32),
            texcoords=jnp.zeros((len(verts), 2), jnp.float32),
            tri_mat=jnp.zeros((n_tris,), jnp.int32),
        )

    assert f2.CLUSTER_SIZE == 256
    old = f2.SORT_MODE
    try:
        for mode in ("morton", "cid2"):
            f2.SORT_MODE = mode
            assert film_mod.make_accel(fake_scene(2000), "fused2").cluster_size == 32
            assert film_mod.make_accel(fake_scene(8000), "fused2").cluster_size == 64
            assert film_mod.make_accel(fake_scene(20000), "fused2").cluster_size == 256
    finally:
        f2.SORT_MODE = old


# ── kernel plumbing: layout, block sizes, backend guard, GPU lowering ──────


def test_pack_rays_layout():
    """[8, N]: rows o(3) d(3) t_max 0, broadcast scalar t_max, detached."""
    o = jnp.arange(6, dtype=jnp.float32).reshape(2, 3)
    d = -o
    rays = np.asarray(f2.pack_rays(o, d, 7.0))
    assert rays.shape == (8, 2)
    np.testing.assert_array_equal(rays[0:3], np.asarray(o).T)
    np.testing.assert_array_equal(rays[3:6], np.asarray(d).T)
    np.testing.assert_array_equal(rays[6], [7.0, 7.0])
    np.testing.assert_array_equal(rays[7], [0.0, 0.0])


@pytest.mark.parametrize("block", [16, 64])
def test_block_size_does_not_change_results(setup, block):
    """Rays per block is an efficiency knob: winners, t and payloads must
    match the default block (the frontier prunes per block, exactly)."""
    fb, verts, idx, o, d, r = setup
    base, blob_base = f2.fused2_closest_hit(o, d, fb)
    rec, blob = f2.fused2_closest_hit(o, d, fb, block=block)
    np.testing.assert_array_equal(np.asarray(rec.tri), np.asarray(base.tri))
    np.testing.assert_array_equal(np.asarray(rec.t), np.asarray(base.t))
    np.testing.assert_array_equal(np.asarray(blob), np.asarray(blob_base))
    occ = f2.fused2_occluded(o, d, fb, t_max=2.0, block=block)
    np.testing.assert_array_equal(
        np.asarray(occ), np.asarray(f2.fused2_occluded(o, d, fb, t_max=2.0)))


def test_raw_sweep_rows(setup):
    """fused2_traverse's [N, 32] rows: winner cluster/slot locate the tri id
    in the cluster table, misses report tri -1 and zero payload, and every
    block of this soup resolves within MAX_STEPS."""
    fb, verts, idx, o, d, r = setup
    out = np.asarray(f2.fused2_traverse(o, d, 1e10, fb))
    assert out.shape == (o.shape[0], 32)
    hit = out[:, 4] > 0
    assert hit.any() and (~hit).any()
    assert (out[:, 5] == 1.0).all()
    tid = np.asarray(fb.cluster.tri_id)
    wc, ws = out[hit, 7].astype(int), out[hit, 8].astype(int)
    np.testing.assert_array_equal(tid[wc, ws], out[hit, 3].astype(int))
    assert (out[~hit, 3] == -1).all() and (out[~hit, 16:] == 0).all()


@pytest.mark.parametrize("backend,expected", [("cpu", True), ("gpu", False), ("rocm", None)])
def test_interpret_only_on_cpu(monkeypatch, backend, expected):
    """The interpreter runs only on the CPU; a GPU always gets the compiled
    kernel; any other backend is refused rather than silently interpreted."""
    monkeypatch.setattr(f2.jax, "default_backend", lambda: backend)
    if expected is None:
        with pytest.raises(NotImplementedError):
            f2.interpret_mode()
    else:
        assert f2.interpret_mode() is expected


@pytest.mark.parametrize(
    "any_hit,with_attrs", [(False, True), (False, False), (True, False)],
    ids=["closest-hit+attrs", "closest-hit", "any-hit"],
)
def test_kernel_lowers_for_cuda(setup, any_hit, with_attrs):
    """Every kernel mode lowers to Triton for the GPU (no interpreter): the
    compiled path's primitives are all ones the Pallas Triton lowering
    supports, found without a card."""
    fb, verts, idx, o, d, r = setup
    rays = f2.pack_rays(o, d, 1e10)
    lowered = f2.sweep.trace(
        rays, fb, block=f2.BLOCK_RAYS, max_steps=f2.MAX_STEPS,
        with_attrs=with_attrs, any_hit=any_hit, interpret=False,
    ).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "fused2_" in text and "triton" in text.lower()


@pytest.mark.gpu
def test_compiled_kernel_on_gpu(setup, gpu):
    """On the card: the compiled Triton kernel (never the interpreter) agrees
    with the XLA cluster intersector on winners and occlusion."""
    fb, verts, idx, o, d, r = setup
    assert f2.interpret_mode() is False
    ref = cl.cluster_closest_hit(o, d, fb.cluster)
    rec, _ = f2.fused2_closest_hit(o, d, fb)
    np.testing.assert_array_equal(np.asarray(rec.tri), np.asarray(ref.tri))
    np.testing.assert_array_equal(
        np.asarray(f2.fused2_occluded(o, d, fb, t_max=2.0)),
        np.asarray(cl.cluster_occluded(o, d, fb.cluster, t_max=2.0)),
    )

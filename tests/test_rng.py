"""Bit-parity tests for the LCG RNG against an independent pure-Python
uint32 model of the reference stream (random.hpp:46-69)."""
import numpy as np
import jax.numpy as jnp

from owl_path_tracer.ops import rng

M32 = 0xFFFFFFFF


def py_tea_seed(u, v):
    s = 0
    for _ in range(4):
        s = (s + 0x9E3779B9) & M32
        u = (u + ((((v << 4) & M32) + 0xA341316C) ^ ((v + s) & M32) ^ (((v >> 5) + 0xC8013EA4) & M32))) & M32
        v = (v + ((((u << 4) & M32) + 0xAD90777D) ^ ((u + s) & M32) ^ (((u >> 5) + 0x7E95761E) & M32))) & M32
    return u


def py_next(state):
    return (16807 * state + 1013904223) & M32


def py_float(state):
    return np.float32(np.float32(np.uint32(state)) * np.float32(2.0**-32))


def test_seed_matches_python_model():
    xs = np.array([0, 1, 2, 640, 123456], np.uint32)
    ys = np.array([0, 1, 719, 3, 654321], np.uint32)
    got = np.asarray(rng.seed(xs, ys))
    want = np.array([py_tea_seed(int(x), int(y)) for x, y in zip(xs, ys)], np.uint32)
    np.testing.assert_array_equal(got, want)


def test_stream_matches_python_model():
    state = rng.seed(jnp.array([3], jnp.uint32), jnp.array([5], jnp.uint32))
    py_state = py_tea_seed(3, 5)
    for _ in range(100):
        v, state = rng.next_f32(state)
        py_state = py_next(py_state)
        assert np.asarray(state)[0] == py_state
        np.testing.assert_array_equal(np.asarray(v)[0], py_float(py_state))


def test_uniformity_rough():
    # 100k draws from one stream: mean ~0.5, all in [0,1)
    state = rng.seed(jnp.arange(1000, dtype=jnp.uint32), jnp.arange(1000, dtype=jnp.uint32) + 7)
    vals, _ = rng.next_f32_n(state, 100)
    v = np.asarray(vals)
    assert (v >= 0).all() and (v < 1).all()
    assert abs(v.mean() - 0.5) < 0.01


def test_next_f32_n_chains():
    state = rng.seed(jnp.array([11], jnp.uint32), jnp.array([13], jnp.uint32))
    vals, states = rng.next_f32_n(state, 5)
    s = state
    for i in range(5):
        v, s = rng.next_f32(s)
        np.testing.assert_array_equal(np.asarray(vals[i]), np.asarray(v))
        np.testing.assert_array_equal(np.asarray(states[i]), np.asarray(s))


def test_threefry_helpers():
    from owl_path_tracer.ops.rng import threefry_per_lane, threefry_uniform

    u = threefry_uniform(7, (1000,))
    v = np.asarray(u)
    assert (v >= 0).all() and (v < 1).all() and abs(v.mean() - 0.5) < 0.05
    lanes = threefry_per_lane(7, jnp.arange(64, dtype=jnp.uint32), 8)
    a = np.asarray(lanes)
    assert a.shape == (64, 8)
    # distinct lanes give distinct streams
    assert not np.allclose(a[0], a[1])

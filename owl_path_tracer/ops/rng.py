"""Counter/stream RNGs for the wavefront tracer.

Two generators:

1. ``LcgRng`` -- a *bit-parity* port of the reference per-thread RNG
   (``/root/reference/path_tracer/src/random.hpp:46-69``): a 4-round tea-style
   seed hash of the 2-D pixel coordinate followed by the classic
   ``state = 16807 * state + 1013904223`` LCG, producing floats via
   ``ldexpf((float)state, -32)``.  Stateless-functional here: the uint32 state
   is carried per-ray as an SoA array and every draw returns ``(value, state')``.
   Matching this stream draw-for-draw is what makes per-pixel allclose against
   the CUDA reference renders possible at all.

2. ``jax.random`` threefry keys for the non-parity ("fast") mode -- counter
   based, splittable, the idiomatic JAX choice.

All LCG ops are plain uint32 tensor arithmetic (wrap-around semantics), so
they vectorize over the whole wavefront.
"""
from __future__ import annotations

import jax.numpy as jnp

_A = jnp.uint32(16807)
_C = jnp.uint32(1013904223)
_TEA_ROUNDS = 4
_LDEXP_M32 = jnp.float32(2.0**-32)


def seed(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Tea-style 4-round hash init -- reference random.hpp:46-56.

    ``u``/``v`` are any-shape integer arrays (pixel x / y in the reference,
    device.cu:226). Returns the uint32 LCG state array of the same shape.
    """
    su = jnp.asarray(u).astype(jnp.uint32)
    sv = jnp.asarray(v).astype(jnp.uint32)
    s = jnp.uint32(0)
    for _ in range(_TEA_ROUNDS):
        s = s + jnp.uint32(0x9E3779B9)
        su = su + (((sv << 4) + jnp.uint32(0xA341316C)) ^ (sv + s) ^ ((sv >> 5) + jnp.uint32(0xC8013EA4)))
        sv = sv + (((su << 4) + jnp.uint32(0xAD90777D)) ^ (su + s) ^ ((su >> 5) + jnp.uint32(0x7E95761E)))
    return su


def next_state(state: jnp.ndarray) -> jnp.ndarray:
    """One LCG step: state' = A*state + C (mod 2^32) -- random.hpp:64-66."""
    return _A * state + _C


def to_float(state: jnp.ndarray) -> jnp.ndarray:
    """ldexpf((float)state, -32) -- random.hpp:67. Uniform in [0, 1)."""
    return state.astype(jnp.float32) * _LDEXP_M32


def next_f32(state: jnp.ndarray):
    """Draw one float; returns (value, new_state)."""
    s = next_state(state)
    return to_float(s), s


def next_f32_n(state: jnp.ndarray, n: int):
    """Draw ``n`` sequential floats. Returns (values, states).

    ``values[i]``/``states[i]`` are the i-th draw and the state *after* it, so
    callers that consume a branch-dependent number of draws can select the
    correct successor state with a ``where`` chain (the SoA equivalent of the
    reference's in-thread lazy consumption).
    Shapes: values ``(n, *state.shape)`` float32, states likewise uint32.
    """
    vals, states = [], []
    s = state
    for _ in range(n):
        v, s = next_f32(s)
        vals.append(v)
        states.append(s)
    return jnp.stack(vals), jnp.stack(states)


# ── threefry (jax.random) fast path ────────────────────────────────────────
# The parity LCG above exists for bit-parity with the reference stream; for
# pure-throughput rendering a counter-based threefry stream is the idiomatic
# JAX choice (splittable, no carried state).  These helpers give integrators
# a uniform API over pixel/sample-indexed draws.


def threefry_uniform(seed: int, shape, fold_data=None):
    """Stateless uniform [0,1) draws; fold_data (any int array) decorrelates
    per-pixel/per-sample streams."""
    import jax

    key = jax.random.key(seed)
    if fold_data is not None:
        key = jax.random.fold_in(key, fold_data)
    return jax.random.uniform(key, shape, jnp.float32)


def threefry_per_lane(seed: int, lane_ids: jnp.ndarray, n_draws: int):
    """[len(lane_ids), n_draws] uniforms, one independent stream per lane."""
    import jax

    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(lane_ids)
    return jax.vmap(lambda k: jax.random.uniform(k, (n_draws,), jnp.float32))(keys)

"""Debug-mode validation: the JAX equivalent of the reference's device
asserts (``macros.hpp:5-23``: bounds-checked buffer access + ``asm("trap")``,
``assert_condition``, ``has_nan``/``has_inf`` payload guards).

XLA programs cannot trap mid-kernel, so the debug layer works differently:
* ``checked_gather`` -- bounds-audited indexing (debug: checkify error;
  release: clamp, matching jit's clamping semantics explicitly);
* ``assert_finite`` / ``assert_unit`` -- checkify assertions compiled in only
  when debug mode is on (zero cost otherwise);
* ``validate_scene`` -- host-side structural audit at scene-compile time
  (index ranges, normal lengths, material ranges) where the reference relied
  on device traps at render time.

Enable with OWLPT_DEBUG=1 or ``set_debug(True)``; render wrappers can then
run under ``checkify.checkify`` to surface the first failed assertion.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify

_DEBUG = os.environ.get("OWLPT_DEBUG", "0") == "1"


def set_debug(on: bool):
    global _DEBUG
    _DEBUG = bool(on)


def debug_enabled() -> bool:
    return _DEBUG


def checked_gather(table: jnp.ndarray, idx: jnp.ndarray, name: str = "buffer"):
    """get_data parity (macros.hpp:5-11): bounds-audited table[idx]."""
    n = table.shape[0]
    if _DEBUG:
        checkify.check(
            jnp.all((idx >= 0) & (idx < n)),
            f"index out of bounds in {name} (size {n})",
        )
    return table[jnp.clip(idx, 0, n - 1)]


def assert_finite(x: jnp.ndarray, name: str = "value"):
    """has_nan/has_inf parity (macros.hpp:19-23)."""
    if _DEBUG:
        checkify.check(jnp.all(jnp.isfinite(x)), f"non-finite {name}")
    return x


def assert_unit(v: jnp.ndarray, name: str = "direction", atol: float = 1e-3):
    if _DEBUG:
        n2 = jnp.sum(v * v, axis=-1)
        checkify.check(
            jnp.all(jnp.abs(n2 - 1.0) < atol), f"{name} not normalized"
        )
    return v


def checked_call(fn, *args):
    """Run ``fn`` under checkify and raise on the first failed assertion."""
    checked = checkify.checkify(jax.jit(fn))
    err, out = checked(*args)
    err.throw()
    return out


def validate_scene(scene) -> list:
    """Host-side scene audit; returns a list of problem strings (empty = ok).

    The reference discovers bad indices via device traps mid-render
    (macros.hpp); auditing at compile time catches the same class of bugs
    before a single ray is traced.
    """
    problems = []
    tri = np.asarray(scene.tri_idx)
    nv = len(np.asarray(scene.vertices))
    if tri.min() < 0 or tri.max() >= nv:
        problems.append(f"tri_idx out of range [0,{nv}): [{tri.min()},{tri.max()}]")
    tm = np.asarray(scene.tri_mat)
    nm = scene.materials.count
    if tm.min() < 0 or tm.max() >= nm:
        problems.append(f"tri_mat out of range [0,{nm})")
    nrm = np.asarray(scene.normals)
    lens = np.linalg.norm(nrm, axis=-1)
    frac_bad = float((np.abs(lens - 1) > 1e-2).mean())
    if frac_bad > 0.01:
        problems.append(f"{frac_bad:.1%} of normals not unit length")
    for field in ("roughness", "metallic", "specular_transmission"):
        v = np.asarray(getattr(scene.materials, field))
        if (v < 0).any() or (v > 1).any():
            problems.append(f"material {field} outside [0,1]")
    ior = np.asarray(scene.materials.ior)
    if (ior < 1.0).any():
        problems.append("material ior < 1")
    if not np.isfinite(np.asarray(scene.env_map)).all():
        problems.append("non-finite environment map")
    return problems

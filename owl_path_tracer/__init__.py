"""owl_path_tracer -- a differentiable wavefront path tracer in JAX.

A from-scratch JAX/Pallas rebuild of the capabilities of the CUDA/OptiX
reference ``jctemp/owl-path-tracer``: 5-lobe Disney BSDF, JSON/OBJ scene
pipeline, emissive + environment lighting, material parameter sweeps -- plus
the pieces the reference left dead or missing: live NEE/MIS, BVH construction
and traversal, end-to-end differentiability, progressive checkpointed
rendering, and multi-device sharding over a ``jax.sharding.Mesh``.
"""
import os
import pathlib

from .version import __version__  # noqa: F401

# Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset: a
# fixed path inside the checkout (gitignored), so every process of one
# checkout shares it and nothing outside the checkout is written.
DEFAULT_COMPILE_CACHE = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def _enable_compilation_cache():
    """Renders recompile in every process otherwise.  When the environment
    names a cache directory, JAX reads it itself and nothing is set here."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_COMPILE_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compilation_cache()

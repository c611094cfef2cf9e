"""Test configuration: run everything on a virtual 8-device CPU mesh.

Every test runs on the CPU with ``--xla_force_host_platform_device_count=8``
so the sharded (multi-device) code paths are exercised without a GPU, and
the Pallas kernel runs in its interpreter.  The platform is switched via
jax.config (backends initialize lazily, so this is still early enough) and
XLA_FLAGS is read at backend-init time.

Tests marked ``gpu`` need the card; they take the ``gpu`` fixture, which
skips them elsewhere.  On the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", False)

# Generated substitute assets (assets/generate.py) are gitignored; regenerate
# them on a fresh checkout so scene-loading tests are self-sufficient.
if not os.path.exists(os.path.join(REPO_ROOT, "assets", "sphere.obj.scene")):
    import subprocess

    subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "assets", "generate.py")],
        check=True,
        cwd=REPO_ROOT,
    )


# XLA:CPU's compiler has segfaulted once a single process accumulated ~170
# compiled graphs.  Dropping executables between modules keeps the
# live-graph count far below that; modules recompile their own graphs anyway.
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never at import, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")

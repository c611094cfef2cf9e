"""Installation-level pieces: compile-cache choice, the native library's
rebuild on source change, the stdlib PNG codec, and the measurement
scripts' refusal to run without a GPU."""
import os
import pathlib
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from owl_path_tracer.utils import image

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("env_dir", [None, "named"], ids=["unset", "set"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set (the package sets nothing);
    otherwise the cache is a fixed directory inside the checkout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c",
         "import owl_path_tracer, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True, timeout=120,
    ).stdout.strip().splitlines()[-1]
    want = str(tmp_path / env_dir) if env_dir else str(REPO / ".jax_cache")
    assert out == want


def test_native_rebuilds_on_source_change(tmp_path):
    """The library name carries a digest of the source: an edited bvh.cpp
    builds a new library (and drops the stale one) instead of loading it."""
    from owl_path_tracer import native

    src = tmp_path / "native"
    src.mkdir()
    for name in ("bvh.cpp", "Makefile"):
        shutil.copy(REPO / "owl_path_tracer" / "native" / name, src / name)
    first = native.build_library(src)
    assert first.exists() and native.build_library(src) == first  # no rebuild
    mtime = first.stat().st_mtime_ns
    with open(src / "bvh.cpp", "a") as f:
        f.write("\n// edited\n")
    second = native.build_library(src)
    assert second != first and second.exists() and not first.exists()
    assert native.library_path(src) == second
    assert native.build_library(src, force=True) == second
    assert second.stat().st_mtime_ns >= mtime


def test_png_rgba_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, (17, 23, 4), dtype=np.uint8)
    path = tmp_path / "x.png"
    image.write_png_rgba8(path, rgba)
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(image.read_png(path), rgba)


def _encode_rgb(rgb: np.ndarray, ftype: int) -> bytes:
    """Minimal independent PNG encoder (colour type 2) applying one filter
    type to every row -- exercises the reader's un-filtering."""
    h, w, _ = rgb.shape
    x = rgb.reshape(h, 3 * w).astype(np.int64)
    rows = []
    for y in range(h):
        prev = x[y - 1] if y else np.zeros(3 * w, np.int64)
        left = np.concatenate([np.zeros(3, np.int64), x[y, :-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([ftype]) + ((x[y] - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_png_reader_filters(tmp_path, ftype):
    rgb = np.random.default_rng(ftype).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_rgb(rgb, ftype))
    got = image.read_png(path)
    np.testing.assert_array_equal(got[..., :3], rgb)
    assert (got[..., 3] == 255).all()


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_measurement_scripts_refuse_cpu(script):
    """A measurement without a GPU fails and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(REPO / script)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"value"' not in proc.stdout
    assert "needs a GPU" in proc.stderr

"""ctypes bindings for the native C++ runtime pieces (BVH builder).

Builds ``libowlpt_native-<hash>.so`` with the in-tree Makefile on first use,
where ``<hash>`` is a digest of the C++ source and the Makefile: an edited
source builds a fresh library instead of loading a stale one (g++ is needed;
pybind11 is not, hence plain C ABI + ctypes).  Every entry point has a
pure-Python fallback (ops/bvh.py), so the package works without a toolchain
-- the native path is the performance route for dragon-class meshes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def library_path(src_dir: pathlib.Path = _DIR) -> pathlib.Path:
    """Path of the library built from the current source in ``src_dir``."""
    h = hashlib.sha256()
    for name in ("bvh.cpp", "Makefile"):
        h.update((src_dir / name).read_bytes())
    return src_dir / f"libowlpt_native-{h.hexdigest()[:16]}.so"


def build_library(src_dir: pathlib.Path = _DIR, force: bool = False) -> pathlib.Path:
    """Build the library for the current source unless it exists (or
    ``force``).  Builds under a temporary name and renames, so concurrent
    processes never load a half-written file; stale builds are removed."""
    path = library_path(src_dir)
    if path.exists() and not force:
        return path
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(
            ["make", "-B", "-C", str(src_dir), f"TARGET={tmp.name}"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, path)
    except Exception as e:  # no toolchain / build failure -> fallback path
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"native build failed: {e}") from e
    for old in src_dir.glob("libowlpt_native*.so"):
        if old != path and ".tmp." not in old.name:
            old.unlink(missing_ok=True)
    return path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.owlpt_build_bvh.restype = ctypes.c_int64
    lib.owlpt_build_bvh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.owlpt_extract_clusters.restype = ctypes.c_int64
    lib.owlpt_extract_clusters.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def native_build_bvh(vertices: np.ndarray, tri_idx: np.ndarray, max_leaf: int = 4):
    """C++ binned-SAH build -> FlatBVH (same contract as ops/bvh.build_bvh)."""
    from ..ops.bvh import FlatBVH

    lib = _load()
    v = np.ascontiguousarray(vertices, np.float32)
    t = np.ascontiguousarray(tri_idx, np.int32)
    n_tris = len(t)
    cap = 2 * n_tris
    nmin = np.empty((cap, 3), np.float32)
    nmax = np.empty((cap, 3), np.float32)
    na = np.empty(cap, np.int32)
    nb = np.empty(cap, np.int32)
    order = np.empty(n_tris, np.int32)
    n_nodes = lib.owlpt_build_bvh(
        _fptr(v), len(v), _iptr(t), n_tris, max_leaf,
        _fptr(nmin), _fptr(nmax), _iptr(na), _iptr(nb), _iptr(order),
    )
    if n_nodes < 0:
        raise NativeUnavailable("owlpt_build_bvh failed")
    return FlatBVH(
        node_min=nmin[:n_nodes].copy(),
        node_max=nmax[:n_nodes].copy(),
        node_a=na[:n_nodes].copy(),
        node_b=nb[:n_nodes].copy(),
        tri_order=order,
    )


def native_extract_clusters(vertices, tri_idx, bvh, cluster_size: int):
    """C++ leaf->cluster extraction (matches ops/cluster.build_clusters)."""
    lib = _load()
    v = np.ascontiguousarray(vertices, np.float32)
    t = np.ascontiguousarray(tri_idx, np.int32)
    nmin = np.ascontiguousarray(bvh.node_min, np.float32)
    nmax = np.ascontiguousarray(bvh.node_max, np.float32)
    na = np.ascontiguousarray(bvh.node_a, np.int32)
    nb = np.ascontiguousarray(bvh.node_b, np.int32)
    order = np.ascontiguousarray(bvh.tri_order, np.int32)
    k_max = int((nb < 0).sum())
    c = cluster_size
    cmin = np.empty((k_max, 3), np.float32)
    cmax = np.empty((k_max, 3), np.float32)
    blob = np.empty((k_max, 9 * c), np.float32)
    tid = np.empty((k_max, c), np.int32)
    k = lib.owlpt_extract_clusters(
        _fptr(v), _iptr(t), len(t), _fptr(nmin), _fptr(nmax), _iptr(na),
        _iptr(nb), len(na), _iptr(order), c, _fptr(cmin), _fptr(cmax),
        _fptr(blob), _iptr(tid),
    )
    if k < 0:
        raise NativeUnavailable("owlpt_extract_clusters failed")
    return cmin[:k], cmax[:k], blob[:k], tid[:k]

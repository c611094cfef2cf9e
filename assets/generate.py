"""Generate substitute assets for the reference's LFS-missing blobs.

The reference repo is missing ``sphere/dragon/mitsuba/car.obj.scene`` and
``environment.hdr`` (/root/reference/.MISSING_LARGE_BLOBS).  This script
procedurally generates stand-in meshes wired to the *same object names* the
scene JSONs expect (entity matching is by name, application.cpp:167-179), and
a procedural sky HDR, so every scene config loads and renders.

Run:  python assets/generate.py [--dragon-tris N]
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from owl_path_tracer.utils.obj import MeshData, save_obj  # noqa: E402
from owl_path_tracer.utils.image import write_hdr  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent


def uv_sphere(center, radius, n_theta=64, n_phi=128, name="sphere") -> MeshData:
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    n = np.stack(
        [np.sin(T) * np.cos(P), np.cos(T), np.sin(T) * np.sin(P)], axis=-1
    ).reshape(-1, 3)
    v = center + radius * n
    idx = []
    cols = n_phi

    def vid(i, j):
        return i * cols + (j % cols)

    for i in range(n_theta):
        for j in range(n_phi):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            if i > 0:
                idx.append((a, b, d))
            if i < n_theta - 1:
                idx.append((b, c, d))
    return MeshData(
        name=name,
        vertices=v.astype(np.float32),
        indices=np.asarray(idx, np.int32),
        normals=n.astype(np.float32),
        texcoords=np.zeros((len(v), 2), np.float32),
    )


def quad(p0, p1, p2, p3, name) -> MeshData:
    v = np.asarray([p0, p1, p2, p3], np.float32)
    n = np.cross(v[1] - v[0], v[3] - v[0])
    n = n / np.linalg.norm(n)
    return MeshData(
        name=name,
        vertices=v,
        indices=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.tile(n.astype(np.float32), (4, 1)),
        texcoords=np.zeros((4, 2), np.float32),
    )


def bumpy_blob(center, radius, n_sub, name, seed=0, bump=0.18) -> MeshData:
    """High-poly displaced icosphere -- the dragon-scale BVH stress stand-in."""
    t = (1 + 5**0.5) / 2
    verts = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(n_sub):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (verts[a] + verts[b]) / 2
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    # displacement: sum of a few random-frequency sinusoids -> organic blob
    rng = np.random.default_rng(seed)
    disp = np.zeros(len(verts))
    for _ in range(6):
        k = rng.normal(size=3) * 4.0
        phase = rng.uniform(0, 2 * np.pi)
        disp += np.sin(verts @ k + phase)
    r = 1.0 + bump * disp / 6.0
    v = verts * r[:, None]

    # vertex normals from faces
    p = v[faces]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    normals = np.zeros_like(v)
    for c in range(3):
        np.add.at(normals, faces[:, c], fn)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-20)

    v = center + radius * v
    return MeshData(
        name=name,
        vertices=v.astype(np.float32),
        indices=faces.astype(np.int32),
        normals=normals.astype(np.float32),
        texcoords=np.zeros((len(v), 2), np.float32),
    )


def gen_sphere_scene(path):
    # sphere.json: camera at (3,1,0) looking at (0,1,0); single 'sphere' material
    save_obj(path, [("sphere", uv_sphere(np.array([0, 1, 0.0]), 1.0))])


def gen_dragon_scene(path, n_sub=6):
    # dragon.json materials: dragon, ground, areaLight
    dragon = bumpy_blob(np.array([0, 1.0, 0.0]), 0.9, n_sub, "dragon")
    ground = quad([-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6], "ground")
    light = quad([-1.5, 4, -1.5], [-1.5, 4, 1.5], [1.5, 4, 1.5], [1.5, 4, -1.5], "areaLight")
    save_obj(path, [("dragon", dragon), ("ground", ground), ("areaLight", light)])


def gen_mitsuba_scene(path):
    # mitsuba.json materials: outside, ground, inside (the mitsuba knob)
    outside = bumpy_blob(np.array([0, 1.0, 0.0]), 0.8, 4, "outside", seed=3, bump=0.05)
    inside = uv_sphere(np.array([0, 1.0, 0.0]), 0.55, 48, 96, "inside")
    ground = quad([-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6], "ground")
    save_obj(path, [("outside", outside), ("ground", ground), ("inside", inside)])


def gen_car_scene(path):
    # car.json has 12 materials; build a toy car out of named primitives
    names = [
        "BodyGlossBlackMat", "BodyMat", "BodyMat_BK", "CarbonBlack", "Default",
        "EngineSilver2", "Ground", "Interior_Black", "Interior_Red", "Light",
        "TireMat", "WindowGlassMat",
    ]
    meshes = []
    rng = np.random.default_rng(11)
    for i, name in enumerate(names):
        if name == "Ground":
            meshes.append((name, quad([-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8], name)))
        elif name == "Light":
            meshes.append((name, quad([-1, 3.5, -1], [-1, 3.5, 1], [1, 3.5, 1], [1, 3.5, -1], name)))
        else:
            c = np.array([rng.uniform(-1.5, 1.5), rng.uniform(0.3, 1.2), rng.uniform(-1.5, 1.5)])
            meshes.append((name, uv_sphere(c, 0.3, 24, 48, name)))
    save_obj(path, meshes)


def gen_environment(path, h=512, w=1024):
    """Procedural sky: horizon-to-zenith gradient + a bright sun disk."""
    v = (np.arange(h) + 0.5) / h  # 0 bottom .. 1 top (lat-long v)
    u = (np.arange(w) + 0.5) / w
    V, U = np.meshgrid(v, u, indexing="ij")
    elev = (V - 0.5) * np.pi  # -pi/2..pi/2
    az = (U - 0.5) * 2 * np.pi
    sky_t = np.clip(np.sin(elev), 0, 1)[..., None]
    horizon = np.array([1.0, 0.95, 0.9])
    zenith = np.array([0.35, 0.55, 0.95])
    img = horizon * (1 - sky_t) + zenith * sky_t
    ground = np.array([0.25, 0.22, 0.2])
    img = np.where(np.sin(elev)[..., None] < 0, ground, img)
    # sun at elevation 45deg, azimuth 60deg
    sun_dir = np.array([np.cos(np.pi / 4) * np.sin(np.pi / 3), np.sin(np.pi / 4), np.cos(np.pi / 4) * np.cos(np.pi / 3)])
    d = np.stack([np.cos(elev) * np.sin(az), np.sin(elev), np.cos(elev) * np.cos(az)], axis=-1)
    cos_sun = d @ sun_dir
    img = img + np.where(cos_sun > 0.9995, 500.0, 0.0)[..., None]
    write_hdr(path, img.astype(np.float32))


def gen_cube_texture(path):
    """Checkerboard stand-in for the missing cube-textures/cube.png."""
    from owl_path_tracer.utils.image import write_png_rgba8

    path.parent.mkdir(exist_ok=True)
    n = 256
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    checker = ((xx // 32 + yy // 32) % 2).astype(np.float32)
    rgb = np.stack([0.2 + 0.6 * checker, 0.3 + 0.4 * checker, 0.8 - 0.5 * checker], -1)
    rgba = np.concatenate([(rgb * 255).astype(np.uint8), np.full((n, n, 1), 255, np.uint8)], -1)
    write_png_rgba8(path, rgba)


def ensure_assets(dragon_sub=6):
    """Idempotent generation used by tests/bench when assets are absent."""
    for name, fn in {
        "sphere.obj.scene": gen_sphere_scene,
        "dragon.obj.scene": lambda p: gen_dragon_scene(p, dragon_sub),
        "mitsuba.obj.scene": gen_mitsuba_scene,
        "car.obj.scene": gen_car_scene,
        "environment.hdr": gen_environment,
    }.items():
        p = HERE / name
        if not p.exists():
            fn(p)
    for tex in (HERE / "cube-textures" / "cube.png",
                HERE / "Ground-textures" / "uv-texture.png"):
        if not tex.exists():
            gen_cube_texture(tex)


def ensure_dragon(sub: int = 6) -> str:
    """Dragon stress scene at a given subdivision; returns the scene name.

    sub=6 (~82k tris) is the shared test asset ``dragon``; larger subs get
    their own scene name (``dragon7`` ~328k, ``dragon8`` ~1.3M) so the CPU
    test suite keeps the small mesh while the benchmark runs the honest
    north-star workload (BASELINE.md; thesis 1M-tri motivating workload,
    /root/reference/thesis/chapters/implementation.tex:49-63)."""
    ensure_assets()
    if sub <= 6:
        return "dragon"
    name = f"dragon{sub}"
    js = HERE / f"{name}.json"
    if not js.exists():
        js.write_text((HERE / "dragon.json").read_text())
    obj = HERE / f"{name}.obj.scene"
    if not obj.exists():
        gen_dragon_scene(obj, sub)
    return name


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dragon-sub", type=int, default=6, help="icosphere subdivisions (6 -> ~82k tris, 7 -> ~328k)")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    targets = {
        "sphere.obj.scene": lambda p: gen_sphere_scene(p),
        "dragon.obj.scene": lambda p: gen_dragon_scene(p, args.dragon_sub),
        "mitsuba.obj.scene": lambda p: gen_mitsuba_scene(p),
        "car.obj.scene": lambda p: gen_car_scene(p),
        "environment.hdr": lambda p: gen_environment(p),
    }
    for name, fn in targets.items():
        p = HERE / name
        if args.force or not p.exists():
            print(f"generating {p} ...")
            fn(p)
        else:
            print(f"exists {p}")
    tex = HERE / "cube-textures" / "cube.png"
    if args.force or not tex.exists():
        print(f"generating {tex} ...")
        gen_cube_texture(tex)


if __name__ == "__main__":
    main()

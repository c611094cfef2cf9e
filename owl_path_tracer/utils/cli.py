"""CLI driver + material parameter-sweep harness.

Behavioral replacement for the reference's driver stack (Main.cpp:13-31 +
test_loop, application.hpp:89-108 + modify_sbt, application.cpp:309-361):

* reads ``settings.json`` from the assets dir (same schema) and sweeps one
  material attribute from values[0] to values[1] in ``step_size`` steps;
* output naming parity: ``{scene}_{test}_{attr}({value}).png`` with the same
  ``{:.1f}`` value formatting (application.cpp:370, application.hpp:102-105);
* unlike the reference there are real flags (the reference compiled cxxopts
  out -- CMakeLists.txt:44): scene/spp/depth/size overrides, intersector
  choice, NEE toggle, checkpoint interval.

The sweep itself re-renders with a modified material table -- the analog of
the reference's material-buffer rebind (reset_field, application.cpp:297-304).
"""
from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np

from ..models.scene import RenderSettings, Scene, compile_scene
from ..render import film as film_mod
from .image import quantize_rgba8, write_png_rgba8
from .parser import MATERIAL_SCALAR_FIELDS, parse_materials, parse_settings


def set_material_attribute(scene: Scene, material_index: int, attribute: str, value) -> Scene:
    """Functional modify_sbt (application.cpp:309-361): returns a new Scene
    with one material attribute replaced."""
    import jax.numpy as jnp

    mats = scene.materials
    if attribute == "base_color":
        base = mats.base_color.at[material_index].set(jnp.asarray(value, jnp.float32))
        mats = mats._replace(base_color=base)
    elif attribute in MATERIAL_SCALAR_FIELDS:
        arr = getattr(mats, attribute).at[material_index].set(float(value))
        mats = mats._replace(**{attribute: arr})
    else:
        raise ValueError(f"unknown material attribute {attribute!r}")
    return scene._replace(materials=mats)


def sweep_values(values, step_size: float):
    """Reference loop: i = 0, step*100 .. 100; value = lerp(v0, v1, i/100)
    (application.hpp:93-98)."""
    v0, v1 = values[0], values[1]
    vstep = int(step_size * 100)
    out = []
    for i in range(0, 101, max(vstep, 1)):
        c = i / 100.0
        if isinstance(v0, (tuple, list)):
            out.append(tuple(a + (b - a) * c for a, b in zip(v0, v1)))
        else:
            out.append(v0 + (v1 - v0) * c)
    return out


def format_value(v) -> str:
    """{:.1f} formatting parity incl. vec3 join (application.hpp:102-105)."""
    if isinstance(v, (tuple, list)):
        return ",".join(f"{x:.1f}" for x in v)
    return f"{float(v):.1f}"


def run_sweep(args) -> list:
    assets = pathlib.Path(args.assets)
    settings_desc = parse_settings(assets / "settings.json")
    scene_name = args.scene or settings_desc.scene

    width, height = settings_desc.buffer_size
    if args.size:
        width = height = args.size
    spp = args.spp or settings_desc.max_samples
    depth = args.depth or settings_desc.max_path_depth

    rset = RenderSettings(
        width=width,
        height=height,
        max_samples=spp,
        max_path_depth=depth,
        environment_use=settings_desc.environment_use,
        environment_auto=settings_desc.environment_auto,
        environment_color=settings_desc.environment_color,
        environment_intensity=settings_desc.environment_intensity,
        use_nee=args.nee,
    )

    scene = compile_scene(assets, scene_name, (width, height))
    accel = film_mod.make_accel(scene, args.intersector, cluster_size=args.cluster_size)

    test = settings_desc.test
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    outputs = []
    if test is None or args.no_sweep:
        img = _render(scene, rset, args, accel)
        path = out_dir / f"{scene_name}.png"
        write_png_rgba8(path, quantize_rgba8(img))
        print(f"Image written to {path}")
        outputs.append(path)
        return outputs

    # locate the swept material by name (get_material, application.cpp:308-318)
    mat_descs = parse_materials(assets / f"{scene_name}.json")
    names = [d.name for d in mat_descs]
    if test.material_name not in names:
        # sweep block doesn't apply to this (overridden) scene: single frame
        print(f"note: sweep material {test.material_name!r} not in scene "
              f"{scene_name!r}; rendering a single frame instead")
        img = _render(scene, rset, args, accel)
        path = out_dir / f"{scene_name}.png"
        write_png_rgba8(path, quantize_rgba8(img))
        print(f"Image written to {path}")
        return [path]
    mat_index = names.index(test.material_name)

    values = test.vec_values if test.vec_values else test.flt_values
    attr = "base_color" if test.vec_values else test.attribute_name

    for value in sweep_values(values, test.step_size):
        print("TRACING")
        swept = set_material_attribute(scene, mat_index, attr, value)
        t0 = time.time()
        img = _render(swept, rset, args, accel)
        label = format_value(value)
        path = out_dir / f"{scene_name}_{test.name}_{test.attribute_name}({label}).png"
        write_png_rgba8(path, quantize_rgba8(img))
        print(f"Image written to {path}  [{time.time() - t0:.1f}s]")
        outputs.append(path)
    return outputs


def _render(scene, rset, args, accel):
    if args.renderer == "wavefront":
        from ..render.wavefront import render_image_wavefront

        ck = getattr(args, "checkpoint", None)
        img, _rays = render_image_wavefront(
            scene, rset, accel=accel, lanes=args.lanes,
            fused2_block=args.fused2_block,
            fused2_sort=getattr(args, "sort", False),
            checkpoint_path=ck,
            checkpoint_every_s=getattr(args, "checkpoint_every", 600.0),
            progress=ck is not None,
        )
        return img
    return film_mod.render_image(scene, rset, pixel_chunk=args.pixel_chunk, accel=accel)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="owlpt", description="Differentiable wavefront path tracer"
    )
    ap.add_argument("--assets", default="assets", help="assets directory (settings.json inside)")
    ap.add_argument("--scene", default=None, help="override scene name")
    ap.add_argument("--out", default="out", help="output directory")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--size", type=int, default=None, help="square buffer override")
    ap.add_argument(
        "--intersector",
        choices=["brute", "bvh", "cluster", "fused2"],
        default="fused2",
        help="fused2 = single-kernel Pallas-Triton traversal (the fastest on "
             "the GPU, PERF.md); cluster/bvh = plain XLA; brute = exact sweep",
    )
    ap.add_argument("--cluster-size", type=int, default=None,
                    help="tris per cluster (default: 128; scene-adaptive for fused2)")
    ap.add_argument("--pixel-chunk", type=int, default=65536)
    ap.add_argument(
        "--renderer", choices=["scan", "wavefront"], default="scan",
        help="wavefront = persistent-pool path regeneration (production/benchmark path)",
    )
    ap.add_argument("--lanes", type=int, default=131072,
                    help="wavefront pool size (lanes)")
    ap.add_argument("--fused2-block", type=int, default=None,
                    help="rays per fused2 kernel block (default ops/fused2.BLOCK_RAYS)")
    ap.add_argument("--nee", action="store_true", help="next-event estimation + MIS")
    ap.add_argument("--sort", action="store_true",
                    help="wavefront: per-wave coherence sort (scene-adaptive "
                         "morton/cid2 key; the benchmark/production default)")
    ap.add_argument("--checkpoint", default=None,
                    help="wavefront: crash-safe film checkpoint path -- the "
                         "render drains and snapshots periodically, and a "
                         "rerun with the same path resumes")
    ap.add_argument("--checkpoint-every", type=float, default=600.0,
                    help="seconds between checkpoints (default 600)")
    ap.add_argument("--no-sweep", action="store_true", help="single frame, ignore test block")
    args = ap.parse_args(argv)
    run_sweep(args)


if __name__ == "__main__":
    main()

"""Per-chip load balance of the sharded wavefront renderer (VERDICT r3 #7).

Measures ``load_balance`` (mean/max per-chip rays) on the virtual 8-device
CPU mesh at the BENCH scene (dragon7 -- concentrated geometry, the case the
round-3 cornell-box measurement did not cover), for both work splits:

  * contiguous -- round-3 behavior: per-chip bands of the (pixel,sample)
    queue; chips owning sky-only bands trace depth-1 paths while the
    dragon's chips trace full bounce trees;
  * sample     -- round-4: chip k renders samples [k*spp/n,(k+1)*spp/n) of
    EVERY pixel; identical pixel distribution per chip by construction.

Resolution is scaled down (the per-pixel work DISTRIBUTION, which determines
balance, is framing-determined, and a 1024^2 CPU render of the 327k-tri
dragon is hours); spp stays a multiple of 8.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python tools/measure_balance.py [--sub 7] [--size 256] [--spp 16]

Prints one JSON line per split; feed into SCALING_r04.json.
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "assets"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sub", type=int, default=7)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--lanes-per-chip", type=int, default=16384)
    ap.add_argument("--splits", default="contiguous,sample")
    args = ap.parse_args()

    import generate

    scene_name = generate.ensure_dragon(args.sub)

    from owl_path_tracer.models.scene import RenderSettings, compile_scene
    from owl_path_tracer.parallel import shard as shard_mod
    from owl_path_tracer.render import film as film_mod

    scene = compile_scene("assets", scene_name, (args.size, args.size))
    settings = RenderSettings(
        width=args.size, height=args.size, max_samples=args.spp,
        max_path_depth=args.depth, environment_auto=True,
        environment_intensity=1.0,
    )
    accel = film_mod.make_accel(scene, "cluster", cluster_size=256)
    mesh = shard_mod.make_pixel_mesh()

    for split in args.splits.split(","):
        t0 = time.time()
        _, rays, stats = shard_mod.render_image_wavefront_sharded(
            scene, settings, mesh=mesh, accel=accel,
            lanes_per_chip=args.lanes_per_chip, iters_per_launch=8,
            return_stats=True, work_split=split,
        )
        print(json.dumps({
            "probe": "load_balance", "split": split,
            "scene": scene_name, "size": args.size, "spp": args.spp,
            "devices": int(mesh.devices.size),
            "per_chip_rays": stats["per_chip_rays"],
            "load_balance": round(stats["load_balance"], 4),
            "wall_s": round(time.time() - t0, 1),
        }), flush=True)


if __name__ == "__main__":
    main()

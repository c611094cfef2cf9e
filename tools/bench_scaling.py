"""Multi-device scaling benchmark: rays/s at 1..N devices on the available
mesh (virtual CPU devices in tests; the GPUs of one host on the card).

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/bench_scaling.py --scene cornell-box --size 128 --spp 4

Prints one JSON line per device count with rays/s and parallel efficiency
(the >=80% 1->N target from BASELINE.json).
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell-box")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--cluster-size", type=int, default=None)
    ap.add_argument("--renderer", choices=["wavefront", "scan"], default="wavefront")
    ap.add_argument("--intersector", default="fused2")
    ap.add_argument("--lanes-per-chip", type=int, default=8192)
    args = ap.parse_args()

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "assets"))
    import generate

    generate.ensure_assets()

    import jax

    from owl_path_tracer.models.scene import RenderSettings, compile_scene
    from owl_path_tracer.parallel import shard as shard_mod
    from owl_path_tracer.render import film as film_mod

    devices = jax.devices()
    scene = compile_scene("assets", args.scene, (args.size, args.size))
    settings = RenderSettings(
        width=args.size, height=args.size, max_samples=args.spp,
        max_path_depth=args.depth, environment_auto=True, environment_intensity=1.0,
    )
    accel = film_mod.make_accel(scene, args.intersector, cluster_size=args.cluster_size)

    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    base_rate = None
    for n in counts:
        mesh = shard_mod.make_pixel_mesh(devices[:n])
        if args.renderer == "wavefront":
            # the PRODUCTION path: per-chip persistent wavefront pools
            render = lambda: shard_mod.render_image_wavefront_sharded(
                scene, settings, mesh=mesh, accel=accel,
                lanes_per_chip=args.lanes_per_chip, return_stats=True,
            )
            render()  # warm-up compile
            t0 = time.time()
            img, rays, stats = render()
            dt = time.time() - t0
            work = rays  # live rays counted on-device
        else:
            shard_mod.render_image_sharded(scene, settings, mesh=mesh, spp=1, accel=accel)
            t0 = time.time()
            img = shard_mod.render_image_sharded(scene, settings, mesh=mesh, accel=accel)
            dt = time.time() - t0
            work = args.size * args.size * args.spp  # paths (lower bound on rays)
        rate = work / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n)
        rec = {
            "devices": n,
            "seconds": round(dt, 3),
            ("rays_per_s" if args.renderer == "wavefront" else "paths_per_s"): round(rate),
            "efficiency_vs_1dev": round(eff, 3),
            "image_mean": round(float(img.mean()), 6),
        }
        if args.renderer == "wavefront":
            # on virtual CPU devices (shared host cores) wall-clock efficiency
            # is core-bound and meaningless; load_balance = mean/max per-chip
            # rays is the work-imbalance bound on real-chip scaling
            rec["load_balance"] = round(stats["load_balance"], 4)
            rec["per_chip_rays"] = stats["per_chip_rays"]
        print(json.dumps(rec))


if __name__ == "__main__":
    main()

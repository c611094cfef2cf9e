"""Benchmark: forward path-tracing throughput on one GPU.

Every stdout line is one JSON record; the LAST one is the headline:
  {"metric": ..., "value": N, "unit": "Mrays/s", "runs": [...],
   "spread": [min, max], "device": {...}}

``value`` is the median over ``--repeats`` timed frames of live rays traced
per second (primary + bounces actually alive at each wavefront step,
counted on-device), timed from the first launch until the float32 film is
on the host.  Each frame is rendered once untimed first (compilation).
The headline config is the dragon stress scene (``--dragon-sub 7``, ~327k
triangles), 1024x1024, spp 64, depth 4, through make_accel ->
render_image_wavefront.

A frozen secondary config (dragon sub-6 ~82k tris, 512^2, spp 4) is printed
first as a ``"trend"`` line; ``--no-trend`` skips it.  ``--intersectors``
times several traversals on the same frame in one process, one line each.

The benchmark refuses to run on anything but a GPU: a CPU number is not a
device measurement.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np

INTERSECTORS = ["fused2", "cluster", "bvh", "brute"]


def device_info() -> dict:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: needs a GPU, JAX found {dev.platform!r}")
    name, power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.splitlines()[0].split(", ")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "name": name, "power_limit": power}


def run_config(args, scene_name, size, spp, depth, intersector, nee=False):
    """Render one config: an untimed frame, then ``args.repeats`` timed ones.
    Returns (Mrays/s per timed frame, label)."""
    from owl_path_tracer.models.scene import RenderSettings, compile_scene
    from owl_path_tracer.render import film as film_mod

    scene = compile_scene("assets", scene_name, (size, size))
    settings = RenderSettings(
        width=size,
        height=size,
        max_samples=spp,
        max_path_depth=depth,
        environment_auto=not nee,
        environment_intensity=0.0 if nee else 1.0,
        environment_color=(0.0, 0.0, 0.0),
        use_nee=nee,
    )
    accel = film_mod.make_accel(scene, intersector, cluster_size=args.cluster_size)
    n_tris = int(scene.tri_idx.shape[0])

    if args.renderer == "wavefront":
        from owl_path_tracer.render.wavefront import render_image_wavefront

        kw = dict(
            accel=accel, lanes=args.lanes, fused2_block=args.fused2_block,
            fused2_sort=not args.no_sort, iters_per_launch=args.iters_per_launch,
        )

        def frame():
            return render_image_wavefront(scene, settings, **kw)[1]
    else:

        def frame():
            film = film_mod.add_samples(
                scene, settings, film_mod.new_film(settings), spp,
                pixel_chunk=args.pixel_chunk, accel=accel,
            )
            return film.rays_traced

    frame()  # compile with the identical static config
    rates = []
    for _ in range(args.repeats):
        t0 = time.time()
        rays = frame()
        rates.append(rays / (time.time() - t0) / 1e6)
    label = (
        f"{scene_name} {n_tris // 1000}k tris {size}^2 spp={spp} depth={depth}, "
        f"{intersector} intersector, {args.renderer}" + (", nee" if nee else "")
    )
    return rates, label


def record(metric, rates, device):
    return json.dumps({
        "metric": metric,
        "value": float(np.median(rates)),
        "unit": "Mrays/s",
        "runs": rates,
        "spread": [min(rates), max(rates)],
        "device": device,
    })


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="dragon")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument(
        "--dragon-sub", type=int, default=7,
        help="dragon icosphere subdivisions (6 ~82k tris, 7 ~328k, 8 ~1.3M)",
    )
    ap.add_argument("--cluster-size", type=int, default=None)
    ap.add_argument("--intersectors", nargs="+", choices=INTERSECTORS,
                    default=["fused2"],
                    help="traversals to time on the same frame (fused2 = the "
                         "Pallas-Triton kernel, the default)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed frames per config; the median is reported")
    ap.add_argument("--pixel-chunk", type=int, default=65536)
    ap.add_argument("--renderer", choices=["wavefront", "scan"], default="wavefront")
    ap.add_argument("--lanes", type=int, default=131072)
    ap.add_argument("--iters-per-launch", type=int, default=32)
    ap.add_argument("--fused2-block", type=int, default=None,
                    help="rays per fused2 kernel block (default ops/fused2.BLOCK_RAYS)")
    ap.add_argument("--no-sort", action="store_true",
                    help="disable the per-wave coherence sort")
    ap.add_argument("--nee", action="store_true",
                    help="NEE+MIS estimator (adds an any-hit shadow sweep); "
                         "the scene is lit by its emitters only")
    ap.add_argument("--no-trend", action="store_true",
                    help="skip the frozen secondary trend config")
    ap.add_argument("--quick", action="store_true", help="256^2, spp=2, sub=6 smoke config")
    args = ap.parse_args()
    if args.quick:
        args.size, args.spp, args.dragon_sub = 256, 2, 6
        args.no_trend = True

    device = device_info()

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "assets"))
    import generate

    scene_name = args.scene
    if args.scene == "dragon":
        scene_name = generate.ensure_dragon(args.dragon_sub)
    else:
        generate.ensure_assets()

    # frozen trend config: NEVER change these numbers (run-over-run line)
    if not args.no_trend and args.scene == "dragon":
        trend_scene = generate.ensure_dragon(6)
        rates, label = run_config(args, trend_scene, 512, 4, args.depth, "fused2")
        print(record(f"trend Mrays/s (frozen: {label})", rates, device), flush=True)

    for intersector in args.intersectors:
        rates, label = run_config(
            args, scene_name, args.size, args.spp, args.depth, intersector, nee=args.nee
        )
        print(record(f"fwd Mrays/s ({label})", rates, device), flush=True)


if __name__ == "__main__":
    main()

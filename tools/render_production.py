"""Render the reference's ACTUAL production artifact, checkpointed.

The reference program ships exactly one production configuration
(/root/reference/assets/settings.json:3-5): the car scene at 1080x1440,
max_samples=12288, max_path_depth=16, environment off.  Round 4 ran it at
spp=256 and projected the full frame; this tool renders the real thing in
crash-safe checkpointed segments (render/wavefront.py checkpoint_path) and
writes docs/gallery/car_production.png plus a JSON wall-clock record.

Usage:
  python tools/render_production.py                 # the full 12288-spp frame
  python tools/render_production.py --spp 256       # reduced-spp variant
  python tools/render_production.py --resume-only   # just report checkpoint %

Kill it at any time; rerunning resumes from docs/gallery/car_production.ck
(at most ~checkpoint-every seconds of work is repeated).
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
    ap.add_argument("--spp", type=int, default=12288)
    ap.add_argument(
        "--seg-spp", type=int, default=1024,
        help="spp per render segment: the (pixel x sample) work-id space is "
             "int32 on-device, so a 1080x1440x12288 frame (19.1G ids) runs "
             "as spp segments seeded with global sample_base offsets -- "
             "estimator-identical to one monolithic run",
    )
    ap.add_argument("--checkpoint-every", type=float, default=300.0)
    ap.add_argument("--lanes", type=int, default=131072)
    ap.add_argument("--resume-only", action="store_true")
    args = ap.parse_args()

    import generate

    generate.ensure_assets()

    from owl_path_tracer.models.scene import RenderSettings, compile_scene
    from owl_path_tracer.render import film as film_mod
    from owl_path_tracer.render.wavefront import render_image_wavefront
    from owl_path_tracer.utils.image import quantize_rgba8, write_png_rgba8
    from owl_path_tracer.utils.parser import parse_settings

    here = pathlib.Path(__file__).resolve().parents[1]
    ref = parse_settings(here / "assets" / "settings.json")
    w, h = ref.buffer_size
    spp = args.spp if args.spp else ref.max_samples
    out_dir = here / "docs" / "gallery"
    out_dir.mkdir(parents=True, exist_ok=True)
    acc_path = out_dir / f"car_production_spp{spp}_acc.npz"

    if args.resume_only:
        if acc_path.exists():
            d = np.load(acc_path)
            print(f"segments done: {int(d['spp_done'])}/{spp} spp")
        else:
            print("no accumulator")
        return

    # the reference production settings verbatim: environment OFF, light-quad
    # illumination only, no NEE (the reference integrator has none live)
    scene = compile_scene("assets", ref.scene, (w, h))
    accel = film_mod.make_accel(scene, "fused2")

    spp_done, rays_done, wall_done = 0, 0, 0.0
    img_sum = np.zeros((h, w, 3), np.float32)
    if acc_path.exists():
        d = np.load(acc_path)
        spp_done, rays_done = int(d["spp_done"]), int(d["rays"])
        wall_done = float(d["wall_s"])
        img_sum = d["img_sum"]
        print(f"[production] resuming after {spp_done}/{spp} spp", flush=True)

    t0 = time.time()
    base = spp_done
    while base < spp:
        k = min(args.seg_spp, spp - base)
        settings = RenderSettings(
            width=w, height=h, max_samples=k,
            max_path_depth=ref.max_path_depth,
            environment_use=ref.environment_use,
            environment_auto=ref.environment_auto,
            environment_color=ref.environment_color,
            environment_intensity=ref.environment_intensity,
        )
        ck = out_dir / f"car_production_spp{spp}_seg{base}.ck"
        ts = time.time()
        img_k, rays_k = render_image_wavefront(
            scene, settings, accel=accel, lanes=args.lanes, fused2_sort=True,
            checkpoint_path=str(ck), checkpoint_every_s=args.checkpoint_every,
            progress=True, sample_base=base,
        )
        img_sum = img_sum + np.asarray(img_k, np.float32) * k
        base += k
        spp_done, rays_done = base, rays_done + int(rays_k)
        wall_done += time.time() - ts
        tmp = str(acc_path) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, img_sum=img_sum, spp_done=spp_done, rays=rays_done,
                     wall_s=wall_done)
        import os

        os.replace(tmp, acc_path)
        if ck.exists():
            ck.unlink()
        print(f"[production] segment done: {spp_done}/{spp} spp, "
              f"{rays_done / 1e9:.2f}G rays, {wall_done:.0f}s", flush=True)

    img = img_sum / spp
    out = out_dir / f"car_production_spp{spp}.png"
    write_png_rgba8(out, quantize_rgba8(np.clip(img, 0, 1)))
    rec = {
        "metric": f"car production frame ({w}x{h} spp={spp} "
                  f"depth={ref.max_path_depth}, reference settings.json)",
        "wall_s_total": round(wall_done, 1),
        "rays_total": int(rays_done),
        "mrays_per_s": round(rays_done / wall_done / 1e6, 2),
        "png": str(out.relative_to(here)),
    }
    print(json.dumps(rec), flush=True)
    (out_dir / f"car_production_spp{spp}.json").write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()

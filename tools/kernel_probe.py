"""Time the fused2 kernel against the plain-XLA cluster intersector on one
real wave of the headline scene (GPU only).

One 131,072-ray dragon7 wave of primary rays from the middle of the frame
and the first-bounce wave they spawn; each timing is the median of 5 calls
after a compile call.  Prints one JSON object.

    python tools/kernel_probe.py                       # default kernel config
    python tools/kernel_probe.py --blocks 32 64 --cluster-sizes 128 256
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "assets"))

import numpy as np  # noqa: E402


def median_ms(fn, *args, n=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, nargs="+", default=None)
    ap.add_argument("--cluster-sizes", type=int, nargs="+", default=None)
    ap.add_argument("--lanes", type=int, default=131072)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_probe: needs a GPU")
    import chip_smoke

    from owl_path_tracer.ops import cluster as cl
    from owl_path_tracer.ops import fused2 as f2
    from owl_path_tracer.render import film

    scene, settings = chip_smoke.headline_scene()
    cb = film.make_accel(scene, "cluster")
    waves = chip_smoke.real_waves(scene, settings, film.make_accel(scene, "fused2"), args.lanes)
    tmax = jnp.full((args.lanes,), 5.0, jnp.float32)
    res = {"device": jax.devices()[0].device_kind, "card": chip_smoke.card_line()}
    for label, (o, d) in waves.items():
        res[f"cluster_{label}_ms"] = median_ms(
            jax.jit(lambda a, b: cl.cluster_closest_hit(a, b, cb).t), o, d)
        res[f"cluster_occluded_{label}_ms"] = median_ms(
            jax.jit(lambda a, b: cl.cluster_occluded(a, b, cb, t_max=tmax)), o, d)
        for c in args.cluster_sizes or [None]:
            fb = film.make_accel(scene, "fused2", cluster_size=c)
            ref = np.asarray(cl.cluster_closest_hit(o, d, fb.cluster).tri)
            for b in args.blocks or [f2.BLOCK_RAYS]:
                key = f"fused2_{label}_C{fb.cluster_size}_B{b}"
                closest = lambda r, fb=fb, b=b: f2.sweep(
                    r, fb, block=b, max_steps=f2.MAX_STEPS, with_attrs=True,
                    any_hit=False, interpret=False)
                any_hit = lambda r, fb=fb, b=b: f2.sweep(
                    r, fb, block=b, max_steps=f2.MAX_STEPS, with_attrs=False,
                    any_hit=True, interpret=False)
                rays = f2.pack_rays(o, d, 1e10)
                out = np.asarray(closest(rays))
                res[key] = dict(
                    ms=median_ms(closest, rays),
                    any_hit_ms=median_ms(any_hit, f2.pack_rays(o, d, tmax)),
                    tri_agree_cluster=float((out[3].astype(np.int64) == ref).mean()),
                    unresolved=float((out[5] == 0).mean()),
                    clusters_per_block=float(out[6].mean()),
                )
                print(key, res[key], flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()

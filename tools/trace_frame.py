"""Profile one frame through the main path and reduce the device trace
(GPU only): device busy time, idle share over the traced span, and the
device time of each kernel name, largest first.

    python tools/trace_frame.py                 # dragon7 1024^2 spp 4, fused2
    python tools/trace_frame.py --spp 64 --intersector cluster

The trace is written under ``--out`` (default chiprun_out/trace) and can be
large; the reduction printed here is what PERF.md quotes.
"""
import argparse
import collections
import dataclasses
import glob
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "assets"))


def device_time(xplane_path, top=25):
    """(span_ns, busy_ns, {event name: summed device ns}) of GPU 0."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    for plane in pd.planes:
        if "/device:GPU:0" not in plane.name:
            continue
        by_name = collections.Counter()
        intervals = []
        for line in plane.lines:
            for ev in line.events:
                by_name[ev.name] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        intervals.sort()
        busy, cur = 0, None
        for a, b in intervals:
            if cur is None or a > cur[1]:
                busy += cur[1] - cur[0] if cur else 0
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
        busy += cur[1] - cur[0] if cur else 0
        span = intervals[-1][1] - intervals[0][0] if intervals else 0
        return span, busy, by_name
    raise RuntimeError(f"no GPU plane in {xplane_path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--intersector", default="fused2")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "trace"))
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("trace_frame: needs a GPU")
    import chip_smoke

    from owl_path_tracer.render import film
    from owl_path_tracer.render.wavefront import render_image_wavefront

    scene, settings = chip_smoke.headline_scene()
    settings = dataclasses.replace(settings, max_samples=args.spp)
    accel = film.make_accel(scene, args.intersector)
    render_image_wavefront(scene, settings, accel=accel, fused2_sort=True)  # compile
    t0 = time.time()
    with jax.profiler.trace(args.out):
        _, rays = render_image_wavefront(scene, settings, accel=accel, fused2_sort=True)
    wall = time.time() - t0
    path = sorted(glob.glob(f"{args.out}/**/*.xplane.pb", recursive=True))[-1]
    span, busy, by_name = device_time(path)
    total = sum(by_name.values())
    print(f"card: {chip_smoke.card_line()}")
    print(f"wall {wall:.3f} s (traced), rays {rays}, device span {span / 1e9:.3f} s, "
          f"busy {busy / 1e9:.3f} s, idle share {1 - busy / span:.4f}")
    for name, ns in by_name.most_common(25):
        print(f"{ns / 1e6:10.2f} ms {100 * ns / total:6.2f}%  {name[:120]}")


if __name__ == "__main__":
    main()

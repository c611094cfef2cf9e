"""End-to-end smoke run of the path tracer on one GPU (or four, with
``--multichip 4``).

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --multichip 4 # only the four-card phases

Phases on one card:
  (a) the card (name, power limit), JAX version and XLA_FLAGS;
  (b) build the native BVH library from source;
  (c) the fused2 traversal kernel, compiled for the card, at the headline
      scene's full scale (dragon7, ~327k triangles) on a primary wave and a
      first-bounce wave, against the plain XLA cluster intersector on every
      ray and the brute-force intersector on 65,536 rays;
  (d) the three golden configs rendered on the card vs tests/goldens;
  (e) the headline frame (dragon7, 1024^2, spp 64, depth 4) through
      make_accel -> render_image_wavefront;
  (f) cornell-box with NEE at 1024^2 (reduced spp);
  (g) one material-recovery step (forward + backward) through fused2.

The last line of standard output is the JSON result; it is printed only
when every phase passed.  Without a GPU the script exits non-zero at once.
"""
import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "assets"))

import numpy as np  # noqa: E402

HEADLINE = dict(size=1024, spp=64, depth=4, dragon_sub=7)
LANES = 131072
# Agreement bars of the kernel against the plain references: winners may
# differ only at near-ties, where FMA contraction (which differs between the
# card's compiler and the CPU's) decides.
MIN_TRI_AGREE = 0.9999
MIN_OCC_AGREE = 0.9999
T_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    """A failed phase ends the run (not an ``assert``: those vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}")
    return jax


def phase_native():
    from owl_path_tracer import native

    t0 = time.time()
    path = native.build_library(force=True)
    native._load()
    log(f"(b) native BVH library built from source in {time.time() - t0:.2f} s: {path.name}")


def headline_scene():
    import generate

    from owl_path_tracer.models.scene import RenderSettings, compile_scene

    name = generate.ensure_dragon(HEADLINE["dragon_sub"])
    size = HEADLINE["size"]
    scene = compile_scene(ROOT / "assets", name, (size, size))
    settings = RenderSettings(
        width=size, height=size, max_samples=HEADLINE["spp"],
        max_path_depth=HEADLINE["depth"], environment_auto=True,
        environment_intensity=1.0,
    )
    return scene, settings


def real_waves(scene, settings, fb, lanes=LANES):
    """A mid-frame wave of primary rays and the first-bounce wave it spawns
    (dead lanes parked outside the scene, as the renderer does)."""
    import jax
    import jax.numpy as jnp

    from owl_path_tracer.ops import disney
    from owl_path_tracer.render import integrator
    from owl_path_tracer.render import wavefront as wf

    total = settings.width * settings.height * settings.max_samples
    ids = jnp.arange(lanes, dtype=jnp.int32) + total // 2
    _, o, d, rng = jax.jit(lambda i: wf._spawn(scene, settings, i, total))(ids)
    ps = integrator.PathState(
        ray_o=o, ray_d=d, result=jnp.zeros((lanes, 3)), throughput=jnp.ones((lanes, 3)),
        rng=rng, alive=jnp.ones((lanes,), bool),
        prev_lobe=jnp.full((lanes,), disney.LOBE_NONE, jnp.int32),
        depth=jnp.zeros((lanes,), jnp.int32), prev_pdf=jnp.zeros((lanes,)),
    )
    isect, _ = integrator.make_intersectors(scene, fb)
    ps2 = jax.jit(lambda p: integrator.trace_bounce(scene, settings, p, isect, False))(ps)
    return {
        "primary": (o, d),
        "bounce": (jnp.where(ps2.alive[:, None], ps2.ray_o, 1e8), ps2.ray_d),
    }


def phase_kernel(scene, settings, fb):
    """Kernel vs plain references on a real primary and first-bounce wave."""
    import jax.numpy as jnp

    from owl_path_tracer.ops import cluster as cl
    from owl_path_tracer.ops import fused2 as f2
    from owl_path_tracer.ops.intersect import closest_hit_brute

    check(not f2.interpret_mode(), "the kernel would run in the interpreter")
    waves = real_waves(scene, settings, fb)
    for label, (wo, wd) in waves.items():
        rec, _ = f2.fused2_closest_hit(wo, wd, fb)
        ref = cl.cluster_closest_hit(wo, wd, fb.cluster)
        tri, rtri = np.asarray(rec.tri), np.asarray(ref.tri)
        same = tri == rtri
        hit = same & (rtri >= 0)
        t_ok = np.isclose(np.asarray(rec.t)[hit], np.asarray(ref.t)[hit], rtol=T_RTOL, atol=0)
        # per-ray shadow distances spanning near and far occluders
        tmax = jnp.asarray(np.random.default_rng(0).uniform(0.05, 20.0, LANES), jnp.float32)
        occ = np.asarray(f2.fused2_occluded(wo, wd, fb, t_max=tmax))
        occ_ref = np.asarray(cl.cluster_occluded(wo, wd, fb.cluster, t_max=tmax))
        nb = 32768  # per wave: 65,536 rays over both waves
        brute = closest_hit_brute(wo[:nb], wd[:nb], scene.vertices, scene.tri_idx, tri_chunk=2048)
        bsame = tri[:nb] == np.asarray(brute.tri)
        shares = dict(
            rays=LANES, hit_share=float((rtri >= 0).mean()),
            tri_agree_cluster=float(same.mean()), t_within_rtol=float(t_ok.mean()),
            occ_agree_cluster=float((occ == occ_ref).mean()), occluded_share=float(occ.mean()),
            tri_agree_brute=float(bsame.mean()),
        )
        log(f"(c) kernel {label} wave: {json.dumps(shares)}")
        check(shares["tri_agree_cluster"] >= MIN_TRI_AGREE, shares)
        check(shares["tri_agree_brute"] >= MIN_TRI_AGREE, shares)
        check(shares["t_within_rtol"] == 1.0, shares)
        check(shares["occ_agree_cluster"] >= MIN_OCC_AGREE, shares)


def phase_goldens():
    """tests/test_golden.py's fused2 criterion, on the card."""
    import generate

    from owl_path_tracer.models.scene import compile_scene
    from owl_path_tracer.render import film as film_mod

    sys.path.insert(0, str(ROOT / "tests"))
    from test_golden import CONFIGS

    generate.ensure_assets()
    for name, (scene_name, settings) in CONFIGS.items():
        scene = compile_scene(ROOT / "assets", scene_name, (settings.width, settings.height))
        accel = film_mod.make_accel(scene, "fused2", cluster_size=64)
        img = film_mod.render_image(scene, settings, pixel_chunk=4096, accel=accel)
        golden = np.load(ROOT / "tests" / "goldens" / f"{name}.npy")
        share = float(np.isclose(img, golden, rtol=1e-4, atol=1e-5).mean())
        mean_rel = float(abs(img.mean() - golden.mean()) / golden.mean())
        log(f"(d) golden {name}: match share {share:.6f}, mean rel diff {mean_rel:.2e}")
        check(np.isfinite(img).all() and share > 0.995 and mean_rel < 1e-3, name)


def run_frame(scene, settings, accel, label, **kw):
    """Render one frame twice (compile, then timed) through the main path."""
    from owl_path_tracer.render.wavefront import render_image_wavefront

    t0 = time.time()
    render_image_wavefront(scene, settings, accel=accel, lanes=LANES, **kw)
    first = time.time() - t0
    t0 = time.time()
    img, rays = render_image_wavefront(scene, settings, accel=accel, lanes=LANES, **kw)
    dt = time.time() - t0
    check(np.isfinite(img).all() and rays > 0, label)
    log(f"{label}: {rays} rays in {dt:.3f} s = {rays / dt / 1e6:.3f} Mrays/s "
        f"(first frame incl. compile {first:.1f} s), image mean {float(img.mean()):.5f}")
    return img


def phase_headline(scene, settings, fb):
    import jax
    import jax.numpy as jnp

    from owl_path_tracer.ops.fused2 import auto_sort_mode
    from owl_path_tracer.render import wavefront as wf

    # memory analysis of one compiled launch of the frame's step loop
    st = wf.new_pool(settings, LANES)
    t0 = time.time()
    compiled = wf._run_chunk.lower(
        scene, settings, st, fb, False, jnp.int32(1), 32, None, None,
        fused2_sort=auto_sort_mode(scene), sample_base=jnp.uint32(0),
    ).compile()
    log(f"(e) compile of one 32-step launch: {time.time() - t0:.1f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")
    run_frame(scene, settings, fb, "(e) headline dragon7 1024^2 spp64 depth4", fused2_sort=True)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"(e) peak device bytes in use: {stats.get('peak_bytes_in_use')}")


def phase_cornell_nee():
    import generate

    from owl_path_tracer.models.scene import RenderSettings, compile_scene
    from owl_path_tracer.render import film as film_mod

    generate.ensure_assets()
    settings = RenderSettings(
        width=1024, height=1024, max_samples=8, max_path_depth=4,
        environment_color=(0, 0, 0), environment_intensity=0.0, use_nee=True,
    )
    scene = compile_scene(ROOT / "assets", "cornell-box", (1024, 1024))
    accel = film_mod.make_accel(scene, "fused2")
    img = run_frame(scene, settings, accel, "(f) cornell-box NEE 1024^2 spp8 depth4", fused2_sort=True)
    check(img.mean() > 0.0, "cornell NEE image is black")


def phase_diff_step():
    import jax.numpy as jnp

    from owl_path_tracer.render import diff as diff_mod
    from owl_path_tracer.render import film as film_mod

    sys.path.insert(0, str(ROOT / "tests"))
    from test_diff import SETTINGS, diffuse_sphere_scene, pixel_grid

    scene = diffuse_sphere_scene()
    accel = film_mod.make_accel(scene, "fused2")
    px = pixel_grid()
    target = diff_mod.render_with_materials(scene, scene.materials, SETTINGS, px, 8, accel)
    init = scene.materials._replace(base_color=jnp.full_like(scene.materials.base_color, 0.3))
    t0 = time.time()
    res = diff_mod.recover_materials(scene, SETTINGS, target, px, init, steps=2,
                                     num_samples=8, accel=accel)
    losses = [float(x) for x in res.losses]
    log(f"(g) material recovery through fused2: losses {losses} ({time.time() - t0:.1f} s "
        f"incl. compile)")
    check(np.isfinite(losses).all() and losses[1] < losses[0], losses)


def phase_multichip(n):
    """Sample-split sharded frame and sharded gradient vs one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from owl_path_tracer.ops import rng as rng_mod
    from owl_path_tracer.parallel import shard as shard_mod
    from owl_path_tracer.render import film as film_mod
    from owl_path_tracer.render.wavefront import render_image_wavefront

    devs = jax.devices()
    check(len(devs) >= n, f"need {n} devices, have {len(devs)}")
    scene, settings = headline_scene()
    settings = dataclasses.replace(settings, width=256, height=256, max_samples=16)
    fb = film_mod.make_accel(scene, "fused2")
    mesh = shard_mod.make_pixel_mesh(devs[:n])
    t0 = time.time()
    img_n, rays_n = shard_mod.render_image_wavefront_sharded(
        scene, settings, mesh=mesh, accel=fb, lanes_per_chip=32768,
        iters_per_launch=16, work_split="sample",
    )
    log(f"(m) {n}-card sample-split frame: {rays_n} rays, {time.time() - t0:.1f} s incl. compile")
    img_1, rays_1 = render_image_wavefront(scene, settings, accel=fb, lanes=32768, iters_per_launch=16)
    diff = float(np.abs(img_n - img_1).max())
    log(f"(m) {n}-card vs 1-card image: max abs diff {diff:.3e}, rays {rays_n} vs {rays_1}")
    check(np.isfinite(img_n).all() and rays_n == rays_1, (rays_n, rays_1))
    np.testing.assert_allclose(img_n, img_1, rtol=1e-4, atol=1e-5)

    sys.path.insert(0, str(ROOT / "tests"))
    from test_diff import SETTINGS, diffuse_sphere_scene

    dscene = diffuse_sphere_scene()
    dacc = film_mod.make_accel(dscene, "fused2")
    px = film_mod._pixel_grid(SETTINGS.width, SETTINGS.height)
    st = np.asarray(rng_mod.seed(jnp.asarray(px[:, 0]), jnp.asarray(px[:, 1])))
    target = np.full((px.shape[0], 3), 0.2, np.float32)
    out = {}
    for k in (1, n):
        m = shard_mod.make_pixel_mesh(devs[:k])
        step = shard_mod.sharded_loss_and_grad(m, dscene, SETTINGS, dacc, num_samples=4)
        sh = NamedSharding(m, P("px"))
        loss, grads = step(dscene.materials, *(jax.device_put(jnp.asarray(x), sh) for x in (px, st, target)))
        out[k] = (float(loss), np.asarray(grads.base_color))
    log(f"(m) sharded loss/grad: 1 card {out[1][0]:.6e}, {n} cards {out[n][0]:.6e}, "
        f"max |dgrad| {float(np.abs(out[1][1] - out[n][1]).max()):.3e}")
    np.testing.assert_allclose(out[n][0], out[1][0], rtol=1e-5)
    np.testing.assert_allclose(out[n][1], out[1][1], rtol=1e-4, atol=1e-7)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", type=int, default=0,
                    help="run only the sharded phases on this many cards")
    args = ap.parse_args()

    jax = require_gpu()
    card = card_line()
    log(f"(a) card: {card}")
    log(f"(a) jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    if args.multichip:
        phase_multichip(args.multichip)
    else:
        phase_native()
        from owl_path_tracer.render import film as film_mod

        scene, settings = headline_scene()
        fb = film_mod.make_accel(scene, "fused2")
        phase_kernel(scene, settings, fb)
        phase_goldens()
        phase_headline(scene, settings, fb)
        phase_cornell_nee()
        phase_diff_step()
    dev = jax.devices()[0]
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()

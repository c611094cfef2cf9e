"""Generate the committed golden images (tests/goldens/*.npy).

Run on CPU (the goldens are backend-independent: all intersectors reproduce
them bitwise except fused2's o+t*d hit position, asserted with a tolerance):

  env JAX_PLATFORMS=cpu python tools/make_goldens.py
"""
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "assets"))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import generate

generate.ensure_assets()

from owl_path_tracer.models.scene import compile_scene
from owl_path_tracer.render import film as film_mod

sys.path.insert(0, str(REPO / "tests"))
from test_golden import CONFIGS  # noqa: E402

out_dir = REPO / "tests" / "goldens"
out_dir.mkdir(exist_ok=True)
for name, (scene_name, settings) in CONFIGS.items():
    scene = compile_scene(REPO / "assets", scene_name, (settings.width, settings.height))
    img = film_mod.render_image(scene, settings, pixel_chunk=4096, accel=None)
    np.save(out_dir / f"{name}.npy", img.astype(np.float32))
    print(f"{name}: mean={img.mean():.6f} max={img.max():.3f} -> {out_dir}/{name}.npy")

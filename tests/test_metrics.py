"""Observability tests."""
import numpy as np
import jax.numpy as jnp

from owl_path_tracer.render import metrics as metrics_mod
from owl_path_tracer.render import integrator, film as film_mod
from owl_path_tracer.models.scene import RenderSettings
from test_integrator import sphere_scene
from owl_path_tracer.models import material as material_mod


def test_wavefront_stats_occupancy_decays():
    scene = sphere_scene(material_mod.single(roughness=1.0))
    s = RenderSettings(width=16, height=16, max_samples=1, max_path_depth=5,
                       environment_color=(1, 1, 1), environment_intensity=1.0)
    px = film_mod._pixel_grid(16, 16)
    stats = metrics_mod.wavefront_stats(
        scene, s, jnp.asarray(px), integrator.make_brute_intersector(scene)
    )
    assert stats.live_per_bounce[0] == 256  # all primary rays live
    # convex sphere in an env: everything terminates within 2 bounces
    assert stats.live_per_bounce[2] == 0
    assert 1.0 <= stats.mean_path_length <= 2.0
    assert "occupancy" in stats.to_json()


def test_grad_norms():
    m = material_mod.single()
    norms = metrics_mod.grad_norms(m)
    assert set(norms) == set(material_mod.Materials._fields)
    assert norms["roughness"] == 0.5

"""Furnace tests vs the REFERENCE'S OWN rendered ground truth.

The thesis ships per-lobe white-furnace renders
(/root/reference/thesis/assets/furnace-test/furnace_test_*.png, 1024^2,
white-sphere-in-unit-white-environment) -- the reference's de-facto energy
conservation record (SURVEY.md section 4 item 3).  The exact camera used is
not recorded anywhere in the reference, so per-pixel alignment is impossible;
what IS alignment-independent is the radiance in the central disk of the
(centered) sphere: both renders have the sphere centered and far larger than
the disk we average over, so the comparison only assumes "sphere centered",
not any specific framing.

Measured reference values (center 200^2 of 1024^2, linear, no gamma --
the reference stores make_rgba without gamma, device.cu:248):

    diffuse            r=0.0 -> 0.978     r=1.0 -> 1.000
    metallic           r=0.0 -> 1.000
    metallic ndf       r=1.0 -> 0.180    (parity: NDF sampler, device.cu:157)
    metallic vndf      r=1.0 -> 0.216    (corrected: VNDF + matching pdf)
    spec transmission  r=0.0 -> 1.000
    coupled trans      r=1.0 -> 0.421    uncoupled trans r=1.0 -> 1.000

The shipped reference code matches the "uncoupled" image: its Walter-NDF
glass divides by the full microfacet pdf in BOTH the R and T branches without
coupling the Fresnel split into the pdf (disney_specular.cuh:216-243), which
white-furnaces to ~1.  Parity mode must land on that one.
"""
import pathlib

import numpy as np
import pytest

from owl_path_tracer.models import material as material_mod
from owl_path_tracer.models.scene import RenderSettings
from owl_path_tracer.render import film as film_mod

from test_integrator import sphere_scene

REF_DIR = pathlib.Path("/root/reference/thesis/assets/furnace-test")

SIZE = 32
DISK = 6  # half-width of the center window (pixels)


def ref_center(name: str) -> float:
    """Mean linear radiance over the central window of a reference PNG."""
    from owl_path_tracer.utils.image import read_png

    im = np.asarray(
        read_png(REF_DIR / f"{name}.png")[..., :3], dtype=np.float32
    ) / 255.0
    h, w, _ = im.shape
    ch, cw = h // 2, w // 2
    r = int(DISK / SIZE * h)  # same fractional window as ours
    return float(im[ch - r : ch + r, cw - r : cw + r].mean())


def our_center(mat, parity: bool, depth: int = 3, spp: int = 24) -> float:
    scene = sphere_scene(mat)
    s = RenderSettings(
        width=SIZE, height=SIZE, max_samples=spp, max_path_depth=depth,
        environment_color=(1, 1, 1), environment_intensity=1.0, parity=parity,
    )
    img = film_mod.render_image(scene, s, pixel_chunk=1024)
    # quantize exactly like the reference PNGs were stored (make_rgba, no gamma)
    from owl_path_tracer.utils.image import quantize_rgba8

    q = quantize_rgba8(img)[..., :3].astype(np.float32) / 255.0
    c = SIZE // 2
    return float(q[c - DISK : c + DISK, c - DISK : c + DISK].mean())


CASES = [
    # (ref image, material kwargs, parity, depth, tolerance)
    ("furnace_test_diffuse_roughness(0.0)",
     dict(base_color=(1, 1, 1), roughness=0.0, specular=0.0), True, 3, 0.03),
    ("furnace_test_diffuse_roughness(1.0)",
     dict(base_color=(1, 1, 1), roughness=1.0, specular=0.0), True, 3, 0.03),
    ("furnace_test_metallic_roughness(0.0)",
     dict(base_color=(1, 1, 1), metallic=1.0, roughness=0.0), True, 3, 0.03),
    ("furnace_test_metallic_ndf_roughness(1.0)",
     dict(base_color=(1, 1, 1), metallic=1.0, roughness=1.0), True, 3, 0.06),
    ("furnace_test_metallic_vndf_roughness(1.0)",
     dict(base_color=(1, 1, 1), metallic=1.0, roughness=1.0), False, 3, 0.06),
    ("furnace_test_specular_transmission_roughness(0.0)",
     dict(base_color=(1, 1, 1), specular_transmission=1.0, roughness=0.0,
          specular_transmission_roughness=0.0, ior=1.5), True, 10, 0.04),
    # "uncoupled"/"coupled" are two EXPERIMENTAL builds: uncoupled = both
    # glass half-vector draws from specular_transmission_roughness (stays 0
    # during the roughness sweep -> lossless white furnace), coupled = both
    # from roughness (-> 0.42).  The SHIPPED code is a hybrid -- transmission
    # wh from st-roughness (disney_specular.cuh:226) but the Fresnel-reflect
    # branch from roughness (:237) -- so its furnace sits just below the
    # uncoupled image: ~4.5% of energy enters the rough-reflect branch and
    # partially dies below the horizon (measured 0.955 vs 1.000).  We assert
    # against the closest image with that residual folded into the tolerance.
    ("furnace_test_uncoupled_specular_transmission_roughness(1.0)",
     dict(base_color=(1, 1, 1), specular_transmission=1.0, roughness=1.0,
          specular_transmission_roughness=0.0, ior=1.5), True, 10, 0.06),
]


@pytest.mark.skipif(not REF_DIR.exists(), reason="reference thesis assets absent")
@pytest.mark.parametrize("ref_name,mat_kw,parity,depth,tol", CASES,
                         ids=[c[0].replace("furnace_test_", "") for c in CASES])
def test_furnace_matches_reference_render(ref_name, mat_kw, parity, depth, tol):
    ref = ref_center(ref_name)
    ours = our_center(material_mod.single(**mat_kw), parity, depth=depth)
    assert abs(ours - ref) <= tol, (ref_name, ref, ours)

"""Multi-process (jax.distributed) smoke test on CPU.

The reference is single-process/single-GPU (application.cpp:62); this build
scales over hosts via ``jax.distributed`` + a global mesh.  This test launches
TWO separate python processes that initialize a distributed runtime, build a
2-device global mesh (1 CPU device per process), and run (a) a psum
all-reduce and (b) one shard_map'd wavefront render step over
process-local shards -- the multi-host pattern from BASELINE.md.
"""
import os
import subprocess
import sys

import pytest

WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["OWLPT_REPO"])
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address="127.0.0.1:%s" % os.environ["OWLPT_PORT"],
    num_processes=2,
    process_id=int(os.environ["OWLPT_PID"]),
)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

assert jax.process_count() == 2, jax.process_count()
devs = jax.devices()  # global: one cpu device per process
assert len(devs) == 2, devs
mesh = Mesh(np.asarray(devs), ("px",))

# (a) cross-process psum
local = jnp.asarray([float(jax.process_index() + 1)])
garr = jax.make_array_from_process_local_data(NamedSharding(mesh, P("px")), local)
total = jax.jit(
    jax.shard_map(lambda x: jax.lax.psum(x, "px"), mesh=mesh,
                  in_specs=P("px"), out_specs=P(), check_vma=False)
)(garr)
np.testing.assert_allclose(np.asarray(total), [3.0])

# (b) one sharded render: 2 pixels per process, brute intersector
from owl_path_tracer.models import material as material_mod
from owl_path_tracer.models.camera import make_camera
from owl_path_tracer.models.scene import RenderSettings, scene_from_arrays
from owl_path_tracer.parallel import shard as shard_mod
from owl_path_tracer.ops import rng as rng_mod
from owl_path_tracer.render.film import scene_has_textures

tri_v = np.asarray([[0, -1, -1], [0, 1, -1], [0, 0, 1]], np.float32)
tri_i = np.asarray([[0, 1, 2]], np.int32)
mat = material_mod.single(base_color=(0.8, 0.2, 0.2), roughness=0.9)
cam = make_camera_args = make_camera(
    __import__("owl_path_tracer.utils.parser", fromlist=["CameraDesc"]).CameraDesc(
        (3, 0, 0), (0, 0, 0), (0, 1, 0), 45), (2, 2))
scene = scene_from_arrays(tri_v, tri_i, mat, np.zeros(1, np.int32), cam)
settings = RenderSettings(width=2, height=2, max_samples=2, max_path_depth=2)

px_local = np.asarray([[jax.process_index(), 0], [jax.process_index(), 1]], np.int32)
st_local = np.asarray(rng_mod.seed(jnp.asarray(px_local[:, 0]), jnp.asarray(px_local[:, 1])))
sh = NamedSharding(mesh, P("px"))
px_g = jax.make_array_from_process_local_data(sh, jnp.asarray(px_local))
st_g = jax.make_array_from_process_local_data(sh, jnp.asarray(st_local))
fn = shard_mod.sharded_sample_sum(mesh, scene, settings, None, None,
                                  scene_has_textures(scene), 2)
acc, _, rays = fn(px_g, st_g)
acc_local = np.asarray([s.data for s in acc.addressable_shards][0])
assert np.isfinite(acc_local).all()
assert int(np.asarray(rays).sum()) > 0
print("DISTOK", jax.process_index(), acc_local.sum())
"""


def test_two_process_distributed_render(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = "12357"
    env_base = dict(os.environ)
    env_base.pop("XLA_FLAGS", None)  # 1 device per process
    env_base.update({
        "OWLPT_REPO": repo, "OWLPT_PORT": port,
        "JAX_PLATFORMS": "cpu",
    })
    procs = []
    for pid in range(2):
        env = dict(env_base, OWLPT_PID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert "DISTOK" in out, out

"""Multi-process bring-up smoke test (SURVEY.md §2.3d).

Launches two REAL OS processes, each a separate JAX "host" with 2 virtual
CPU devices, connects them with ``jax.distributed.initialize`` (the exact
call a multi-process GPU job makes, via ``rtgs_tpu.parallel.mesh
.initialize_distributed``), builds one global 4-device ``(rays=2, prims=2)``
mesh spanning both processes, and renders a tiny scene through the sharded
production path. Process 0 checks the result against a single-process
render.

This is the closest a single CPU machine gets to two GPU hosts: process-
spanning meshes exercise the same global-device bookkeeping, collective
lowering, and multi-controller SPMD invariants (every process executes the
same program).
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
import numpy as np

sys.path.insert(0, os.environ["RTGS_REPO"])

# A separate "host": its own process with 2 virtual CPU devices.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

from rtgs_tpu.parallel.mesh import initialize_distributed

initialize_distributed()  # reads JAX_COORDINATOR_ADDRESS etc. from env

import jax
import jax.numpy as jnp

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, len(jax.devices())  # global across processes
assert len(jax.local_devices()) == 2

from rtgs_tpu.parallel.mesh import make_mesh, PRIMS_AXIS, RAYS_AXIS
from rtgs_tpu.parallel.render import render_tiled_sharded, shard_scene
from rtgs_tpu.render.tiled import render_tiled_keys
from rtgs_tpu.camera import camera_from_fov
from rtgs_tpu.scene import random_scene


mesh = make_mesh(2, 2)
g = random_scene(jax.random.PRNGKey(5), 64, extent=1.0)
cam = camera_from_fov(jnp.asarray([0.0, 0.0, 4.0]),
                      jnp.asarray([0.0, 0.0, 0.0, 1.0]), (32, 32), 60.0)

gs = shard_scene(g, mesh)
img = render_tiled_sharded(gs, cam, mesh, depth=8, tile=(16, 16),
                           max_candidates=128, max_global=32)
# The result is a global array spanning both processes; each process can
# only see its addressable shards — compare those slices to a local
# single-device reference render.
ref = np.asarray(render_tiled_keys(g, cam, depth=8, tile=(16, 16),
                                   max_candidates=128, max_global=32))
checked = 0
for shard in img.addressable_shards:
    # atol 1e-4: the sharded path shades in the (T, P, K) layout and
    # merges per-shard K-lists, the reference in (T, K, P) — the standard
    # cross-implementation FP difference class.
    np.testing.assert_allclose(np.asarray(shard.data), ref[shard.index],
                               atol=1e-4)
    checked += 1
assert checked > 0
print(f"OK process={jax.process_index()}", flush=True)
"""


@pytest.mark.slow
def test_two_process_distributed_render(tmp_path):
    port = _free_port()
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update(
            RTGS_REPO=repo,
            JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(rank),
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for rank, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        outs.append(out)
        assert proc.returncode == 0, (
            f"process {rank} failed:\n{out}")
    assert "OK process=0" in outs[0] + outs[1]
    assert "OK process=1" in outs[0] + outs[1]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port

"""Device mesh construction for the renderer's two parallel axes.

The reference is strictly single-process, single-GPU (SURVEY.md §2.3); this
framework's first-class parallelism is:

  * ``rays``  — pixel/ray data parallelism: the pixel grid is sharded across
    chips; embarrassingly parallel, no communication in the forward pass,
    gradient ``psum`` in training.
  * ``prims`` — primitive parallelism for scenes too large for one card's
    memory: the Gaussian SoA is sharded, and rendering runs a ring pass over
    shards (ring-attention structure: stationary queries = rays, rotating
    keys = Gaussians, online merge = depth-sorted top-K; SURVEY.md §5).

Collectives are XLA-compiled and handed to NCCL (``ppermute`` ring,
``psum`` for grads). The cards of one host are joined all to all by
NVLink, so the mesh takes devices in ``jax.devices()`` order with no
topology shaping. Multi-process bring-up is ``jax.distributed.initialize``
+ the same mesh spanning every process's devices.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

RAYS_AXIS = "rays"
PRIMS_AXIS = "prims"


def make_mesh(n_rays: int = 0, n_prims: int = 1, devices=None) -> Mesh:
    """Build a ``(rays, prims)`` mesh.

    ``n_rays = 0`` uses all remaining devices on the rays axis.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_rays == 0:
        if n % n_prims:
            raise ValueError(f"{n} devices not divisible by prims={n_prims}")
        n_rays = n // n_prims
    if n_rays * n_prims > n:
        raise ValueError(
            f"mesh {n_rays}x{n_prims} needs {n_rays * n_prims} devices, "
            f"have {n}")
    grid = np.asarray(devices[: n_rays * n_prims]).reshape(n_rays, n_prims)
    return Mesh(grid, (RAYS_AXIS, PRIMS_AXIS))


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-process bring-up (SURVEY.md §2.3d):
    ``jax.distributed.initialize``, after which ``jax.devices()`` spans
    every process's cards and :func:`make_mesh` builds one global mesh.

    Arguments fall back to the standard env vars
    (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``). Nothing detects a cluster on its own: the
    coordinator address (``host:port``), the process count and this
    process's id must all be given. Call once per process, before any
    other JAX API.
    """
    import os

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id)


def mesh_from_config(cfg) -> Mesh:
    """Build the mesh a :class:`rtgs_tpu.config.MeshConfig` asks for (over
    all processes' devices if :func:`initialize_distributed` ran first)."""
    return make_mesh(cfg.rays, cfg.prims)

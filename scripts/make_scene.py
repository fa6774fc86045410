"""Generate a structured (non-uniform) N-splat scene and write it as a
standard 62-property 3DGS .ply with the repo's own writer — the input for
the real-scale CLI render check (BASELINE config 3 shape; the reference's
documented workflow ingests a pretrained .ply,
``/root/reference/docs/source/get-started.md:64``).

Structure: a ground plane, three Gaussian-cluster "objects", and a thin
spherical shell — surface-like density rather than a uniform box, so tile
occupancy is skewed like a real capture.

Usage: python scripts/make_scene.py out.ply [n]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from rtgs_tpu.gaussians import Gaussians
from rtgs_tpu.scene import save_scene


def structured_scene(n: int, seed: int = 0) -> Gaussians:
    rng = np.random.default_rng(seed)
    parts = []

    def add(k, pos, scale_rng):
        quats = rng.normal(size=(k, 4))
        quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
        parts.append(dict(
            means=pos,
            quats=quats,
            scales=rng.uniform(*scale_rng, (k, 3)),
            colors=rng.uniform(0.15, 0.9, (k, 3)),
            opacities=rng.uniform(0.3, 0.95, k),
            sh=rng.normal(0.0, 0.04, (k, 15, 3))))

    n_ground = n // 4
    g_xy = rng.uniform(-4.5, 4.5, (n_ground, 2))
    ground = np.stack([g_xy[:, 0], np.full(n_ground, -0.8)
                       + rng.normal(0, 0.02, n_ground), g_xy[:, 1]], 1)
    add(n_ground, ground, (0.015, 0.05))

    n_obj = n // 4
    for c in ([-1.0, -0.3, 0.0], [0.8, 0.0, 0.5], [0.0, 0.4, -1.0]):
        k = n_obj // 3
        add(k, np.asarray(c) + rng.normal(0, 0.45, (k, 3)), (0.01, 0.03))

    n_shell = n - n_ground - 3 * (n_obj // 3)
    d = rng.normal(size=(n_shell, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    shell = d * (2.2 + rng.normal(0, 0.03, (n_shell, 1)))
    add(n_shell, shell, (0.015, 0.045))

    cat = {k: np.concatenate([p[k] for p in parts], 0) for k in parts[0]}
    return Gaussians(
        means=jnp.asarray(cat["means"], jnp.float32),
        quats=jnp.asarray(cat["quats"], jnp.float32),
        scales=jnp.asarray(cat["scales"], jnp.float32),
        colors=jnp.asarray(cat["colors"], jnp.float32),
        opacities=jnp.asarray(cat["opacities"], jnp.float32),
        sh=jnp.asarray(cat["sh"], jnp.float32),
        mask=jnp.ones(len(cat["opacities"]), jnp.float32),
    )


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/structured1m.ply"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000
    g = structured_scene(n)
    save_scene(out, g)
    print(f"wrote {n} splats -> {out}")

"""Full-frame image-quality metrics at the bench configs: PSNR + SSIM of
the production keys render against

  * the brute-force ORACLE (``render/oracle.py`` — the executable
    reference-semantics contract, a pure-XLA program with no shared code
    with the Pallas kernel), and
  * the XLA keys TWIN (identical binning + selection math, kernel
    replaced by ``lax``; isolates the Pallas kernel itself),

at the ACTUAL bench resolutions — not the 256x192 crop the in-bench
parity gate uses. Offline and slow by design (the oracle is O(N*rays)).

Usage: python scripts/imquality.py [config_idx ...]   (default: all)
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
print = functools.partial(print, flush=True)

import jax
import numpy as np

import bench


def metrics(a: np.ndarray, b: np.ndarray) -> dict:
    from rtgs_tpu.train.loss import psnr, ssim
    import jax.numpy as jnp

    ja, jb = jnp.asarray(a), jnp.asarray(b)
    d = np.abs(a - b)
    return {
        "psnr_db": round(float(psnr(ja, jb)), 2),
        "ssim": round(float(ssim(ja, jb)), 5),
        "mean_absdiff": round(float(d.mean()), 6),
        "p99_absdiff": round(float(np.quantile(d, 0.99)), 6),
    }


def run_config(idx: int) -> dict:
    from rtgs_tpu.camera import camera_from_fov
    from rtgs_tpu.render.oracle import render_oracle
    from rtgs_tpu.render.tiled import render_tiled_keys
    from rtgs_tpu.scene import random_scene
    from rtgs_tpu.viewer.orbit import orbit_camera_pose

    cfg = bench.CONFIGS[idx]
    render_kw = dict(bench.RENDER_KW, **cfg.get("render_kw", {}))
    key = jax.random.PRNGKey(0)
    g = random_scene(key, cfg["n"], extent=2.0, scale_range=(0.005, 0.03))
    pos, rot, _, _ = orbit_camera_pose(
        0.4, 1.2, 5.0, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, cfg["res"], 60.0)
    depth = cfg["depth"]

    t0 = time.time()
    prod = np.asarray(jax.jit(lambda gg: render_tiled_keys(
        gg, cam, depth=depth, **render_kw))(g))
    print(f"[{cfg['label']}] production render {time.time()-t0:.0f}s")
    t0 = time.time()
    # The XLA twin materializes per-tile (P, C) candidate fields for the
    # whole frame at once — 5.7 GB x3 at 250k@720p (OOM); band it.
    twin_kw = dict(render_kw)
    twin_kw.setdefault("tile_bands", 8)
    twin = np.asarray(jax.jit(lambda gg: render_tiled_keys(
        gg, cam, depth=depth, keys_impl="xla", **twin_kw))(g))
    print(f"[{cfg['label']}] xla-twin render {time.time()-t0:.0f}s")
    row = {
        "config": cfg["label"],
        "res": list(cfg["res"]),
        "backend": jax.default_backend(),
        "prod_vs_twin": metrics(prod, twin),
    }
    print(json.dumps(row))  # flush before the (slow) oracle
    # The oracle is O(N·rays): skip it at 1M@1080p (the twin already
    # isolates the kernel; the oracle chain is anchored at the two
    # smaller configs).
    if cfg["n"] * cfg["res"][0] * cfg["res"][1] <= 2.5e11:
        try:
            t0 = time.time()
            oracle = np.asarray(jax.jit(lambda gg: render_oracle(
                gg, cam, depth=depth, pixel_chunk=512))(g))
            print(f"[{cfg['label']}] oracle render {time.time()-t0:.0f}s")
            row["prod_vs_oracle"] = metrics(prod, oracle)
            row["twin_vs_oracle"] = metrics(twin, oracle)
        except Exception as e:
            row["oracle_error"] = f"{type(e).__name__}: {e}"[:200]
            print(f"[{cfg['label']}] oracle failed: {e}")
    else:
        print(f"[{cfg['label']}] oracle skipped (O(N*rays) too large)")
    print(json.dumps(row))
    return row


def main():
    from rtgs_tpu.utils.platform import enable_compilation_cache
    enable_compilation_cache()
    idxs = ([int(a) for a in sys.argv[1:]]
            or list(range(len(bench.CONFIGS))))
    rows = [run_config(i) for i in idxs]
    print(json.dumps({"imquality": rows}))


if __name__ == "__main__":
    main()

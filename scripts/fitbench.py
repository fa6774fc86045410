"""BASELINE config 4 on real hardware: fit ~100k Gaussians against
multiview targets for a few hundred steps; record the loss/PSNR curve and
median step time (the realized reference stub ``solver.py:22-42`` at
production scale).

Self-supervised protocol (no external dataset in the image): render
ground-truth views of a structured 100k scene, perturb the parameters,
and re-fit. PSNR rising back toward the unperturbed render is the
correctness signal; step time is the performance number.

Usage: python scripts/fitbench.py [n] [--steps 300] [--views 12]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
print = functools.partial(print, flush=True)

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--res", type=str, default="512,384")
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--cand", type=int, default=1536)
    ap.add_argument("--renderer", type=str, default="keys")
    args = ap.parse_args()
    res = tuple(int(x) for x in args.res.split(","))

    from rtgs_tpu.utils.platform import enable_compilation_cache
    enable_compilation_cache()
    from rtgs_tpu.camera import camera_from_fov
    from rtgs_tpu.config import TrainConfig
    from rtgs_tpu.scene import random_scene
    from rtgs_tpu.train.datasets import synthetic_orbit_dataset
    from rtgs_tpu.train.solver import (Solver, init_params)
    from rtgs_tpu.viewer.orbit import orbit_camera_pose

    render_kw = dict(max_candidates=args.cand, max_global=128)
    print(f"backend={jax.default_backend()} n={args.n} res={res} "
          f"views={args.views} steps={args.steps} renderer={args.renderer}")

    key = jax.random.PRNGKey(0)
    gt = random_scene(key, args.n, extent=2.0, scale_range=(0.005, 0.03))
    jax.block_until_ready(gt)
    t0 = time.time()
    ds = synthetic_orbit_dataset(
        gt, args.views, res, fov=60.0, radius=5.0, depth=args.depth,
        renderer=args.renderer, **render_kw)
    print(f"dataset: {args.views} views in {time.time()-t0:.0f}s")

    # Perturb: noise on means/scales/colors so the fit has real work.
    params = init_params(gt)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    params = params._replace(
        means=params.means + 0.01 * jax.random.normal(
            k1, params.means.shape),
        log_scales=params.log_scales + 0.3 * jax.random.normal(
            k2, params.log_scales.shape),
        color_logits=params.color_logits + 0.5 * jax.random.normal(
            k3, params.color_logits.shape),
    )

    cfg = TrainConfig(iterations=args.steps, densify_every=0,
                      opacity_reset_every=0)
    solver = Solver(params=params, mask=gt.mask, cfg=cfg,
                    cameras=list(ds.cameras), targets=list(ds.images),
                    depth=args.depth, renderer=args.renderer,
                    render_kwargs=render_kw)

    curve = []
    ts = []
    t_fit0 = time.time()
    for s in range(args.steps):
        t0 = time.perf_counter()
        m = solver.train_step()
        loss = float(m["loss"])
        ts.append(time.perf_counter() - t0)
        if s % 25 == 0 or s == args.steps - 1:
            curve.append({"step": s, "loss": round(loss, 5),
                          "psnr": round(float(m["psnr"]), 2)})
            print(f"step {s:4d}: loss={loss:.5f} "
                  f"psnr={float(m['psnr']):.2f} ({ts[-1]*1e3:.0f} ms)")
    ts_sorted = sorted(ts[2:])
    med = ts_sorted[len(ts_sorted) // 2]
    result = {
        "metric": "fit_step_time",
        "median_step_ms": round(med * 1e3, 1),
        "steps_per_s": round(1.0 / med, 2),
        "n": args.n,
        "res": list(res),
        "views": args.views,
        "steps": args.steps,
        "wall_s": round(time.time() - t_fit0, 1),
        "curve": curve,
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()

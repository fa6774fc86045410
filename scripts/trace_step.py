"""Capture a jax.profiler trace of training steps on the GPU.

Writes a Perfetto/XPlane trace directory and prints a compact summary so
the step composition (binning / keys kernel / bwd / optimizer) is
inspectable offline.

Usage: python scripts/trace_step.py [n] [steps] [outdir]
(outdir defaults to bench_out/rtgs_trace in the checkout)
"""

from __future__ import annotations

import functools
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
print = functools.partial(print, flush=True)

import jax
import numpy as np


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    outdir = sys.argv[3] if len(sys.argv) > 3 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench_out", "rtgs_trace")

    from rtgs_tpu.utils.platform import enable_compilation_cache
    enable_compilation_cache()
    from rtgs_tpu.config import TrainConfig
    from rtgs_tpu.scene import random_scene
    from rtgs_tpu.train.datasets import synthetic_orbit_dataset
    from rtgs_tpu.train.solver import Solver, init_params

    g = random_scene(jax.random.PRNGKey(0), n, extent=2.0,
                     scale_range=(0.005, 0.03))
    ds = synthetic_orbit_dataset(g, 4, (256, 256), fov=60.0, radius=5.0,
                                 depth=8, renderer="keys",
                                 max_candidates=1536)
    solver = Solver(params=init_params(g), mask=g.mask, cfg=TrainConfig(),
                    cameras=ds.cameras, targets=ds.images, depth=8,
                    renderer="keys",
                    render_kwargs=dict(max_candidates=1536))

    # Warm: compile fwd+bwd+optimizer outside the trace window.
    t0 = time.time()
    m = solver.train_step()
    print(f"warm step: {time.time()-t0:.1f}s  loss={m['loss']:.4f}")

    jax.profiler.start_trace(outdir)
    t0 = time.time()
    for _ in range(steps):
        m = solver.train_step()
    dt = (time.time() - t0) / steps
    jax.profiler.stop_trace()
    print(f"traced {steps} steps: {dt*1e3:.1f} ms/step  "
          f"loss={m['loss']:.4f}  psnr={m.get('psnr', float('nan')):.2f}")
    files = glob.glob(os.path.join(outdir, "**", "*"), recursive=True)
    total = sum(os.path.getsize(f) for f in files if os.path.isfile(f))
    print(f"trace: {len(files)} files, {total/1e6:.1f} MB in {outdir}")


if __name__ == "__main__":
    main()

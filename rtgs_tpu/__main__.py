"""Command-line interface.

The reference ships an interactive ``ti.GUI`` viewer driven by the same flags
(the reference's ``src/rtgs/__main__.py:31-258``); on an accelerator host
there is no windowing, so the CLI exposes:

  * ``render`` — render one frame from the orbit-camera home pose (the exact
    pose the reference viewer starts at) to a PNG,
  * ``orbit``  — render a turntable sweep (N frames around the scene),
  * ``bench``  — quick rays/s measurement on the current backend,
  * ``fit``    — optimize a scene against multiview targets,
  * ``serve``  — interactive browser viewer (orbit camera over HTTP).

Flag names and semantics mirror the reference argparse
(``__main__.py:38-84``): ``-o/--open``, ``-r/--res W,H``, ``-f/--fov``,
``-s/--sample``, ``-d/--depth``, ``--scale``; ``LOG_LEVEL`` env controls
logging (``__main__.py:17-26``).
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
import sys
import time

import numpy as np


def _setup_logging():
    env_level = os.getenv("LOG_LEVEL", "WARNING").upper()
    log_levels = {
        "DEBUG": logging.DEBUG,
        "INFO": logging.INFO,
        "WARNING": logging.WARNING,
        "ERROR": logging.ERROR,
        "CRITICAL": logging.CRITICAL,
    }
    logging.basicConfig(level=log_levels.get(env_level, logging.INFO))


def _add_common_flags(p: argparse.ArgumentParser):
    p.add_argument("-o", "--open", type=pathlib.Path, required=True,
                   help="Path to the .ply Gaussian splatting scene file.")
    def _res(s: str):
        parts = s.split(",")
        if len(parts) != 2:
            raise argparse.ArgumentTypeError(
                f"--res wants W,H (e.g. 960,540), got {s!r}")
        return (int(parts[0]), int(parts[1]))

    p.add_argument("-r", "--res", type=_res,
                   default=(960, 540), help="Render resolution W,H")
    p.add_argument("-f", "--fov", type=float, default=90.0,
                   help="Vertical FOV in degrees.")
    p.add_argument("-s", "--sample", type=int, default=1,
                   help="Samples to accumulate per frame (reference "
                        "ray_tracer.py:39-77 semantics; with deterministic "
                        "pixel-center rays all samples are identical unless "
                        "--jitter is set).")
    p.add_argument("--jitter", action="store_true",
                   help="Subpixel-jitter samples 2..N (antialiasing; "
                        "requires -s > 1 to have any effect).")
    p.add_argument("-d", "--depth", type=int, default=16,
                   help="Render sample depth (composited layers).")
    p.add_argument("--scale", type=float, default=1.0,
                   help="Global Gaussian scale.")
    p.add_argument("--renderer",
                   choices=["auto", "oracle", "keys", "tiled"],
                   default="auto",
                   help="auto: keys above 4096 splats, oracle below.")
    p.add_argument("--max-candidates", type=int, default=None,
                   help="Per-tile candidate budget for the keys/tiled "
                        "renderers (default 512; raise until the binning "
                        "overflow counters read 0 — e.g. 3584 for 1M "
                        "splats at 1080p).")
    p.add_argument("--tile-bands", type=int, default=None,
                   help="Render the tile axis in N sequential bands "
                        "(bounds the candidate-feature gather memory; "
                        "use ~8 for 1M-splat scenes at 1080p).")
    p.add_argument("--bin-narrow", type=int, default=None,
                   help="Binning narrow-class fan-out width in tiles "
                        "(default: env RTGS_BIN_NARROW or 4; 3 fans out "
                        "to fewer slots and suits configurations whose "
                        "overflow counters stay 0 with it).")
    p.add_argument("-v", "--bvh", type=int, default=1024,
                   help="BVH node budget (reference __main__.py:72-78 "
                        "parity; the tile-binned pipeline needs no BVH, so "
                        "this only caps the optional LBVH query structure).")
    p.add_argument("--radius", type=float, default=1.0,
                   help="Orbit camera radius (viewer zoom state).")
    p.add_argument("--theta", type=float, default=0.0)
    p.add_argument("--phi", type=float, default=None,
                   help="Orbit polar angle (default π/2).")

    def _mesh(s: str):
        parts = s.split(",")
        if len(parts) != 2:
            raise argparse.ArgumentTypeError(
                f"--mesh wants rays,prims (e.g. 4,2), got {s!r}")
        return (int(parts[0]), int(parts[1]))

    p.add_argument("--mesh", type=_mesh, default=(1, 1),
                   help="Device mesh rays,prims (e.g. 4,2). Anything other "
                        "than 1,1 renders through the sharded production "
                        "path (ppermute ring over prim shards).")
    p.add_argument("--coordinator", type=str, default=None,
                   help="Multi-host: coordinator address host:port "
                        "(jax.distributed.initialize).")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Multi-host: total process count.")
    p.add_argument("--process-id", type=int, default=None,
                   help="Multi-host: this process's rank.")


def _load(args):
    from rtgs_tpu.scene import load_scene

    return load_scene(args.open, scale=args.scale)


def _camera(args, theta, phi, r):
    import math

    from rtgs_tpu.camera import camera_from_fov
    from rtgs_tpu.viewer.orbit import OrbitState

    state = OrbitState(theta=theta, phi=phi if phi is not None else math.pi / 2,
                       r=r)
    pos, rot = state.camera_pose()
    return camera_from_fov(pos, rot, args.res, args.fov)


def _maybe_init_distributed(args):
    if (getattr(args, "coordinator", None)
            or getattr(args, "num_processes", None) is not None):
        from rtgs_tpu.parallel.mesh import initialize_distributed

        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)


def render_kwargs(args) -> dict:
    """Tiling flags of ``args`` that were given, as render() kwargs."""
    kw = {}
    if getattr(args, "max_candidates", None):
        kw["max_candidates"] = args.max_candidates
    if getattr(args, "tile_bands", None):
        kw["tile_bands"] = args.tile_bands
    if getattr(args, "bin_narrow", None):
        kw["bin_narrow"] = args.bin_narrow
    return kw


def _render(g, cam, args):
    if getattr(args, "mesh", (1, 1)) != (1, 1):
        from rtgs_tpu.parallel.mesh import make_mesh
        from rtgs_tpu.parallel.render import render_tiled_sharded, shard_scene

        kw = render_kwargs(args)
        if kw.pop("tile_bands", None):
            logging.getLogger(__name__).warning(
                "--tile-bands is not supported on the --mesh path; ignored")
        # Same silent-flag class: the mesh path has no progressive-sampling
        # dispatch.
        if getattr(args, "sample", 1) > 1 or getattr(args, "jitter", False):
            logging.getLogger(__name__).warning(
                "-s/--sample > 1 and --jitter are not supported on the "
                "--mesh path; rendering 1 centered sample")
        mesh = make_mesh(*args.mesh)
        return render_tiled_sharded(
            shard_scene(g, mesh), cam, mesh, depth=args.depth, **kw)

    from rtgs_tpu.render.api import render, render_progressive

    kw = render_kwargs(args)
    if getattr(args, "sample", 1) > 1:
        return render_progressive(
            g, cam, depth=args.depth, samples=args.sample,
            renderer=args.renderer, jitter=getattr(args, "jitter", False),
            **kw)
    return render(g, cam, depth=args.depth, renderer=args.renderer, **kw)


def cmd_render(args):
    from rtgs_tpu.camera import image_to_display
    from rtgs_tpu.utils.image import save_image

    g = _load(args)
    cam = _camera(args, args.theta, args.phi, args.radius)
    t0 = time.time()
    if args.stats:
        img, stats = _render_with_stats(g, cam, args)
    else:
        img = _render(g, cam, args)
    img = np.asarray(img)
    dt = time.time() - t0
    out = args.output or (args.open.stem + ".png")
    save_image(out, np.asarray(image_to_display(img)))
    w, h = args.res
    print(f"Rendered {w}x{h} ({g.num} splats, depth {args.depth}) "
          f"in {dt:.2f}s -> {out}")
    if args.stats:
        stats = dict(stats, nonfinite=np.size(img) - np.isfinite(img).sum())
        print("stats: " + " ".join(
            f"{k}={int(v)}" for k, v in sorted(stats.items())))


def _render_with_stats(g, cam, args):
    """One keys render whose binning counters (candidates placed, pairs
    dropped by local/global overflow) come from the same program."""
    from rtgs_tpu.render.api import _ORACLE_MAX_N
    from rtgs_tpu.render.tiled import render_tiled_keys

    renderer = args.renderer
    if renderer == "auto" and g.num > _ORACLE_MAX_N:
        renderer = "keys"
    if (renderer != "keys" or getattr(args, "sample", 1) > 1
            or getattr(args, "mesh", (1, 1)) != (1, 1)):
        raise SystemExit("--stats needs the keys renderer (auto above "
                         f"{_ORACLE_MAX_N} splats), one sample, no --mesh")
    return render_tiled_keys(g, cam, depth=args.depth, with_stats=True,
                             **render_kwargs(args))


def cmd_orbit(args):
    from rtgs_tpu.camera import image_to_display
    from rtgs_tpu.utils.image import save_image

    g = _load(args)
    outdir = pathlib.Path(args.output or "orbit_frames")
    outdir.mkdir(parents=True, exist_ok=True)
    for i in range(args.frames):
        theta = args.theta + 2 * np.pi * i / args.frames
        cam = _camera(args, theta, args.phi, args.radius)
        img = _render(g, cam, args)
        save_image(outdir / f"frame_{i:04d}.png",
                   np.asarray(image_to_display(img)))
    print(f"Rendered {args.frames} orbit frames -> {outdir}/")


def cmd_bench(args):
    import jax

    g = _load(args)
    cam = _camera(args, args.theta, args.phi, args.radius)
    jax.block_until_ready(_render(g, cam, args))  # compile + warm up
    # Compute pass: median of per-frame times, each ended by
    # block_until_ready (the image stays on the device).
    t_frames = []
    for _ in range(args.iters):
        _, dt = _timed(lambda: jax.block_until_ready(_render(g, cam, args)))
        t_frames.append(dt)
    t_frames.sort()
    dt = t_frames[len(t_frames) // 2]
    # End-to-end pass: full-image host readback every frame (what an
    # interactive viewer pays per displayed frame).
    t_e2e = []
    for _ in range(max(args.iters // 2, 3)):
        out, d2 = _timed(lambda: np.asarray(_render(g, cam, args)))
        t_e2e.append(d2)
    t_e2e.sort()
    d2 = t_e2e[len(t_e2e) // 2]
    rays = args.res[0] * args.res[1]
    print(f"{rays / dt / 1e6:.2f}M rays/s ({dt * 1e3:.1f} ms/frame compute, "
          f"{1.0 / dt:.1f} FPS; {d2 * 1e3:.1f} ms/frame with full image "
          f"readback, {1.0 / d2:.1f} FPS; {g.num} splats, depth "
          f"{args.depth})")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def cmd_serve(args):
    from rtgs_tpu.viewer.server import serve

    g = _load(args)
    serve(g, args)


def cmd_fit(args):
    """Optimize a scene (the reference's stub ``solver.py`` realized).

    Two target sources:
      * ``--data transforms.json`` — a real multiview dataset;
      * no ``--data`` — self-supervised: render ground-truth views of the
        input scene from an orbit and re-fit (the fit-from-scratch
        benchmark config, BASELINE.json config 4).
    """
    import jax.numpy as jnp

    from rtgs_tpu.config import TrainConfig
    from rtgs_tpu.scene import save_scene
    from rtgs_tpu.train.datasets import (load_transforms_dataset,
                                         synthetic_orbit_dataset)
    from rtgs_tpu.train.solver import (Solver, activate, init_params,
                                       init_params_from_points)

    g = _load(args)
    if args.data:
        ds = load_transforms_dataset(args.data, downscale=args.downscale)
    else:
        ds = synthetic_orbit_dataset(
            g, args.views, args.res, fov=args.fov, radius=args.radius,
            depth=args.depth, renderer=args.renderer, **render_kwargs(args))

    if args.from_scratch:
        # Random subsample of the input means as the seed point cloud.
        import numpy as np

        idx = np.random.default_rng(0).choice(
            g.num, size=min(args.init_points, g.num), replace=False)
        params = init_params_from_points(
            None, jnp.asarray(np.asarray(g.means)[idx]),
            colors=jnp.asarray(np.asarray(g.colors)[idx]))
        mask = jnp.ones((params.means.shape[0],), jnp.float32)
    else:
        params = init_params(g)
        mask = g.mask

    cfg = TrainConfig(iterations=args.steps,
                      checkpoint_dir=args.checkpoint_dir or "checkpoints",
                      checkpoint_every=args.checkpoint_every)
    solver = Solver(params=params, mask=mask, cfg=cfg,
                    cameras=list(ds.cameras), targets=list(ds.images),
                    depth=args.depth, renderer=args.renderer,
                    render_kwargs=render_kwargs(args))
    metrics = solver.train(num_steps=args.steps)
    out = args.output or (args.open.stem + "_fit.ply")
    save_scene(out, solver.scene())
    print(f"fit {args.steps} steps: loss={metrics['loss']:.5f} "
          f"psnr={metrics['psnr']:.2f} live={solver.num_live} -> {out}")


def main(argv=None):
    _setup_logging()
    parser = argparse.ArgumentParser(
        "rtgs-tpu",
        description="Differentiable ray-traced 3D Gaussian splatting "
                    "renderer.")
    sub = parser.add_subparsers(dest="command", required=True)

    p_render = sub.add_parser("render", help="Render a single frame to PNG.")
    _add_common_flags(p_render)
    p_render.add_argument("--output", type=str, default=None)
    p_render.add_argument("--stats", action="store_true",
                          help="Also print the binning counters (keys "
                               "renderer: candidates placed, pairs dropped "
                               "by overflow) and the count of non-finite "
                               "pixel values.")
    p_render.set_defaults(func=cmd_render)

    p_orbit = sub.add_parser("orbit", help="Render an orbit turntable.")
    _add_common_flags(p_orbit)
    p_orbit.add_argument("--frames", type=int, default=12)
    p_orbit.add_argument("--output", type=str, default=None)
    p_orbit.set_defaults(func=cmd_orbit)

    p_bench = sub.add_parser("bench", help="Measure rays/s.")
    _add_common_flags(p_bench)
    p_bench.add_argument("--iters", type=int, default=10)
    p_bench.set_defaults(func=cmd_bench)

    p_serve = sub.add_parser("serve", help="Interactive browser viewer.")
    _add_common_flags(p_serve)
    p_serve.add_argument("--port", type=int, default=8000)
    p_serve.set_defaults(func=cmd_serve)

    p_fit = sub.add_parser(
        "fit", help="Optimize a scene against multiview targets.")
    _add_common_flags(p_fit)
    p_fit.add_argument("--data", type=str, default=None,
                       help="transforms.json dataset; default: "
                            "self-supervised orbit renders of the scene.")
    p_fit.add_argument("--downscale", type=int, default=1)
    p_fit.add_argument("--views", type=int, default=24,
                       help="Orbit views for the self-supervised target set.")
    p_fit.add_argument("--steps", type=int, default=500)
    p_fit.add_argument("--from-scratch", action="store_true",
                       help="Re-initialize from a point subsample instead "
                            "of the loaded parameters.")
    p_fit.add_argument("--init-points", type=int, default=10_000)
    p_fit.add_argument("--checkpoint-dir", type=str, default=None)
    p_fit.add_argument("--checkpoint-every", type=int, default=0)
    p_fit.add_argument("--output", type=str, default=None)
    p_fit.set_defaults(func=cmd_fit)

    args = parser.parse_args(argv)
    _maybe_init_distributed(args)
    from rtgs_tpu.utils.platform import enable_compilation_cache

    enable_compilation_cache()
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())

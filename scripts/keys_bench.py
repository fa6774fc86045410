"""Time the keys selection's implementations on the GPU, end to end.

    python scripts/keys_bench.py --check          # compile + compare only
    python scripts/keys_bench.py                  # full comparison

``--check``: for bench.py's 100k@384p frame and one band of its 1M@1080p
frame, compile the Pallas-Triton kernel, compare its keys with the XLA
form (splat-id agreement, t1 difference), and time the kernel alone for a
few values of ``peel.NUM_WARPS``. The full run adds, for each config and each
implementation ("triton" — the kernel, "xla" — the lexicographic sort,
"topk" — ``lax.top_k`` on the same t1 field), the forward render and the
forward+backward step, each the median of ``--iters`` calls ended by
``block_until_ready``. One JSON object per measurement goes to stdout and
to ``--out`` (default ``bench_out/keys_bench.jsonl`` in the checkout).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "bench_out" / "keys_bench.jsonl"


def emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def timed(fn, iters):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return first, sorted(ts)[len(ts) // 2], ts


def peel_keys_topk(packed_feats, candidates, pix_feats, depth):
    """``lax.top_k`` on the XLA form's t1 field: ties go to the lower
    candidate slot, not the lower splat id (a measurement variant only)."""
    import jax
    import jax.numpy as jnp

    from rtgs_tpu.ops.peel import _gather, _intersect_t1

    gathered, _ = _gather(packed_feats, candidates)
    t1 = _intersect_t1(gathered, pix_feats)
    neg, idx = jax.lax.top_k(-t1, depth)
    sid = jnp.take_along_axis(
        jnp.broadcast_to(candidates[:, None, :], t1.shape), idx, axis=-1)
    t1_k = -neg
    sid_k = jnp.where(jnp.isfinite(t1_k) & (sid >= 0),
                      sid.astype(jnp.float32), jnp.inf)
    return t1_k, sid_k


def setup(cfg):
    import jax
    import numpy as np

    from bench import RENDER_KW
    from rtgs_tpu.camera import camera_from_fov
    from rtgs_tpu.scene import random_scene
    from rtgs_tpu.viewer.orbit import orbit_camera_pose

    g = random_scene(jax.random.PRNGKey(0), cfg["n"], extent=2.0,
                     scale_range=(0.005, 0.03))
    pos, rot, _, _ = orbit_camera_pose(
        0.4, 1.2, 5.0, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, cfg["res"], 60.0)
    return g, cam, dict(RENDER_KW, **cfg["render_kw"])


def check(cfg, iters):
    """Kernel vs XLA form on real inputs (one band at most), kernel time."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtgs_tpu.ops import peel
    from rtgs_tpu.ops.peel import CHUNK, peel_keys_triton, peel_keys_xla
    from rtgs_tpu.render.binning import tile_candidates
    from rtgs_tpu.render.tiled import (_tile_pixel_features, pack_features,
                                       precompute_features)

    g, cam, kw = setup(cfg)
    b = jax.jit(lambda gg: tile_candidates(
        gg, cam, tile=kw["tile"], max_candidates=kw["max_candidates"],
        max_global=kw["max_global"], narrow=kw.get("bin_narrow"),
        chunk=CHUNK))(g)
    packed = jax.jit(lambda gg: pack_features(precompute_features(gg, cam)))(g)
    pix = _tile_pixel_features(cam, kw["tile"])
    bands = kw.get("tile_bands") or 1
    t = -(-b.candidates.shape[0] // bands)
    cand, lb, pix_b = b.candidates[:t], b.chunk_lb[:t], pix[:t]
    depth = cfg["depth"]
    t0 = time.perf_counter()
    t1_k, sid_k = jax.block_until_ready(jax.jit(
        lambda p, c, x, l: peel_keys_triton(p, c, x, depth, chunk_lb=l))(
            packed, cand, pix_b, lb))
    compile_s = time.perf_counter() - t0
    t1_x, sid_x = jax.jit(lambda p, c, x: peel_keys_xla(p, c, x, depth))(
        packed, cand, pix_b)
    sid_k = np.asarray(sid_k).transpose(0, 2, 1)
    t1_k = np.asarray(t1_k).transpose(0, 2, 1)
    sid_x, t1_x = np.asarray(sid_x), np.asarray(t1_x)
    fin = np.isfinite(t1_x)
    rel = np.abs(t1_k - t1_x)[fin] / np.abs(t1_x)[fin]
    rec = dict(kind="check", config=cfg["label"], tiles=int(t),
               candidates=int(cand.shape[1]),
               live=int(jnp.sum(cand >= 0)),
               kernel_compile_s=compile_s,
               sid_agree=float((sid_k == sid_x).mean()),
               hit_pattern_agree=float(
                   (np.isfinite(t1_k) == fin).mean()),
               t1_rel_max=float(rel.max()) if rel.size else 0.0,
               t1_rel_p99=float(np.quantile(rel, 0.99)) if rel.size else 0.0,
               nonfinite_winner_sid=int(
                   (np.isfinite(t1_k) & ~np.isfinite(sid_k)).sum()))
    # Kernel alone, whole frame (no (T, P, C) array is built), per warps:
    # a fresh jit per value, so each traces with the patched constant.
    saved = peel.NUM_WARPS
    try:
        for warps in (2, 4, 8):
            peel.NUM_WARPS = warps
            fn = jax.jit(lambda p, c, x, l: peel_keys_triton(
                p, c, x, depth, chunk_lb=l))
            first, med, _ = timed(lambda: fn(packed, b.candidates, pix,
                                             b.chunk_lb), iters)
            rec[f"kernel_frame_ms_w{warps}"] = med * 1e3
    finally:
        peel.NUM_WARPS = saved
    xla = jax.jit(lambda p, c, x: peel_keys_xla(p, c, x, depth))
    _, med, _ = timed(lambda: xla(packed, cand, pix_b), iters)
    rec["xla_band_ms"] = med * 1e3
    kern = jax.jit(lambda p, c, x, l: peel_keys_triton(
        p, c, x, depth, chunk_lb=l))
    _, med, _ = timed(lambda: kern(packed, cand, pix_b, lb), iters)
    rec["kernel_band_ms"] = med * 1e3
    emit(rec)


def end_to_end(cfg, impl, iters):
    import jax
    import jax.numpy as jnp

    from rtgs_tpu.ops import peel
    from rtgs_tpu.render.tiled import render_tiled_keys

    g, cam, kw = setup(cfg)
    depth = cfg["depth"]
    jax.clear_caches()
    saved = peel.peel_keys_xla
    if impl == "topk":
        peel.peel_keys_xla = peel_keys_topk
    keys_impl = "triton" if impl == "triton" else "xla"
    try:
        fwd = jax.jit(lambda gg: render_tiled_keys(
            gg, cam, depth=depth, keys_impl=keys_impl, **kw))
        grad = jax.jit(jax.grad(lambda gg: jnp.sum(render_tiled_keys(
            gg, cam, depth=depth, keys_impl=keys_impl, **kw))))
        rays = cfg["res"][0] * cfg["res"][1]
        rec = dict(kind="e2e", config=cfg["label"], impl=impl)
        for name, fn in (("fwd", fwd), ("step", grad)):
            try:
                first, med, ts = timed(lambda: fn(g), iters)
                rec[f"{name}_ms"] = med * 1e3
                rec[f"{name}_first_s"] = first
                rec[f"{name}_rays_per_s"] = rays / med
                rec[f"{name}_all_ms"] = [x * 1e3 for x in ts]
            except Exception as e:  # an impl that cannot run is recorded
                rec[f"{name}_error"] = f"{type(e).__name__}: {e}"[:300]
        stats = (jax.devices()[0].memory_stats() or {})
        rec["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        emit(rec)
    finally:
        peel.peel_keys_xla = saved


def main():
    global OUT
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--configs", default="100k@384p,1M@1080p")
    ap.add_argument("--impls", default="triton,xla,topk")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", type=pathlib.Path, default=OUT)
    args = ap.parse_args()
    OUT = args.out

    import jax

    from bench import CONFIGS
    from rtgs_tpu.utils.platform import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    enable_compilation_cache()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit(dict(kind="device", card=card.strip(), kind_jax=dev.device_kind,
              jax=jax.__version__,
              xla_flags=os.environ.get("XLA_FLAGS", "")))
    cfgs = {c["label"]: c for c in CONFIGS}
    for label in args.configs.split(","):
        check(cfgs[label], args.iters)
        if args.check:
            continue
        for impl in args.impls.split(","):
            end_to_end(cfgs[label], impl, args.iters)


if __name__ == "__main__":
    main()

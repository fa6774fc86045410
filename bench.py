"""Benchmark harness: one JSON line per config.

Headline metric (BASELINE.json): forward+backward rays/s on one card at a
1M-Gaussian scene, depth 16. Baseline: the reference's derived throughput of
~0.49M full 16-deep rays/s (BASELINE.md — 960×540 @ 15 FPS, one peel per
frame, ``/root/reference/docs/source/get-started.md:74``).

The harness is built to ALWAYS emit a result:

  * configs run smallest-first in a subprocess each (one JAX process on the
    card at a time), escalating while they succeed; the largest successful
    config wins,
  * the best-so-far JSON line is printed after every config, so even if the
    whole harness is killed mid-config the last emitted line stands,
  * SIGTERM/SIGINT also flush the best-so-far line before exiting,
  * each subprocess gets a hard wall-clock cap,
  * a config that fails (nonzero exit or timeout) does not stop escalation,
  * the persistent compilation cache (``enable_compilation_cache``) makes
    warm runs start in seconds.

Each child also reports the binning overflow counters for its config — a
"1M-Gaussian render" that silently drops candidates would otherwise be a
meaningless number. A child finds no GPU → its peak-table lookup raises and
no number is published.

Run ``python bench.py --child <idx>`` to execute one config directly.
"""

from __future__ import annotations

import json
import os
from functools import partial
import signal
import subprocess
import sys
import time

BASELINE_RAYS_PER_S = 0.49e6  # reference, full 16-deep rays/s (BASELINE.md)

# Per-config candidate budgets: the per-tile candidate maximum of each
# config's scene and pose (seeded, so fixed) fits the budget, and the
# overflow counters, computed in the SAME program as the timed forward,
# verify zero drops every run — a rays/s number for a degraded image is
# meaningless.
CONFIGS = [
    # bin_narrow=3: both sub-1M configs have zero wide-class spill at 3x3
    # (the overflow counters verify it every run) and the 9-slot fan-out
    # is cheaper than the 1M-safe 4x4 default. A static argument, so the
    # jit cache keys on it.
    dict(n=100_000, res=(640, 384), depth=16, label="100k@384p",
         render_kw=dict(max_candidates=1536, bin_narrow=3)),
    dict(n=250_000, res=(1280, 720), depth=16, label="250k@720p",
         render_kw=dict(max_candidates=1536, bin_narrow=3)),
    dict(n=1_000_000, res=(1920, 1088), depth=16, label="1M@1080p",
         # 8 tile bands bound the per-band shade buffers (and the gradient
         # program's live set); 3584 covers the scene's largest per-tile
         # candidate count at this pose.
         render_kw=dict(max_candidates=3584, tile_bands=8, bin_narrow=4)),
]
RENDER_KW = dict(tile=(16, 16), max_candidates=512, max_global=128)
# Per-config subprocess wall cap (cold compiles included).
CHILD_TIMEOUT_S = float(os.environ.get("BENCH_CHILD_TIMEOUT", "1500"))

_best = None


def _log(msg):
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _emit(result):
    print(json.dumps(result), flush=True)


def _emit_best_and_exit(signum, frame):
    _log(f"signal {signum}: flushing best-so-far result")
    if _best is not None:
        _emit(_best)
    else:
        _emit({"metric": "rays_per_s", "value": 0.0, "unit": "rays/s",
               "vs_baseline": 0.0, "error": f"killed by signal {signum} "
               "before any config finished"})
    sys.exit(0)


def _parity_gate(g, pos, rot, depth, render_kw) -> None:
    """The hardware-correctness gate, IN the bench: render a
    reduced-resolution frame of the bench scene through the production
    keys kernel AND through its identical-math XLA form (keys_impl="xla" —
    only the selection's implementation differs), assert the kernel's
    output is finite and matches within the gate's tolerance (mean
    |diff| ≤ 5e-3, p99 ≤ 5e-2: near-tie depth reorderings from last-bit
    differences in t1). A failure aborts the config — no number is
    published for a kernel that misrenders (interpret-mode tests on the
    CPU cannot see what the GPU compiler does)."""
    import jax
    import numpy as np

    from rtgs_tpu.camera import camera_from_fov
    from rtgs_tpu.render.tiled import render_tiled_keys

    gate_res = (256, 192)
    cam = camera_from_fov(pos, rot, gate_res, 60.0)
    kw = dict(render_kw)
    kw.pop("tile_bands", None)
    img_chip = np.asarray(jax.jit(lambda gg: render_tiled_keys(
        gg, cam, depth=depth, keys_impl="triton", **kw))(g))
    img_twin = np.asarray(jax.jit(lambda gg: render_tiled_keys(
        gg, cam, depth=depth, keys_impl="xla", **kw))(g))
    nan_frac = 1.0 - np.isfinite(img_chip).mean()
    d = np.abs(img_chip - img_twin)
    mean, p99 = float(d.mean()), float(np.quantile(d, 0.99))
    _log(f"parity gate @{gate_res}: nan_frac={nan_frac:.2%} "
         f"mean|diff|={mean:.5f} p99={p99:.5f}")
    if nan_frac > 0 or mean > 5e-3 or p99 > 5e-2:
        raise AssertionError(
            f"parity gate FAILED: nan_frac={nan_frac:.2%} "
            f"mean={mean:.5f} p99={p99:.5f} — refusing to publish a "
            "throughput number for a kernel that misrenders")


# Published peaks per device, keyed by JAX's ``device_kind``, for the
# utilization/roofline accounting. Source: NVIDIA's H100 SXM data sheet
# (dense rates, no sparsity, at the 700 W power limit). The render pipeline
# is *selection*-dominated (f32 compares/selects and FMAs outside the
# tensor cores), so its utilization is reported against the f32 peak.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(flops_f32=67e12, flops_tf32=495e12,
                                  flops_bf16=989e12, hbm_gbps=3350.0),
}


def device_peaks(kind: str) -> dict:
    """The published peaks of ``kind``; a device not in the table is an
    error, not a default."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def _flop_model(stats: dict, rays: int, depth: int, chunk: int,
                t_fwd: float, t_step: float, mode: str,
                peaks: dict) -> dict:
    """Stated arithmetic model of the keys render.

    Forward, per (pixel, swept candidate): ~31 flops of ray-quadratic
    intersect (9 multiply-adds + discriminant + root) and ~90 flops of
    top-K insertion work (compares and selects against the K-list).
    Per (pixel,
    winner): ~150 flops of shading (quadratic + exp + 15-term SH × 3
    channels) + 8 composite. Backward (keys path): the kernel re-runs
    nothing — autodiff re-gathers winners and chains (~2.2x the shade
    cost) plus the scatter-add, counted as shade-equivalent. The model is
    for ROOFLINE INTERPRETATION (how far from hardware limits), not a
    claim of useful-work efficiency; swept-pairs is the padded per-tile
    candidate total, an upper bound under early termination.

    HBM model: feature rows (256 B) DMAed once per swept pair; winner
    rows gathered once forward (+1 gather + 1 scatter-add backward).
    """
    p_tile = 256
    k = depth
    swept = float(stats.get("swept_pairs", stats["live"]))
    winners = rays * k
    fwd_flops = swept * p_tile * (31 + 90) + winners * (150 + 8)
    bwd_flops = swept * p_tile * 0 + winners * 150 * 2.2
    hbm_fwd = swept * 256 + winners * 256
    hbm_bwd = winners * 256 * 2
    out = {
        "flops_fwd": fwd_flops,
        "mfu_fwd": fwd_flops / t_fwd / peaks["flops_f32"],
        "hbm_gbps_fwd": hbm_fwd / t_fwd / 1e9,
    }
    if mode == "fwd+bwd":
        out["flops_step"] = fwd_flops + bwd_flops
        out["mfu_step"] = ((fwd_flops + bwd_flops) / t_step
                           / peaks["flops_f32"])
        out["hbm_gbps_step"] = (hbm_fwd + hbm_bwd) / t_step / 1e9
    return {kk: (round(v, 5) if "mfu" in kk else round(v, 1))
            for kk, v in out.items()}


def _child(idx: int) -> None:
    cfg = CONFIGS[idx]

    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtgs_tpu.utils.platform import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    peaks = device_peaks(dev.device_kind)

    from rtgs_tpu.camera import camera_from_fov
    from rtgs_tpu.render.tiled import render_tiled_keys
    from rtgs_tpu.scene import random_scene
    from rtgs_tpu.viewer.orbit import orbit_camera_pose
    render_kw = dict(RENDER_KW, **cfg.get("render_kw", {}))
    _log(f"child {cfg['label']}: building scene")
    key = jax.random.PRNGKey(0)
    g = random_scene(key, cfg["n"], extent=2.0, scale_range=(0.005, 0.03))
    jax.block_until_ready(g)
    pos, rot, _, _ = orbit_camera_pose(
        0.4, 1.2, 5.0, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, cfg["res"], 60.0)
    rays = cfg["res"][0] * cfg["res"][1]
    depth = cfg["depth"]

    if not os.environ.get("RTGS_SKIP_PARITY_GATE"):
        _parity_gate(g, pos, rot, depth, render_kw)

    def _time(fn, iters=5):
        """Median wall time of ``fn()`` ended by block_until_ready, after
        one compile/warm-up call."""
        _log("compiling/warming")
        jax.block_until_ready(fn())
        ts = []
        for _i in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2]

    # Overflow counters ride in the SAME compiled program as the timed
    # forward (with_stats): no separate compile for a diagnostic. The
    # stats outputs are a few scalars; their cost is noise.
    fwd = jax.jit(lambda gg: render_tiled_keys(
        gg, cam, depth=depth, with_stats=True, **render_kw))
    t_fwd = _time(lambda: fwd(g))
    _log(f"fwd {t_fwd*1e3:.1f} ms ({rays/t_fwd/1e6:.1f} Mrays/s)")
    _img, stats = fwd(g)
    live = int(stats["live"])
    local_ovf = int(stats["local_overflow"])
    global_ovf = int(stats["global_overflow"])
    # Both overflow classes drop candidates from the image (ADVICE r3).
    dropped = local_ovf + global_ovf
    dropped_frac = dropped / max(live + dropped, 1)
    _log(f"binning: live={live} local_ovf={local_ovf} "
         f"global_ovf={global_ovf} dropped={dropped_frac:.2%}")

    @jax.jit
    def grad_fn(gg):
        def loss(gg):
            return jnp.sum(render_tiled_keys(
                gg, cam, depth=depth, **render_kw))

        return jax.grad(loss)(gg)

    try:
        t_step = _time(lambda: grad_fn(g))
        mode = "fwd+bwd"
    except Exception as e:
        _log(f"bwd failed ({type(e).__name__}: {e}); reporting fwd only")
        mode, t_step = "fwd", t_fwd

    value = rays / t_step
    from rtgs_tpu.ops.peel import CHUNK as _CHUNK

    stats_np = {k: int(v) for k, v in stats.items()}
    result = {
        "metric": "rays_per_s",
        "value": round(value, 1),
        "unit": f"rays/s ({mode}, {cfg['label']}, depth {depth}, 1 card)",
        # The baseline is a fwd+bwd-derived number; a fwd-only run is not
        # comparable — flag it with a null ratio.
        "vs_baseline": (round(value / BASELINE_RAYS_PER_S, 3)
                        if mode == "fwd+bwd" else None),
        "config": cfg["label"],
        "mode": mode,
        "fwd_ms": round(t_fwd * 1e3, 2),
        "fwd_rays_per_s": round(rays / t_fwd, 1),
        "step_ms": round(t_step * 1e3, 2),
        "local_overflow": local_ovf,
        "global_overflow": global_ovf,
        "dropped_frac": round(dropped_frac, 5),
        # Roofline accounting + the render settings, so every row is
        # reproducible from itself.
        **_flop_model(stats_np, rays, depth, _CHUNK, t_fwd, t_step, mode,
                      peaks),
        "knobs": dict(bin_narrow=render_kw.get("bin_narrow"),
                      **{k: v for k, v in render_kw.items()
                         if k in ("max_candidates", "tile_bands")}),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result), flush=True)


def main() -> None:
    global _best
    signal.signal(signal.SIGTERM, _emit_best_and_exit)
    signal.signal(signal.SIGINT, _emit_best_and_exit)

    for idx in range(len(CONFIGS)):
        label = CONFIGS[idx]["label"]
        _log(f"running config {label} (cap {CHILD_TIMEOUT_S:.0f}s)")
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 str(idx)],
                capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            # Preserve the child's diagnostics — they say which stage
            # (scene build / compile / timing) hung.
            for stream in (e.stderr, e.stdout):
                if stream:
                    sys.stderr.write(stream if isinstance(stream, str)
                                     else stream.decode(errors="replace"))
            # A timeout must NOT stop escalation: one pathological config
            # would otherwise hide the larger ones.
            _log(f"config {label} timed out; continuing to next config")
            continue
        sys.stderr.write(proc.stderr)
        parsed = None
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    parsed = json.loads(line)
                except json.JSONDecodeError:
                    pass
        if proc.returncode == 0 and parsed is not None:
            _best = parsed
            _log(f"config {label} ok: {parsed['value']:.3g} {parsed['unit']}")
            # Emit incrementally: if a later, bigger config hangs and the
            # harness is killed from outside, this line already stands.
            _emit(_best)
        else:
            # Nonzero exit (not timeout): keep escalating so a flaky
            # mid-size config can't cap the headline.
            _log(f"config {label} failed (rc={proc.returncode}); "
                 "continuing to next config")
    if _best is None:
        _emit({"metric": "rays_per_s", "value": 0.0, "unit": "rays/s",
               "vs_baseline": 0.0, "error": "all configs failed"})
    else:
        _emit(_best)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        _child(int(sys.argv[2]))
    else:
        main()

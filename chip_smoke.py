"""Smoke test of the renderer on one GPU, through the entry points users call.

    python chip_smoke.py           # phases (a)-(f) on one card
    python chip_smoke.py --four    # the sharded path on four cards only

Phases (one process; every phase must pass or the script exits non-zero):

  (a) device check: JAX's default device must be a GPU; prints the card's
      name and power limit as ``nvidia-smi`` reports them.
  (b) ``python -m rtgs_tpu render`` (in-process ``main``) on a seeded
      1M-Gaussian scene written with ``save_scene``, at 1920x1088, depth 16,
      ``--renderer auto``: the image must be finite and the binning overflow
      counters 0.
  (c) one forward+backward (``jax.grad`` of the summed render) at the same
      size, timed with ``block_until_ready``; information only.
  (d) parity on the card: at 100k splats, the production render against the
      brute-force oracle on a 256x192 view (mean |diff| <= 5e-3, p99 <=
      5e-2 — near-tie depth reorderings), and against the XLA form of the
      selection; at 10k splats, keys-path gradients against ``render_tiled``'s,
      and at 4k splats the gradient of ``render(auto)`` (the oracle there)
      against ``render_tiled``'s (normalized p99 <= 2e-2, max <= 2e-1; see
      GRAD_P99).
  (e) ``fit`` for a few steps at 100k splats, 640x384, 4 views: the loss is
      finite and one checkpoint is written.
  (f) ``serve`` on a free port: three ``GET /frame`` with a ``POST /event``
      orbit between them; every response decodes as a PNG.

``--four`` runs ``render_tiled_sharded`` at 1M@1920x1088 on meshes 4x1, 2x2
and 1x4 against the single-card keys render (same gate as (d)), and one
sharded training step at ``scale="full"``.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Scratch files live in ``.smoke/`` inside the checkout and are removed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import shutil
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from rtgs_tpu.utils.platform import enable_compilation_cache  # noqa: E402

# Image gate (bench.py's): near-tie depth reorderings from last-bit t1
# differences move a few pixels by up to one layer's contribution.
GATE_MEAN, GATE_P99 = 5e-3, 5e-2
# Gradient gate, |keys − tiled| / max|tiled| per field: the scales and
# quats chains run through Σ⁻¹ and the cancelling exponent B²/4A − eᵀMe,
# so two f32 evaluations of them (the keys path's hand-written shading VJP
# and autodiff of the tiled path) differ by up to ~1% of the largest entry
# at the 99th percentile, and single splats by ~10% (scales: p99 0.011,
# max 0.065 on the CPU at 2000 splats, where the oracle's own gradient
# differs from both by as much; p99 0.0027, max 0.096 on an H100 at 10k).
GRAD_P99, GRAD_MAX = 2e-2, 2e-1
# The headline configuration (bench.py's 1M@1080p): scene seed/extent, pose
# and the tiling that keeps the binning overflow at 0 there.
BIG = dict(n=1_000_000, res=(1920, 1088), depth=16,
           tiling=dict(max_candidates=3584, tile_bands=8, bin_narrow=4))
MID = dict(n=100_000, tiling=dict(max_candidates=1536, bin_narrow=3))
# The parity view is 256x192 at the same field of view, so each tile sees
# ~6x the candidates of a 640x384 tile (largest count 2889 here).
PARITY_TILING = dict(max_candidates=3072, max_global=128, bin_narrow=3)
POSE = dict(theta=0.4, phi=1.2, radius=5.0, fov=60.0)


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def scene(n: int, seed: int):
    from rtgs_tpu.scene import random_scene

    return random_scene(__import__("jax").random.PRNGKey(seed), n,
                        extent=2.0, scale_range=(0.005, 0.03))


def camera(res, theta=POSE["theta"], phi=POSE["phi"], r=POSE["radius"]):
    import numpy as np

    from rtgs_tpu.camera import camera_from_fov
    from rtgs_tpu.viewer.orbit import orbit_camera_pose

    pos, rot, _, _ = orbit_camera_pose(
        theta, phi, r, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    return camera_from_fov(pos, rot, res, POSE["fov"])


def cli(argv) -> str:
    """Run the CLI's ``main`` in this process; return what it printed."""
    from rtgs_tpu.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([str(a) for a in argv])
    out = buf.getvalue()
    sys.stdout.write(out)
    return out


def pose_flags(res):
    return ["-r", f"{res[0]},{res[1]}", "-f", POSE["fov"],
            "--theta", POSE["theta"], "--phi", POSE["phi"],
            "--radius", POSE["radius"]]


def tiling_flags(tiling):
    flags = []
    for k, v in tiling.items():
        flags += ["--" + k.replace("_", "-"), v]
    return flags


def image_gate(tag, img, ref):
    import numpy as np

    img, ref = np.asarray(img), np.asarray(ref)
    assert img.shape == ref.shape, (tag, img.shape, ref.shape)
    assert np.isfinite(img).all(), f"{tag}: non-finite pixels"
    d = np.abs(img - ref)
    mean, p99 = float(d.mean()), float(np.quantile(d, 0.99))
    log(f"{tag}: mean|diff|={mean:.6g} p99={p99:.6g} max={d.max():.6g} "
        f"(gate mean<={GATE_MEAN} p99<={GATE_P99})")
    assert mean <= GATE_MEAN and p99 <= GATE_P99, f"{tag}: parity gate failed"


def phase_render(work):
    """(b) CLI render of the 1M scene at 1080p."""
    import numpy as np

    from rtgs_tpu.scene import save_scene
    from rtgs_tpu.utils.image import decode_png

    path = work / "scene_1m.ply"
    t0 = time.perf_counter()
    save_scene(path, scene(BIG["n"], seed=0))
    log(f"(b) wrote {BIG['n']} splats to {path.name} "
        f"in {time.perf_counter() - t0:.1f} s")
    png = work / "frame_1m.png"
    out = cli(["render", "-o", path, *pose_flags(BIG["res"]),
               "-d", BIG["depth"], "--renderer", "auto",
               *tiling_flags(BIG["tiling"]), "--stats", "--output", png])
    stats = dict(kv.split("=") for kv in
                 out.split("stats:", 1)[1].split())
    stats = {k: int(v) for k, v in stats.items()}
    assert stats["nonfinite"] == 0, stats
    assert stats["local_overflow"] == 0 and stats["global_overflow"] == 0, \
        stats
    arr = decode_png(png.read_bytes())
    assert arr.shape == (BIG["res"][1], BIG["res"][0], 3), arr.shape
    assert arr.std() > 0, "blank frame"
    log(f"(b) ok: {stats}; PNG {arr.shape}, mean {arr.mean():.1f}")
    return path


def phase_grad(scene_path):
    """(c) forward+backward at 1M@1080p, timed."""
    import jax
    import jax.numpy as jnp

    from rtgs_tpu.render.api import render
    from rtgs_tpu.scene import load_scene

    g = load_scene(scene_path)
    cam = camera(BIG["res"])

    @jax.jit
    def grad_fn(gg):
        return jax.grad(lambda x: jnp.sum(render(
            x, cam, depth=BIG["depth"], renderer="auto",
            **BIG["tiling"])))(gg)

    t0 = time.perf_counter()
    grads = jax.block_until_ready(grad_fn(g))
    log(f"(c) compile + first step {time.perf_counter() - t0:.1f} s")
    for name in ("means", "quats", "scales", "colors", "opacities", "sh"):
        assert bool(jnp.isfinite(getattr(grads, name)).all()), name
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(grad_fn(g))
        ts.append(time.perf_counter() - t0)
    dt = sorted(ts)[1]
    rays = BIG["res"][0] * BIG["res"][1]
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"(c) fwd+bwd 1M@1920x1088 depth 16: {dt * 1e3:.1f} ms "
        f"(median of {ts}), {rays / dt:.4g} rays/s, "
        f"peak_bytes_in_use={peak}")


def phase_parity():
    """(d) production vs oracle and vs the XLA selection; gradients."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtgs_tpu.render.api import render
    from rtgs_tpu.render.oracle import render_oracle
    from rtgs_tpu.render.tiled import render_tiled, render_tiled_keys

    g = scene(MID["n"], seed=1)
    cam = camera((256, 192))
    img = render(g, cam, depth=16, renderer="auto", **PARITY_TILING)
    _, stats = render_tiled_keys(g, cam, depth=16, with_stats=True,
                                 **PARITY_TILING)
    assert int(stats["local_overflow"]) == 0, stats
    assert int(stats["global_overflow"]) == 0, stats
    image_gate("(d) 100k keys vs oracle", img,
               render_oracle(g, cam, depth=16))
    image_gate("(d) 100k keys vs XLA selection", img,
               render_tiled_keys(g, cam, depth=16, keys_impl="xla",
                                 **PARITY_TILING))

    from rtgs_tpu.scene import random_scene

    g = random_scene(jax.random.PRNGKey(2), 10_000, extent=1.0,
                     scale_range=(0.01, 0.05))
    cam = camera((256, 192), r=3.0)
    kw = dict(depth=8, max_candidates=1024, max_global=128)
    _, stats = render_tiled_keys(g, cam, with_stats=True, **kw)
    assert int(stats["local_overflow"]) == 0, stats

    def grads(fn, g):
        return jax.jit(jax.grad(
            lambda x: jnp.sum(fn(x, cam, **kw) ** 2)))(g)

    def grad_gate(tag, got, ref):
        for name in ("means", "quats", "scales", "colors", "opacities",
                     "sh"):
            a = np.asarray(getattr(got, name))
            b = np.asarray(getattr(ref, name))
            assert np.isfinite(a).all(), (tag, name)
            rel = np.abs(a - b) / (np.abs(b).max() + 1e-8)
            p99, mx = float(np.quantile(rel, 0.99)), float(rel.max())
            log(f"(d) {tag} grad {name}: normalized p99={p99:.3g} "
                f"max={mx:.3g}")
            assert p99 < GRAD_P99 and mx < GRAD_MAX, (tag, name, p99, mx)

    grad_gate("10k keys vs tiled", grads(render_tiled_keys, g),
              grads(render_tiled, g))
    # render(auto) sends scenes of at most 4096 splats to the oracle, so
    # fitting a small scene trains on the oracle's gradient.
    g = random_scene(jax.random.PRNGKey(3), 4000, extent=1.0,
                     scale_range=(0.01, 0.05))
    grad_gate("4k auto (oracle) vs tiled",
              grads(lambda x, c, **k: render(x, c, renderer="auto", **k), g),
              grads(render_tiled, g))


def phase_fit(work):
    """(e) CLI fit at 100k@640x384, 4 views, a checkpoint."""
    import math

    from rtgs_tpu.scene import save_scene

    path = work / "scene_100k.ply"
    save_scene(path, scene(MID["n"], seed=1))
    ckpt = work / "ckpt"
    steps = 5
    out = cli(["fit", "-o", path, *pose_flags((640, 384)), "-d", 16,
               "--views", 4, "--steps", steps, *tiling_flags(MID["tiling"]),
               "--checkpoint-dir", ckpt, "--checkpoint-every", steps,
               "--output", work / "fit_100k.ply"])
    loss = float(out.split("loss=", 1)[1].split()[0])
    assert math.isfinite(loss), out
    saved = sorted(p.name for p in ckpt.iterdir())
    assert saved == [f"step_{steps}.npz"], saved
    log(f"(e) ok: loss={loss}, checkpoint {saved[0]}")
    return path


def phase_serve(scene_path):
    """(f) CLI serve: frames and an orbit event over HTTP."""
    import socket
    import urllib.request

    from rtgs_tpu.utils.image import decode_png

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    argv = ["serve", "-o", scene_path, *pose_flags((640, 384)), "-d", 16,
            *tiling_flags(MID["tiling"]), "--port", port]
    from rtgs_tpu.__main__ import main

    threading.Thread(target=main, args=([str(a) for a in argv],),
                     daemon=True).start()
    base = f"http://127.0.0.1:{port}"

    def get(path):
        deadline = time.time() + 300
        while True:
            try:
                with urllib.request.urlopen(base + path, timeout=300) as r:
                    return r.read()
            except (ConnectionError, urllib.error.URLError):
                if time.time() > deadline:
                    raise
                time.sleep(0.5)

    frames = []
    for i in range(3):
        if i:
            req = urllib.request.Request(
                base + "/event", method="POST",
                data=json.dumps({"type": "pan", "dx": 0.1,
                                 "dy": 0.0}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 204, r.status
        t0 = time.perf_counter()
        arr = decode_png(get(f"/frame?v={i}"))
        log(f"(f) frame {i}: {arr.shape} in "
            f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
        assert arr.shape == (384, 640, 3), arr.shape
        frames.append(arr)
    assert (frames[0] != frames[1]).any() and (frames[1] != frames[2]).any()
    log("(f) ok: three PNG frames, each orbit event changed the view")


def phase_four():
    """Sharded render on 4x1, 2x2, 1x4 vs one card; one sharded step."""
    import jax

    import __graft_entry__ as ge
    from rtgs_tpu.parallel.mesh import make_mesh
    from rtgs_tpu.parallel.render import render_tiled_sharded, shard_scene
    from rtgs_tpu.render.tiled import render_tiled_keys

    assert len(jax.devices()) == 4, jax.devices()
    g = scene(BIG["n"], seed=0)
    cam = camera(BIG["res"])
    kw = dict(max_candidates=BIG["tiling"]["max_candidates"],
              bin_narrow=BIG["tiling"]["bin_narrow"], max_global=128)
    ref = jax.block_until_ready(render_tiled_keys(
        g, cam, depth=BIG["depth"], tile_bands=BIG["tiling"]["tile_bands"],
        **kw))
    for shape in ((4, 1), (2, 2), (1, 4)):
        mesh = make_mesh(*shape)
        gs = shard_scene(g, mesh)
        t0 = time.perf_counter()
        img = jax.block_until_ready(render_tiled_sharded(
            gs, cam, mesh, depth=BIG["depth"], **kw))
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(render_tiled_sharded(
            gs, cam, mesh, depth=BIG["depth"], **kw))
        held = {s.device for s in gs.means.addressable_shards}
        held_img = {s.device for s in img.addressable_shards}
        log(f"four: mesh {shape}: first call {t_first:.1f} s, second "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms; scene shards on "
            f"{len(held)} devices, image on {len(held_img)}")
        assert len(held_img) == 4, held_img
        image_gate(f"four: sharded {shape} vs one card", img, ref)
    loss, devices = ge.dryrun_multichip(4, scale="full")
    assert devices is not None and len(devices) == 4, devices
    log(f"four: sharded training step ok, loss={loss}, params on "
        f"{len(devices)} devices")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="Run only the four-card sharded path.")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX's default device is "
              f"{dev.platform} ({dev.device_kind})", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    log(f"(a) JAX {jax.__version__}: {len(jax.devices())} x "
        f"{dev.device_kind}; compile cache {enable_compilation_cache()}")

    work = ROOT / ".smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    try:
        if args.four:
            phase_four()
        else:
            t0 = time.perf_counter()
            big = phase_render(work)
            phase_grad(big)
            big.unlink()
            phase_parity()
            mid = phase_fit(work)
            phase_serve(mid)
            log(f"all phases ok in {time.perf_counter() - t0:.0f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

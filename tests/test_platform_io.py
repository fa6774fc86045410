"""What the program needs from its machine: the compile-cache rule, PNG
output with no image package, checkpoints with no Orbax, one card per
launcher rank, the benchmark's peak table, and chip_smoke.py refusing to
run without a GPU."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir_rule(tmp_path, monkeypatch, env_dir):
    """$JAX_COMPILATION_CACHE_DIR wins and no other directory is set;
    without it the cache is the fixed in-checkout .jax_cache."""
    from rtgs_tpu.utils import platform

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", str(tmp_path))
            assert platform.enable_compilation_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = platform.enable_compilation_cache()
            assert path == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            assert os.path.isdir(path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("shape", [(5, 7), (9, 4, 3), (3, 8, 4)])
def test_png_roundtrip(tmp_path, shape):
    from rtgs_tpu.utils.image import decode_png, encode_png, load_image

    arr = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    data = encode_png(arr)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    want = arr if arr.ndim == 3 else arr[..., None]
    np.testing.assert_array_equal(decode_png(data), want)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        (tmp_path / "x.png").write_bytes(data)
        np.testing.assert_allclose(load_image(tmp_path / "x.png"),
                                   arr / 255.0, atol=1e-7)


def _hide_modules(monkeypatch, *names):
    """Make ``import name`` fail for each name (as if not installed)."""
    for name in list(sys.modules):
        if name.split(".")[0] in names:
            monkeypatch.delitem(sys.modules, name)
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


def test_save_image_writes_png_without_image_packages(tmp_path, monkeypatch):
    from rtgs_tpu.utils.image import decode_png, save_image

    _hide_modules(monkeypatch, "PIL", "imageio")
    img = np.random.default_rng(1).uniform(size=(6, 10, 3))
    save_image(tmp_path / "f.png", img)
    assert not (tmp_path / "f.npy").exists()
    got = decode_png((tmp_path / "f.png").read_bytes())
    np.testing.assert_array_equal(
        got, (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))


def test_serve_frame_without_image_packages(tmp_path, monkeypatch):
    """``serve`` answers /frame with a decodable PNG when neither PIL nor
    imageio is installed."""
    import argparse
    import socket
    import threading
    import time
    import urllib.request

    from rtgs_tpu.scene import random_scene
    from rtgs_tpu.utils.image import decode_png
    from rtgs_tpu.viewer import server as vsrv

    _hide_modules(monkeypatch, "PIL", "imageio")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    g = random_scene(jax.random.PRNGKey(3), 32, extent=0.4)
    args = argparse.Namespace(res=(24, 16), fov=90.0, depth=4,
                              renderer="oracle", radius=2.0, port=port)
    threading.Thread(target=vsrv.serve, args=(g, args), daemon=True).start()
    for _ in range(100):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/frame?v=0", timeout=30) as r:
                data = r.read()
            break
        except OSError:
            time.sleep(0.2)
    else:
        raise RuntimeError("server did not come up")
    assert decode_png(data).shape == (16, 24, 3)


def test_checkpoint_roundtrip_without_orbax(tmp_path, monkeypatch, key):
    from rtgs_tpu.camera import camera_from_fov
    from rtgs_tpu.config import TrainConfig
    from rtgs_tpu.render.oracle import render_oracle
    from rtgs_tpu.scene import random_scene
    from rtgs_tpu.train.solver import Solver, init_params

    _hide_modules(monkeypatch, "orbax")
    gt = random_scene(key, 12, extent=0.5)
    cam = camera_from_fov(np.array([0.0, 0.0, 3.0]),
                          np.array([0.0, 0.0, 0.0, 1.0]), (8, 8), 60.0)
    cfg = TrainConfig(densify_from=10**9, opacity_reset_every=0,
                      checkpoint_every=1,
                      checkpoint_dir=str(tmp_path / "ck"))
    solver = Solver(params=init_params(gt), mask=gt.mask, cfg=cfg,
                    cameras=[cam], targets=[render_oracle(gt, cam, depth=4)],
                    depth=4, renderer="oracle")
    solver.train(num_steps=2)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_1.npz", "step_2.npz"]
    saved = jax.tree.map(np.asarray, (solver.params, solver.opt_state))
    solver.train_step()
    solver.restore_checkpoint(str(tmp_path / "ck"), 2)
    assert solver.step == 2
    for a, b in zip(jax.tree.leaves(saved),
                    jax.tree.leaves((solver.params, solver.opt_state))):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_launcher_gives_each_rank_one_card(tmp_path):
    from rtgs_tpu.parallel.launcher import launch, rank_devices

    assert rank_devices({}, 0) == "0" and rank_devices({}, 3) == "3"
    assert rank_devices({"CUDA_VISIBLE_DEVICES": "4,5,6"}, 1) == "5"
    with pytest.raises(ValueError):
        rank_devices({"CUDA_VISIBLE_DEVICES": "2"}, 1)
    code = ("import os, pathlib; pathlib.Path(os.environ['OUT'] + "
            "os.environ['JAX_PROCESS_ID']).write_text("
            "os.environ['CUDA_VISIBLE_DEVICES'])")
    env = dict(os.environ, OUT=str(tmp_path / "rank"))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    assert launch([sys.executable, "-c", code], num_processes=3,
                  coordinator="localhost:0", env=env) == 0
    assert [(tmp_path / f"rank{r}").read_text() for r in range(3)] == [
        "0", "1", "2"]


def test_peak_table_raises_on_unknown_device_kind():
    sys.path.insert(0, str(REPO))
    import bench

    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["flops_bf16"] == 989e12 and peaks["hbm_gbps"] == 3350.0
    with pytest.raises(KeyError):
        bench.device_peaks("cpu")
    with pytest.raises(KeyError):
        bench.device_peaks(jax.devices()[0].device_kind)


def test_chip_smoke_refuses_cpu(tmp_path):
    """Without a GPU the smoke script exits non-zero and prints no result;
    alone in a directory (no package beside it) it fails too."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          env=env, capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=alone)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")
    with pytest.raises(json.JSONDecodeError):
        json.loads(lines[-1] if lines else "")

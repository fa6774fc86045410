"""Keys-only render path: the selection (the Pallas-Triton kernel, here in
interpret mode, or its XLA form) picks per-pixel winner (t1, splat id) keys;
XLA shades + composites the winners and provides the backward by autodiff
(rtgs_tpu/ops/peel.py, rtgs_tpu/render/tiled.py:shade_winners_kp). Must
match the XLA tiled path and the oracle (same selection order, same math,
different execution)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rtgs_tpu.camera import camera_from_fov
from rtgs_tpu.render.oracle import render_oracle
from rtgs_tpu.render.tiled import render_tiled, render_tiled_keys
from rtgs_tpu.scene import random_scene
from rtgs_tpu.viewer.orbit import orbit_camera_pose


def _orbit_cam(res, theta=0.3, phi=1.2, r=3.0, fov=60.0):
    pos, rot, _, _ = orbit_camera_pose(
        theta, phi, r, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    return camera_from_fov(pos, rot, res, fov)


def test_keys_matches_oracle(key):
    from tests._utils import assert_images_close

    g = random_scene(key, 600, extent=1.0)
    cam = _orbit_cam((64, 48))
    img_k = render_tiled_keys(g, cam, depth=16, tile=(16, 16),
                              max_candidates=640, max_global=64)
    img_o = render_oracle(g, cam, depth=16)
    assert_images_close(np.asarray(img_k), np.asarray(img_o))


def test_keys_matches_pallas_path(key):
    """The keys render through the Pallas kernel (interpret mode) against
    the all-candidates XLA tiled path: same selection (ties to the lower
    splat id), different execution."""
    g = random_scene(key, 400, extent=1.0)
    cam = _orbit_cam((48, 32))
    kw = dict(depth=8, tile=(16, 16), max_candidates=512, max_global=32)
    img_k = np.asarray(render_tiled_keys(g, cam, keys_impl="interpret",
                                         **kw))
    img_t = np.asarray(render_tiled(g, cam, **kw))
    assert np.isfinite(img_k).all()
    # Same selection; the shading arithmetic differs in summation order
    # (unrolled fused multiply-adds vs a dot), which the cancellation-
    # sensitive exp(B²/4A − eᵀMe) amplifies to the usual ~1e-4 bulk scale
    # (see tests/_utils.py) — the standard image tolerance applies.
    from tests._utils import assert_images_close

    assert_images_close(img_k, img_t)


def test_keys_bands_identical(key):
    g = random_scene(key, 300, extent=1.0)
    cam = _orbit_cam((64, 48))
    kw = dict(depth=8, tile=(16, 16), max_candidates=384, max_global=32)
    a = np.asarray(render_tiled_keys(g, cam, **kw))
    b = np.asarray(render_tiled_keys(g, cam, tile_bands=3, **kw))
    assert np.array_equal(a, b) or np.abs(a - b).max() < 1e-6


def test_keys_kernel_interpret_matches_xla(key):
    """The Pallas keys kernel (interpret mode) against the lax.sort
    formulation: identical keys incl. vacancy and tie order."""
    from rtgs_tpu.ops.peel import CHUNK, peel_keys_triton, peel_keys_xla
    from rtgs_tpu.render.binning import tile_candidates
    from rtgs_tpu.render.tiled import (_tile_pixel_features, pack_features,
                                       precompute_features)

    g = random_scene(key, 300, extent=1.0)
    # Duplicate a few splats so exact t1 ties exist.
    g = jax.tree.map(
        lambda x: jnp.concatenate([x, x[:32]], axis=0), g)
    cam = _orbit_cam((32, 32))
    binning = tile_candidates(g, cam, tile=(16, 16), max_candidates=384,
                              max_global=32)
    cand = binning.candidates
    pad_c = (-cand.shape[1]) % CHUNK
    cand = jnp.pad(cand, ((0, 0), (0, pad_c)), constant_values=-1)
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, (16, 16))
    t1_p, s_p = peel_keys_triton(packed, cand, pix, 8, interpret=True)
    t1_x, s_x = peel_keys_xla(packed, cand, pix, 8)
    # Splat ids (the actual selection, incl. tie order and vacancies) must
    # be IDENTICAL. t1 may differ in final bits (XLA contracts a·b + c into
    # one fused multiply-add in one program and not in the other), which
    # the discriminant B² − 4AC amplifies at grazing hits: each t1 must lie
    # within its own float32 slack (tests/_utils.py:t1_slack) — ~1e-6
    # relative for a well-conditioned hit.
    from tests._utils import t1_slack

    np.testing.assert_array_equal(np.asarray(s_p).transpose(0, 2, 1),
                                  np.asarray(s_x))
    a, b = np.asarray(t1_p).transpose(0, 2, 1), np.asarray(t1_x)
    fin = np.isfinite(a)
    assert (fin == np.isfinite(b)).all()
    slack = t1_slack(packed, pix, np.asarray(s_x))
    assert (np.abs(a[fin] - b[fin]) <= slack[fin]).all()


@pytest.mark.parametrize("wide", [False, True])
def test_keys_gradients_match_tiled(key, wide):
    """Autodiff through shade_winners must equal autodiff through the
    all-candidates tiled path (identical selection ⇒ identical piecewise-
    smooth function). ``wide``: big scales force the wide fan-out and the
    global list, so winners come from every kind of candidate slot."""
    if wide:
        g = random_scene(key, 300, extent=0.5, scale_range=(0.02, 0.35))
        cam = _orbit_cam((48, 32), r=2.0)
        kw = dict(depth=8, tile=(16, 16), max_candidates=512,
                  max_global=64, bin_narrow=2)
        _, stats = render_tiled_keys(g, cam, with_stats=True, **kw)
        assert int(stats["local_overflow"]) == 0, stats
        assert int(stats["global_overflow"]) == 0, stats
    else:
        g = random_scene(key, 200, extent=1.0)
        cam = _orbit_cam((32, 32))
        kw = dict(depth=8, tile=(16, 16), max_candidates=256, max_global=32)

    def loss_keys(gg):
        return jnp.sum(render_tiled_keys(gg, cam, **kw) ** 2)

    def loss_tiled(gg):
        return jnp.sum(render_tiled(gg, cam, **kw) ** 2)

    gk = jax.grad(loss_keys)(g)
    gt = jax.grad(loss_tiled)(g)
    # Same normalized-quantile tolerance as the cross-implementation grad
    # tests (test_parallel.py): the two paths accumulate per-candidate
    # contributions in different orders (scatter-add of winners vs matmul
    # over candidates), and a grazing-incidence winner can flip validity
    # between the elementwise and matmul quadratic evaluations.
    for name in ["means", "quats", "scales", "colors", "opacities", "sh"]:
        a = np.asarray(getattr(gk, name))
        b = np.asarray(getattr(gt, name))
        assert np.isfinite(a).all(), name
        rel = np.abs(a - b) / (np.abs(b).max() + 1e-8)
        assert np.quantile(rel, 0.99) < 5e-3, (name, np.quantile(rel, 0.99))
        assert rel.max() < 5e-2, (name, rel.max())


def test_keys_with_stats(key):
    g = random_scene(key, 200, extent=1.0)
    cam = _orbit_cam((32, 32))
    img, stats = render_tiled_keys(g, cam, depth=8, max_candidates=256,
                                   max_global=32, with_stats=True)
    assert int(stats["local_overflow"]) == 0
    assert img.shape == (32, 32, 3)


def test_keys_shade_layouts_agree(key):
    """(T,K,P)-layout shading must equal the (T,P,K) form bitwise-ish."""
    g = random_scene(key, 300, extent=1.0)
    cam = _orbit_cam((48, 32))
    kw = dict(depth=8, tile=(16, 16), max_candidates=384, max_global=32)
    a = np.asarray(render_tiled_keys(g, cam, shade_layout="pk", **kw))
    b = np.asarray(render_tiled_keys(g, cam, shade_layout="kp", **kw))
    # Identical selection; summation order differs (lane reduce vs
    # unrolled), exp-amplified through the quadratic — standard image
    # tolerance (see test_keys_matches_pallas_path).
    from tests._utils import assert_images_close

    assert_images_close(a, b)


def test_early_termination_exact(key):
    """The chunk-bound early termination must be EXACT: the Pallas kernel
    fed ``chunk_lb`` returns bitwise-identical keys to the bound-free full
    sweep, and the bound itself must be sound — every candidate in chunk c
    or later has t1 >= chunk_lb[c]."""
    from rtgs_tpu.ops.peel import (CHUNK, peel_keys_triton, _gather,
                                   _intersect_t1)
    from rtgs_tpu.render.binning import tile_candidates
    from rtgs_tpu.render.tiled import (_tile_pixel_features, pack_features,
                                       precompute_features)

    # Deep scene: enough splats per tile that several chunks exist.
    g = random_scene(key, 3000, extent=0.6, scale_range=(0.01, 0.06))
    cam = _orbit_cam((32, 32), r=2.0)
    binning = tile_candidates(g, cam, tile=(16, 16), max_candidates=1024,
                              max_global=64, chunk=CHUNK)
    cand = binning.candidates
    assert cand.shape[1] % CHUNK == 0
    lb = binning.chunk_lb
    assert lb is not None and lb.shape == (cand.shape[0],
                                           cand.shape[1] // CHUNK + 1)
    # Need multi-chunk tiles for the test to mean anything.
    assert int(jnp.max(jnp.sum(cand >= 0, axis=1))) > CHUNK

    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, (16, 16))

    # Soundness: t1 of every candidate >= the suffix bound of its chunk.
    gathered, _ = _gather(packed, cand)
    t1 = _intersect_t1(gathered, pix)                # (T, P, C)
    t1 = np.asarray(jnp.min(t1, axis=1))             # (T, C) min over pixels
    lb_np = np.asarray(lb)
    nch = cand.shape[1] // CHUNK
    for c in range(nch):
        suffix = t1[:, c * CHUNK:]
        viol = suffix < lb_np[:, c:c + 1] - 1e-5
        assert not viol.any(), f"chunk {c}: bound violated"

    t1_full, sid_full = peel_keys_triton(packed, cand, pix, 8,
                                         chunk_lb=None, interpret=True)
    t1_et, sid_et = peel_keys_triton(packed, cand, pix, 8, chunk_lb=lb,
                                     interpret=True)
    np.testing.assert_array_equal(np.asarray(sid_full), np.asarray(sid_et))
    np.testing.assert_array_equal(np.asarray(t1_full), np.asarray(t1_et))


def test_keys_grad_through_pallas_impl(key):
    """Regression: jax.grad through the PALLAS keys kernel.

    The early-termination bounds (``chunk_lb``) derive from the scene via
    the binning, so without a stop_gradient they drag a JVP into the
    non-differentiable ``pallas_call`` (NotImplementedError — on the GPU
    ``keys_impl='auto'`` picks the kernel while every CPU test picks the
    XLA form). ``keys_impl='interpret'`` makes the suite cover the GPU
    dispatch path; selection is identical so the gradient must match the
    XLA-impl gradient exactly up to accumulation order."""
    g = random_scene(key, 200, extent=1.0)
    cam = _orbit_cam((32, 32))
    kw = dict(depth=8, tile=(16, 16), max_candidates=256, max_global=32)

    def loss(impl):
        def f(gg):
            return jnp.sum(render_tiled_keys(
                gg, cam, keys_impl=impl, **kw) ** 2)
        return f

    gp = jax.grad(loss("interpret"))(g)
    gx = jax.grad(loss("xla"))(g)
    for name in ["means", "quats", "scales", "colors", "opacities", "sh"]:
        a = np.asarray(getattr(gp, name))
        b = np.asarray(getattr(gx, name))
        assert np.isfinite(a).all(), name
        rel = np.abs(a - b) / (np.abs(b).max() + 1e-8)
        assert rel.max() < 1e-4, (name, rel.max())


@pytest.mark.parametrize("n,scales", [(20, (0.005, 0.05)),
                                      (600, (0.1, 0.3))])
def test_shade_vjp_matches_autodiff(key, n, scales):
    """The hand-written shading VJP (one dense cotangent stack, scatter-
    added per splat) equals autodiff of the same forward, for random
    cotangents on every layer: with 20 small splats nearly every winner
    slot is vacant (the sentinel row), with 600 large ones most are
    filled."""
    from rtgs_tpu.ops.peel import peel_keys
    from rtgs_tpu.render.binning import tile_candidates
    from rtgs_tpu.render.tiled import (_shade_kp_impl, _tile_pixel_features,
                                       pack_features, precompute_features,
                                       shade_winners_kp)

    g = random_scene(key, n, extent=1.0, scale_range=scales)
    cam = _orbit_cam((32, 32))
    b = tile_candidates(g, cam, tile=(16, 16), max_candidates=640,
                        max_global=64)
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, (16, 16))
    _, sid = peel_keys(packed, b.candidates, pix, 8, out_layout="kp")
    vacant = float(np.mean(~np.isfinite(np.asarray(sid))))
    assert (vacant > 0.9) if n == 20 else (vacant < 0.5), vacant

    out, vjp_custom = jax.vjp(lambda x: shade_winners_kp(x, sid, pix),
                              packed)
    _, vjp_auto = jax.vjp(lambda x: _shade_kp_impl(x, sid, pix)[0], packed)
    cots = tuple(jax.random.normal(jax.random.fold_in(key, i), o.shape)
                 for i, o in enumerate(out))
    (d_custom,), (d_auto,) = vjp_custom(cots), vjp_auto(cots)
    # Row N is the sentinel, whose gradient the renderer discards.
    a, b = np.asarray(d_custom)[:n], np.asarray(d_auto)[:n]
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=1e-4,
                               atol=1e-5 * np.abs(b).max())


def test_banded_gradients_match_unbanded(key):
    """jax.grad through the BANDED path (lax.map + jax.checkpoint remat —
    the 1M@1080p program family) must match
    the unbanded gradient: banding partitions tiles, nothing else."""
    g = random_scene(key, 400, extent=0.8, scale_range=(0.01, 0.06))
    cam = _orbit_cam((48, 48))
    kw = dict(depth=8, tile=(16, 16), max_candidates=256, max_global=32)

    def loss(bands):
        def f(gg):
            return jnp.sum(render_tiled_keys(
                gg, cam, tile_bands=bands, **kw) ** 2)
        return f

    gb = jax.grad(loss(3))(g)
    gu = jax.grad(loss(None))(g)
    # Not exact: per-band scatter-adds accumulate partial per-splat sums
    # that the unbanded path adds in one pass — a floating-point
    # reassociation, amplified where a splat's contributions nearly
    # cancel (quats). Same normalized-quantile tolerance as the other
    # cross-implementation gradient tests.
    for name in ["means", "quats", "scales", "colors", "opacities", "sh"]:
        a = np.asarray(getattr(gb, name))
        b = np.asarray(getattr(gu, name))
        assert np.isfinite(a).all(), name
        rel = np.abs(a - b) / (np.abs(b).max() + 1e-8)
        assert np.quantile(rel, 0.99) < 5e-4, (name, np.quantile(rel, 0.99))
        assert rel.max() < 5e-3, (name, rel.max())

"""Oracle renderer tests: analytic single-Gaussian scenes with hand-computed
radiance, equivalence of the top-K formulation to the literal depth-peel loop
(the executable proof that one fused pass == the reference's iterative
peeling), masking, and ordering."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rtgs_tpu import gaussians as G
from rtgs_tpu.camera import new_camera
from rtgs_tpu.rays import new_rays
from rtgs_tpu.render.oracle import (
    composite_rays,
    render_oracle,
    render_peeled_reference,
)
from rtgs_tpu.scene import pad_scene, random_scene


def _single_gaussian_expected(opacity, color, t_mid=None):
    """A unit Gaussian at distance z0 on the ray axis: α = opacity·exp(−(C+3
    −B²/4A)) evaluated at the chord midpoint = center ⇒ ρ = 1."""
    return opacity * np.asarray(color)


def test_single_gaussian_on_axis():
    g = G.new_gaussians(
        means=[[0.0, 0.0, -5.0]], colors=[[0.2, 0.5, 0.9]], opacities=[0.6])
    rays = new_rays([[0.0, 0.0, 0.0]], [[0.0, 0.0, -1.0]])
    radiance, trans = composite_rays(g, rays, depth=4)
    # Ray passes through the center: midpoint = center, ρ = 1, α = 0.6.
    np.testing.assert_allclose(
        radiance[0], 0.6 * np.array([0.2, 0.5, 0.9]), rtol=1e-5)
    np.testing.assert_allclose(trans[0], 0.4, rtol=1e-5)


def test_single_gaussian_off_axis():
    """Ray passes at perpendicular distance 1 from a unit Gaussian: the chord
    midpoint is the closest point, ρ = exp(−1)."""
    g = G.new_gaussians(means=[[1.0, 0.0, -5.0]], opacities=[0.8])
    rays = new_rays([[0.0, 0.0, 0.0]], [[0.0, 0.0, -1.0]])
    radiance, trans = composite_rays(g, rays, depth=4)
    alpha = 0.8 * np.exp(-1.0)
    np.testing.assert_allclose(trans[0], 1 - alpha, rtol=1e-5)
    np.testing.assert_allclose(
        radiance[0], alpha * np.array([1.0, 0.0, 1.0]), rtol=1e-5)


def test_two_gaussians_ordering():
    """Front-to-back: near Gaussian composited first regardless of array
    order."""
    colors = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
    for order in ([0, 1], [1, 0]):
        means = np.array([[0.0, 0.0, -3.0], [0.0, 0.0, -7.0]])[order]
        g = G.new_gaussians(
            means=means, colors=np.array(colors)[order], opacities=[0.5, 0.5])
        rays = new_rays([[0.0, 0.0, 0.0]], [[0.0, 0.0, -1.0]])
        radiance, trans = composite_rays(g, rays, depth=4)
        # red at -3 first: 0.5·red + 0.5·0.5·green.
        np.testing.assert_allclose(
            radiance[0], [0.5, 0.25, 0.0], atol=1e-5)
        np.testing.assert_allclose(trans[0], 0.25, rtol=1e-5)


def test_depth_truncation():
    """depth=1 composites only the nearest layer (ray_tracer.py:50-54)."""
    g = G.new_gaussians(
        means=[[0.0, 0.0, -3.0], [0.0, 0.0, -7.0]],
        colors=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
        opacities=[0.5, 0.5])
    rays = new_rays([[0.0, 0.0, 0.0]], [[0.0, 0.0, -1.0]])
    radiance, _ = composite_rays(g, rays, depth=1)
    np.testing.assert_allclose(radiance[0], [0.5, 0.0, 0.0], atol=1e-6)


def test_ray_start_excludes_behind():
    """Hits require t1 > start (open interval, scene.py:433): a Gaussian
    behind the origin is ignored."""
    g = G.new_gaussians(means=[[0.0, 0.0, 5.0]])  # behind (camera looks −z)
    rays = new_rays([[0.0, 0.0, 0.0]], [[0.0, 0.0, -1.0]])
    radiance, trans = composite_rays(g, rays, depth=4)
    np.testing.assert_allclose(radiance[0], [0, 0, 0.0], atol=1e-7)
    np.testing.assert_allclose(trans[0], 1.0)


def test_straddling_origin_excluded():
    """A Gaussian straddling the origin has t1 < 0 < t2 — the reference
    rejects it (t1 must exceed start=0), and so do we."""
    g = G.new_gaussians(means=[[0.0, 0.0, -0.5]])  # t1 = -0.5-√3 < 0
    rays = new_rays([[0.0, 0.0, 0.0]], [[0.0, 0.0, -1.0]])
    radiance, trans = composite_rays(g, rays, depth=4)
    np.testing.assert_allclose(radiance[0], [0, 0, 0.0], atol=1e-7)


def test_mask_excludes_padding(key):
    g = random_scene(key, 37, extent=1.0)
    gp = pad_scene(g, 64)
    assert gp.num == 64
    rays = new_rays(
        np.tile([0, 0, 3.0], (8, 1)),
        np.tile([0, 0, -1.0], (8, 1)))
    r1, t1 = composite_rays(g, rays, depth=8)
    r2, t2 = composite_rays(gp, rays, depth=8)
    np.testing.assert_allclose(r1, r2, atol=1e-6)
    np.testing.assert_allclose(t1, t2, atol=1e-6)


def test_topk_equals_literal_peel(key):
    """THE parity theorem: single-pass top-K compositing == the reference's
    iterative peel loop, on a random scene from random viewpoints."""
    g = random_scene(key, 100, extent=1.0)
    k1, k2 = jax.random.split(key)
    origins = jax.random.uniform(k1, (32, 3), minval=-3, maxval=3)
    dirs = -origins / jnp.linalg.norm(origins, axis=-1, keepdims=True)
    rays = new_rays(origins, dirs)
    r_topk, t_topk = composite_rays(g, rays, depth=16)
    r_peel, t_peel = render_peeled_reference(g, rays, depth=16)
    np.testing.assert_allclose(r_topk, r_peel, atol=2e-5)
    np.testing.assert_allclose(t_topk, t_peel, atol=2e-5)


def test_sh_view_dependence(key):
    """SH color uses the normalized ray direction (gaussian.py:199-200):
    different view directions give different colors."""
    sh = np.zeros((1, 15, 3), np.float32)
    sh[0, 0, 0] = 1.0  # y_10 ∝ dir.y on the red channel
    g = G.new_gaussians(
        means=[[0.0, 0.0, 0.0]], colors=[[0.3, 0.3, 0.3]], sh=sh)
    d = np.array([0.0, 0.6, -0.8], np.float32)
    rays = new_rays([(-5 * d).tolist()], [d.tolist()])
    radiance, _ = composite_rays(g, rays, depth=1)
    expected_red = 0.3 + 0.5 * G.C_0 * 0.6
    np.testing.assert_allclose(radiance[0, 0], expected_red, rtol=1e-5)
    np.testing.assert_allclose(radiance[0, 1], 0.3, rtol=1e-5)


def test_render_oracle_full_frame(key):
    """Smoke + shape test of the chunked full-frame path, and chunking
    invariance."""
    g = random_scene(key, 50, extent=0.5)
    cam = new_camera([0, 0, 2.0], [0, 0, 0, 1], (16, 12), (10.0, 10.0))
    img = render_oracle(g, cam, depth=8)
    assert img.shape == (16, 12, 3)
    assert np.isfinite(np.asarray(img)).all()
    img2 = render_oracle(g, cam, depth=8, pixel_chunk=7)
    np.testing.assert_allclose(img, img2, atol=1e-6)


def test_gradients_finite(key):
    """Autodiff through the full composite: gradients exist and are finite
    for every parameter (the capability the reference's stub solver never
    had)."""
    g = random_scene(key, 20, extent=0.5)
    rays = new_rays(
        np.tile([0, 0, 2.0], (4, 1)), np.tile([0, 0, -1.0], (4, 1)))

    def loss(g):
        radiance, _ = composite_rays(g, rays, depth=8)
        return jnp.sum(radiance ** 2)

    grads = jax.grad(loss)(g)
    for name, arr in grads._asdict().items():
        assert np.isfinite(np.asarray(arr)).all(), f"non-finite grad in {name}"
    # At least means/colors/opacities should have nonzero gradient.
    assert np.abs(np.asarray(grads.colors)).sum() > 0
    assert np.abs(np.asarray(grads.opacities)).sum() > 0
    assert np.abs(np.asarray(grads.means)).sum() > 0


@pytest.mark.parametrize("pixel_chunk", [7, 64, 100])
def test_frame_gradients_finite_with_padded_chunks(key, pixel_chunk):
    """The full-frame oracle's gradient is finite and independent of the
    pixel chunking, including chunkings that pad the last chunk (16·12 =
    192 rays: 7 pads 4, 64 pads none, 100 pads 8). Padding rays with zero
    directions once made the hit quadratic 0/0 there, and the dropped
    pixels' NaN partials reached every geometric gradient."""
    g = random_scene(key, 50, extent=0.5)
    cam = new_camera([0, 0, 2.0], [0, 0, 0, 1], (16, 12), (10.0, 10.0))

    def grads(chunk):
        return jax.grad(lambda x: jnp.sum(render_oracle(
            x, cam, depth=8, pixel_chunk=chunk) ** 2))(g)

    ref, got = grads(None), grads(pixel_chunk)
    for name, arr in got._asdict().items():
        assert np.isfinite(np.asarray(arr)).all(), f"non-finite grad in {name}"
        np.testing.assert_allclose(arr, getattr(ref, name), rtol=1e-4,
                                   atol=1e-5, err_msg=name)

"""Brute-force O(N·rays) oracle renderer — the executable parity contract.

This is the reference renderer's semantics re-expressed as one batched,
differentiable JAX program. The reference peels depth layers with one kernel
launch per layer, re-traversing a BVH each time
(the reference's ``src/rtgs/ray_tracer.py:79-104``); here the same result is
computed in a single fused pass: intersect **all** Gaussians, take the K
nearest entry points with ``lax.top_k``, and alpha-composite front-to-back
with an exclusive cumulative product for transmittance.

Two implementations live here:

* :func:`composite_rays` / :func:`render_oracle` — the top-K formulation.
  This is the oracle every production kernel is validated against, and it is
  differentiable end-to-end (gradient flows through the top-K gather).
* :func:`render_peeled_reference` — a literal re-enactment of the reference's
  iterative peel loop (argmin per step, ``start = t1 + 1e-8`` advance,
  ``ray_tracer.py:100-104``), used in tests to prove the two formulations
  agree.

Compositing contract (``ray_tracer.py:90-104``):
  * hits accepted iff ``t1 ∈ (start, end)`` open interval (``scene.py:433``),
  * evaluation point is the interval midpoint ``(t1+t2)/2``,
  * ``sample += T · α · rgb; T *= 1 − α``,
  * exactly ``depth`` layers composited, no transmittance early-out.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rtgs_tpu import gaussians as G
from rtgs_tpu.camera import Camera, generate_ray_grid
from rtgs_tpu.rays import Rays

# The reference's peel advance epsilon (``ray_tracer.py:100``).
PEEL_EPS = 1e-8


def _safe_midpoint_alpha(gathered_cov_inv, gathered_means, gathered_opac,
                         origins, directions, t1, t2, valid):
    """Literal midpoint evaluation (``ray_tracer.py:90-92`` +
    ``gaussian.py:183-198``) with NaN-safe guards for inf/invalid entries.

    ``origins``/``directions`` must already broadcast against ``t1``'s shape
    plus a trailing (3,).
    """
    tbar = 0.5 * (t1 + t2)
    finite = jnp.isfinite(tbar)
    tbar_safe = jnp.where(valid & finite, tbar, 0.0)
    pos = origins + tbar_safe[..., None] * directions
    d = pos - gathered_means
    # HIGHEST: ρ's exponent subtracts ~equal magnitudes; bf16 or TF32
    # matmul inputs here break the oracle at high density (see
    # gaussians.hit).
    md = jnp.einsum("...ij,...j->...i", gathered_cov_inv, d,
                    precision=jax.lax.Precision.HIGHEST)
    rho = jnp.exp(-jnp.sum(d * md, axis=-1))
    alpha = gathered_opac * rho
    # Δ == 0 gives t2 = inf → ρ = exp(-inf) = 0 in the reference; replicate.
    return jnp.where(valid & finite, alpha, 0.0)


def topk_hits(g: G.Gaussians, rays: Rays, k: int):
    """Intersect a flat ray bundle with all Gaussians and keep the K nearest
    accepted hits per ray, ascending by entry depth t1.

    Returns ``(t1 (P, K), alpha (P, K), rgb (P, K, 3))`` — misses padded with
    ``t1 = inf, alpha = 0``. This is the per-shard primitive of the
    primitive-sharded ring renderer (``parallel/render.py``): K-lists from
    different shards merge by t1 into exactly the global K-list.
    """
    cov_inv = G.inv_covariance(g.quats, g.scales)  # (N, 3, 3)

    # Intersections of every ray with every Gaussian: (P, N).
    t1, t2 = G.hit(
        cov_inv,
        g.means,
        rays.origins[..., None, :],
        rays.directions[..., None, :],
    )
    live = g.mask > 0
    valid = (
        (t1 > rays.starts[..., None])
        & (t1 < rays.ends[..., None])
        & live
    )

    # K nearest entry points, ascending t1; invalid sorted to the back.
    neg = jnp.where(valid, -t1, -jnp.inf)
    kk = min(k, g.num)
    vals, idx = jax.lax.top_k(neg, kk)  # (P, K')
    valid_k = vals > -jnp.inf
    t1_k = jnp.where(valid_k, -vals, jnp.inf)
    t2_k = jnp.take_along_axis(t2, idx, axis=-1)

    # Gather the selected Gaussians' parameters.
    g_cov_inv = cov_inv[idx]          # (P, K', 3, 3)
    g_means = g.means[idx]            # (P, K', 3)
    g_colors = g.colors[idx]
    g_opac = g.opacities[idx]
    g_sh = g.sh[idx]                  # (P, K', 15, 3)

    alpha = _safe_midpoint_alpha(
        g_cov_inv, g_means, g_opac,
        rays.origins[..., None, :], rays.directions[..., None, :],
        t1_k, t2_k, valid_k)

    # View-dependent color: base + SH(normalized dir) (``gaussian.py:199-200``).
    dirs = rays.directions / jnp.linalg.norm(
        rays.directions, axis=-1, keepdims=True)
    rgb = g_colors + G.eval_sh(g_sh, dirs[..., None, :])  # (P, K', 3)
    rgb = jnp.where(valid_k[..., None], rgb, 0.0)

    if kk < k:  # scene smaller than K: pad the lists
        pad = k - kk
        t1_k = jnp.pad(t1_k, ((0, 0),) * (t1_k.ndim - 1) + ((0, pad),),
                       constant_values=jnp.inf)
        alpha = jnp.pad(alpha, ((0, 0),) * (alpha.ndim - 1) + ((0, pad),))
        rgb = jnp.pad(rgb, ((0, 0),) * (rgb.ndim - 2) + ((0, pad), (0, 0)))
    return t1_k, alpha, rgb


def composite_hits(t1, alpha, rgb):
    """Front-to-back compositing of depth-ascending hit lists
    (``ray_tracer.py:96-98``): exclusive-cumprod transmittance.

    Returns (radiance (..., 3), transmittance (...,)).
    """
    del t1  # order is already ascending; alpha = 0 marks misses
    one_minus = 1.0 - alpha
    # Exclusive cumulative product: T_k = Π_{j<k} (1 − α_j).
    trans = jnp.concatenate(
        [jnp.ones_like(alpha[..., :1]),
         jnp.cumprod(one_minus[..., :-1], axis=-1)], axis=-1)
    radiance = jnp.sum((trans * alpha)[..., None] * rgb, axis=-2)
    transmittance = jnp.prod(one_minus, axis=-1)
    return radiance, transmittance


@partial(jax.jit, static_argnames=("depth",))
def composite_rays(g: G.Gaussians, rays: Rays, depth: int = 16):
    """Render a flat bundle of rays against all Gaussians, brute force.

    Args:
      g: the Gaussian scene (any N).
      rays: flat ray bundle with leading shape (P,).
      depth: number of composited layers K (reference default 16,
        ``__main__.py:70``).

    Returns:
      (radiance (P, 3), transmittance (P,)) after K layers.
    """
    return composite_hits(*topk_hits(g, rays, depth))


def render_oracle(g: G.Gaussians, camera: Camera, depth: int = 16,
                  pixel_chunk: int | None = None,
                  pixel_offset=None) -> jnp.ndarray:
    """Full-frame brute-force render. Returns (W, H, 3) radiance, matching
    the reference's converged display buffer (``ray_tracer.py:68-77`` with all
    samples identical — the reference casts deterministic pixel-center rays,
    so every sample is the same image)."""
    w, h = camera.buf_size
    rays = generate_ray_grid(camera, pixel_offset).reshape(w * h)
    p = w * h
    if pixel_chunk is None:
        # Bound the (chunk × N) intersection matrix to ~32M elements.
        pixel_chunk = max(64, min(p, (1 << 25) // max(g.num, 1)))
    n_chunks = -(-p // pixel_chunk)
    pad = n_chunks * pixel_chunk - p
    # Pad with copies of the last ray, not zeros: a zero direction makes
    # the hit quadratic 0/0, and although the padded pixels are dropped,
    # their NaN partials times a zero cotangent would poison the gradient.
    rays_p = jax.tree.map(
        lambda x: jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                          mode="edge"), rays)
    chunked = jax.tree.map(
        lambda x: x.reshape((n_chunks, pixel_chunk) + x.shape[1:]), rays_p)
    radiance, _ = jax.lax.map(
        lambda r: composite_rays(g, r, depth=depth), chunked)
    return radiance.reshape(-1, 3)[:p].reshape(w, h, 3)


def render_peeled_reference(g: G.Gaussians, rays: Rays, depth: int = 16):
    """Direct re-enactment of the reference's per-launch depth peeling
    (``ray_tracer.py:39-54,79-104``): per step, find the single nearest
    un-consumed Gaussian per ray (argmin of t1 over N, brute force instead of
    the BVH — equivalent because the 3σ AABB is conservative), composite it,
    then advance ``start = t1 + 1e-8`` (miss → ``start = inf``).

    O(depth · N · P); used only in tests to pin the top-K formulation.
    Returns (radiance (P, 3), transmittance (P,)).
    """
    cov_inv = G.inv_covariance(g.quats, g.scales)
    live = g.mask > 0
    dirs_n = rays.directions / jnp.linalg.norm(
        rays.directions, axis=-1, keepdims=True)

    def step(carry, _):
        starts, radiance, trans = carry
        t1, t2 = G.hit(
            cov_inv, g.means,
            rays.origins[..., None, :], rays.directions[..., None, :])
        valid = (t1 > starts[..., None]) & (t1 < rays.ends[..., None]) & live
        t1m = jnp.where(valid, t1, jnp.inf)
        idx = jnp.argmin(t1m, axis=-1)  # (P,)
        hit_any = jnp.take_along_axis(t1m, idx[..., None], -1)[..., 0] < jnp.inf
        t1_h = jnp.take_along_axis(t1, idx[..., None], -1)[..., 0]
        t2_h = jnp.take_along_axis(t2, idx[..., None], -1)[..., 0]
        alpha = _safe_midpoint_alpha(
            cov_inv[idx], g.means[idx], g.opacities[idx],
            rays.origins, rays.directions, t1_h, t2_h, hit_any)
        rgb = g.colors[idx] + G.eval_sh(g.sh[idx], dirs_n)
        radiance = radiance + (trans * alpha)[..., None] * rgb
        trans = trans * (1.0 - alpha)
        starts = jnp.where(hit_any, t1_h + PEEL_EPS, jnp.inf)
        return (starts, radiance, trans), None

    p = rays.starts.shape
    init = (rays.starts, jnp.zeros(p + (3,), jnp.float32), jnp.ones(p, jnp.float32))
    (_, radiance, trans), _ = jax.lax.scan(step, init, None, length=depth)
    return radiance, trans

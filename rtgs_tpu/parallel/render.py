"""Multi-device rendering: ray data-parallelism × primitive ring sharding.

Structure (SURVEY.md §5 "long-context equivalent"): rays are stationary
queries sharded over the ``rays`` mesh axis; the Gaussian SoA is sharded over
``prims`` and rotated around the ring with ``ppermute`` (XLA hands this to
NCCL over NVLink). Each ring step computes the local shard's top-K nearest hits per ray
and merges them into the running K-list by entry depth — an online,
depth-sorted merge that is exactly equivalent to a global top-K, so the
sharded render is bit-comparable to the single-device oracle (up to f32 and
equal-t1 tie order).

Differentiable end-to-end: JAX transposes ``ppermute`` (reverse ring) and the
top-K gathers, so parameter gradients flow back to the shard that owns each
Gaussian; gradients of replicated quantities are ``psum``-reduced by
``shard_map``'s partitioning rules automatically.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rtgs_tpu import gaussians as G
from rtgs_tpu.parallel.mesh import PRIMS_AXIS, RAYS_AXIS
from rtgs_tpu.rays import Rays
from rtgs_tpu.render.oracle import topk_hits, composite_hits
from rtgs_tpu.scene import pad_scene


def shard_scene(g: G.Gaussians, mesh: Mesh) -> G.Gaussians:
    """Pad N to the prims-axis size and place the SoA with its leading axis
    sharded over ``prims`` (replicated over ``rays``)."""
    n_prims = mesh.shape[PRIMS_AXIS]
    g = pad_scene(g, n_prims)
    spec = NamedSharding(mesh, P(PRIMS_AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, spec), g)


def _merge_topk(best, new, k):
    """Merge two per-ray K-lists, keeping the K nearest by t1."""
    t1 = jnp.concatenate([best[0], new[0]], axis=-1)       # (p, 2K)
    alpha = jnp.concatenate([best[1], new[1]], axis=-1)
    rgb = jnp.concatenate([best[2], new[2]], axis=-2)      # (p, 2K, 3)
    vals, idx = jax.lax.top_k(-t1, k)
    return (
        -vals,
        jnp.take_along_axis(alpha, idx, axis=-1),
        jnp.take_along_axis(rgb, idx[..., None], axis=-2),
    )


def _ring_body(rays: Rays, depth: int, n_prims: int):
    def step(carry, _):
        g_shard, best = carry
        new = topk_hits(g_shard, rays, depth)
        best = _merge_topk(best, new, depth)
        if n_prims > 1:
            perm = [(j, (j + 1) % n_prims) for j in range(n_prims)]
            g_shard = jax.tree.map(
                lambda x: jax.lax.ppermute(x, PRIMS_AXIS, perm), g_shard)
        return (g_shard, best), None

    return step


@partial(jax.jit, static_argnames=("depth", "mesh"))
def render_sharded(g: G.Gaussians, rays: Rays, depth: int, mesh: Mesh):
    """Render a flat ray bundle on a ``(rays, prims)`` mesh.

    Test/oracle use only — this fans the O(N·P) brute-force oracle around
    the ring and cannot scale. Production rendering goes through
    :func:`render_tiled_sharded` (per-shard binning + keys top-K + ring
    merge); this entry point stays as the cross-device parity oracle for
    it.

    Args:
      g: scene sharded over ``prims`` (see :func:`shard_scene`); N must be a
        multiple of the prims-axis size.
      rays: flat bundle; leading dim must be a multiple of the rays-axis
        size.
      depth: composited layers K.
      mesh: the device mesh.

    Returns:
      (radiance (P, 3), transmittance (P,)), sharded over ``rays``.
    """
    n_prims = mesh.shape[PRIMS_AXIS]

    def local(g_shard, rays_local):
        p = rays_local.starts.shape[0]
        best = (
            jnp.full((p, depth), jnp.inf, jnp.float32),
            jnp.zeros((p, depth), jnp.float32),
            jnp.zeros((p, depth, 3), jnp.float32),
        )
        # The scan carry becomes varying over both mesh axes (it mixes the
        # rays-sharded queries with the prims-sharded scene); mark the
        # literal-initialized carry accordingly for shard_map's vma typing.
        best = jax.tree.map(
            lambda x: jax.lax.pcast(x, (RAYS_AXIS, PRIMS_AXIS),
                                    to="varying"), best)
        (_, best), _ = jax.lax.scan(
            _ring_body(rays_local, depth, n_prims),
            (g_shard, best), None, length=n_prims)
        radiance, trans = composite_hits(*best)
        return radiance, trans

    # After the full ring every prims-rank holds the identical merged K-list,
    # so the output *is* replicated over ``prims``; shard_map's varying-axis
    # type system cannot prove that invariant statically (there is
    # deliberately no varying→invariant cast), hence check_vma=False.
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(PRIMS_AXIS), P(RAYS_AXIS)),
        out_specs=P(RAYS_AXIS),
        check_vma=False,
    )(g, rays)


def _merge_layers(best, new, k):
    """Merge per-pixel layer K-lists (t1 first) keeping the K nearest."""
    cat = [jnp.concatenate([b, n], axis=-1) for b, n in zip(best, new)]
    _, idx = jax.lax.top_k(-cat[0], k)
    return tuple(jnp.take_along_axis(x, idx, axis=-1) for x in cat)


@partial(jax.jit, static_argnames=(
    "depth", "mesh", "tile", "max_candidates", "max_global", "bin_narrow"))
def render_tiled_sharded(
    g: G.Gaussians,
    camera,
    mesh: Mesh,
    depth: int = 16,
    tile=(16, 16),
    max_candidates: int = 256,
    max_global: int = 64,
    bin_narrow: int | None = None,
):
    """Production multi-device render: screen tiles data-parallel over the
    ``rays`` axis × a ``ppermute`` ring over primitive shards, running the
    **same keys architecture as the single-device path** per shard (the
    program family being benchmarked IS the one being sharded).

    Per ring step each rays-rank: bins the current prim shard into its
    local tiles' candidate lists (with the early-termination chunk
    bounds), selects per-pixel K nearest (t1, local splat id) keys with
    :func:`rtgs_tpu.ops.peel.peel_keys` (the Triton keys kernel on the
    GPU, the lex-sort XLA form elsewhere), shades ONLY those winners with
    :func:`rtgs_tpu.render.tiled.shade_winners` (differentiable; the ring
    therefore carries 5 (T, P, K) layer arrays — t1/α/r/g/b — not the
    payload of every candidate), and merges them by entry depth into the
    running K-list — exactly the global top-K after the full ring
    (SURVEY.md §5: stationary queries = rays, rotating keys = primitives;
    merge rule per the reference ``scene.py:429-437``). One XLA composite
    at the end. Differentiable end-to-end: selection is piecewise-constant
    (stop_gradient), winner shading carries parameter gradients via its
    custom VJP, and JAX transposes ``ppermute`` to route each shard's
    gradients back to its owner.

    Returns (W, H, 3) radiance, replicated over ``prims``, tile-sharded over
    ``rays``.
    """
    from rtgs_tpu.render.binning import tile_candidates
    from rtgs_tpu.render.tiled import (
        _tile_pixel_features, pack_features, precompute_features,
        shade_winners)
    from rtgs_tpu.render.oracle import composite_hits
    from rtgs_tpu.ops.peel import peel_keys, CHUNK

    n_prims = mesh.shape[PRIMS_AXIS]
    n_rays = mesh.shape[RAYS_AXIS]
    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    num_tiles = ntx * nty
    t_local = -(-num_tiles // n_rays)
    t_pad = t_local * n_rays - num_tiles

    pix = _tile_pixel_features(camera, tile)          # (T, P, G)
    if t_pad:
        pix = jnp.pad(pix, ((0, t_pad), (0, 0), (0, 0)))
    p = pix.shape[1]

    def local(g_shard, pix_local):
        rank = jax.lax.axis_index(RAYS_AXIS)
        shape = (t_local, p, depth)
        best = (jnp.full(shape, jnp.inf, jnp.float32),) + tuple(
            jnp.zeros(shape, jnp.float32) for _ in range(4))
        best = jax.tree.map(
            lambda x: jax.lax.pcast(x, (RAYS_AXIS, PRIMS_AXIS),
                                    to="varying"), best)

        def step(carry, _):
            g_shard, best = carry
            binning = tile_candidates(
                g_shard, camera, tile=tile, max_candidates=max_candidates,
                max_global=max_global, narrow=bin_narrow, chunk=CHUNK)
            cand = binning.candidates
            lb = binning.chunk_lb
            if t_pad:
                cand = jnp.pad(cand, ((0, t_pad), (0, 0)),
                               constant_values=-1)
                lb = jnp.pad(lb, ((0, t_pad), (0, 0)),
                             constant_values=jnp.inf)
            cand_local = jax.lax.dynamic_slice_in_dim(
                cand, rank * t_local, t_local, 0)
            lb_local = jax.lax.dynamic_slice_in_dim(
                lb, rank * t_local, t_local, 0)
            packed = pack_features(precompute_features(g_shard, camera))
            t1_k, sid_k = peel_keys(packed, cand_local, pix_local, depth,
                                    chunk_lb=lb_local)
            a_k, r_k, g_k, b_k = shade_winners(packed, sid_k, pix_local)
            best = _merge_layers(best, (t1_k, a_k, r_k, g_k, b_k), depth)
            if n_prims > 1:
                perm = [(j, (j + 1) % n_prims) for j in range(n_prims)]
                g_shard = jax.tree.map(
                    lambda x: jax.lax.ppermute(x, PRIMS_AXIS, perm),
                    g_shard)
            return (g_shard, best), None

        (_, best), _ = jax.lax.scan(step, (g_shard, best), None,
                                    length=n_prims)
        t1_k, alpha_k, r_k, g_k, b_k = best
        rgb_k = jnp.stack([r_k, g_k, b_k], axis=-1)    # (T_l, P, K, 3)
        rad, _trans = composite_hits(t1_k, alpha_k, rgb_k)
        return rad                                     # (T_l, P, 3)

    rad = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(PRIMS_AXIS), P(RAYS_AXIS)),
        out_specs=P(RAYS_AXIS),
        check_vma=False,
    )(g, pix)                                          # (T_pad_total, P, 3)

    rad = rad[:num_tiles]
    img = (
        rad.reshape(ntx, nty, tw, th, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(ntx * tw, nty * th, 3))
    return img[:w, :h]

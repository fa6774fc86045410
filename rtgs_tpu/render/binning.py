"""Screen-tile candidate binning — the renderer's acceleration structure.

The reference accelerates ray casts with a pointer-based SAH BVH traversed by
a per-thread stack (``/root/reference/src/rtgs/scene.py:162-450``) — a
GPU/Taichi idiom that is hostile to XLA (data-dependent pointer chasing,
dynamic trip counts). The replacement here: **conservative screen-tile
candidate lists**, built fully on-device with static shapes:

  1. project every Gaussian's 3σ AABB (the reference's own bound semantics,
     ``gaussian.py:104-138``) into the image,
  2. enumerate the tile rectangle it covers (bounded fan-out per Gaussian),
  3. sort the (tile, depth) key pairs once with ``jax.lax.sort``,
  4. scatter into a fixed-width ``(tiles, C)`` candidate matrix.

This is also the design the reference *intended* for its stubbed rasterizer
(tile + depth keys, then a GPU radix sort — ``rasterizer.py:47-71``); here it
serves the exact ray-traced pipeline instead of an EWA approximation.

Soundness: a ray through a pixel hits the ``xᵀΣ⁻¹x=3`` ellipsoid only if the
hit point lies in the Gaussian's AABB (the endpoint AABB is conservative for
this level set), and a convex set fully in front of the camera projects into
the convex hull of its corner projections — so binning by projected-AABB tile
overlap never misses a true hit. Gaussians whose AABB touches the camera
plane, or that span more tiles than the local fan-out cap, go to a per-frame
**global list** appended to every tile (bounded, counted).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rtgs_tpu import gaussians as G
from rtgs_tpu.camera import Camera
from rtgs_tpu.utils import quaternion as quat

_INT32_MAX = jnp.iinfo(jnp.int32).max


def _tree_cumsum(x, block: int = 1024):
    """Inclusive cumsum of a flat int array with COMPILE-CHEAP structure.

    XLA's compile time for a scan along one very long axis grows with its
    length, while short-axis cumsums are cheap regardless of batch, so
    recurse: reshape to (m, block), cumsum each block along the short
    axis, and recur on the m block totals."""
    n = x.shape[0]
    if n <= block:
        return jnp.cumsum(x)
    m = -(-n // block)
    xp = jnp.pad(x, (0, m * block - n)).reshape(m, block)
    inner = jnp.cumsum(xp, axis=1)
    totals = inner[:, -1]
    carry = _tree_cumsum(totals, block) - totals  # exclusive block offset
    return (inner + carry[:, None]).reshape(-1)[:n]


class TileBinning(NamedTuple):
    """Result of :func:`tile_candidates`.

    Attributes:
      candidates: (T, C + Cg) int32 Gaussian indices per tile, ``-1`` padded.
      n_tiles_x / n_tiles_y: tile grid dims (tile index = tx * nty + ty).
      local_overflow: scalar — candidate slots dropped because a tile
        exceeded C (the farthest Gaussians are dropped first).
      global_overflow: scalar — Gaussians needing the global list beyond Cg.
      counts: (T,) int32 valid-prefix length per tile.
      chunk_lb: (T, W/chunk + 1) f32 — per candidate-chunk, a conservative
        lower bound on the entry depth t1 of EVERY candidate in this chunk
        or any later one (suffix min; +inf where the suffix is empty, 0.0
        in the trailing guard column and whenever no bound is available).
        The peel kernel stops its chunk sweep once all K winners are
        nearer than this bound (exact early termination). Only populated
        when ``chunk`` is given; ``None`` otherwise.
    """

    candidates: jnp.ndarray
    n_tiles_x: int
    n_tiles_y: int
    local_overflow: jnp.ndarray
    global_overflow: jnp.ndarray
    counts: jnp.ndarray
    chunk_lb: jnp.ndarray | None = None


def _camera_space(points: jnp.ndarray, camera: Camera) -> jnp.ndarray:
    """World → camera coordinates: ``Rᵀ (p − pos)`` (camera looks −z)."""
    r = quat.as_rotation_mat3(camera.rotation)
    # HIGHEST: these coordinates decide which tiles a splat lands in. A
    # TF32 or bf16 matmul (~1e-3 relative) can shift a projected bound by
    # a fraction of a pixel, and the AABB bound has no margin to absorb it.
    return jnp.matmul(points - camera.position, r,
                      precision=jax.lax.Precision.HIGHEST)


def tile_candidates(
    g: G.Gaussians,
    camera: Camera,
    tile=(16, 16),
    max_candidates: int = 512,
    max_tiles_local=None,
    max_global: int = 128,
    pad_px: float = 0.0,
    narrow: int | None = None,
    chunk: int | None = None,
) -> TileBinning:
    """Build fixed-width per-tile candidate lists (all on-device, jittable).

    Within a tile, candidates are ordered by a quantized conservative lower
    bound on their ray entry depth t1 (center depth − √3·s_max — every hit
    point lies on the ``xᵀΣ⁻¹x = 3`` ellipsoid, whose bounding-sphere
    radius is √3·s_max, and a point's view depth never exceeds its ray
    parameter), so when a tile overflows ``max_candidates`` the farthest
    Gaussians drop first AND the peel kernel can stop its chunk sweep
    exactly once all K winners are nearer than the remaining candidates'
    bound (``chunk_lb``). The global list rides FIRST in each row so the
    depth-sorted local tail keeps tight suffix bounds.
    ``max_tiles_local`` defaults to ~128 px of screen coverage per axis;
    splats projecting wider than that go to the global list (nearest-first
    by the same bound — only when ``num_tiles < 2¹⁵``; beyond that the
    packed key drops the depth bits and drop order is arbitrary).

    ``narrow``: narrow-class fan-out width in tiles (default: env
    ``RTGS_BIN_NARROW`` or 4) — a STATIC argument so the jit cache keys on
    it (an env read alone would silently ignore per-call changes).
    ``chunk``: when given, the candidate width is padded to a multiple of
    it and ``chunk_lb`` (see :class:`TileBinning`) is returned.

    Compile-time discipline at 1M splats: everything downstream of the
    fan-out is ONE ``lax.sort`` of the (tile, depth)-keyed pair stream —
    global-list pairs ride the same sort under a sentinel tile id —
    followed by scatter-add/gather placement. No O(pairs) scans, no top_k
    over N, no 2-D scatter (each compiles slowly at these sizes); the
    candidate matrix is a *gather* from the sorted stream.
    """
    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    num_tiles = ntx * nty
    if max_tiles_local is None:
        max_tiles_local = (min(max(2, -(-128 // tw)), ntx),
                           min(max(2, -(-128 // th)), nty))
    mtx, mty = max_tiles_local
    n = g.num

    # --- Project AABB corners. ---
    pmin, pmax = G.aabb(g.means, g.quats, g.scales)  # (N, 3) each
    lohi = jnp.stack([pmin, pmax], axis=1)  # (N, 2, 3)
    sel = jnp.array(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)])  # (8, 3)
    cx = lohi[:, sel[:, 0], 0]  # (N, 8)
    cy = lohi[:, sel[:, 1], 1]
    cz = lohi[:, sel[:, 2], 2]
    corners = jnp.stack([cx, cy, cz], axis=-1)  # (N, 8, 3)

    pc = _camera_space(corners.reshape(-1, 3), camera).reshape(n, 8, 3)
    z = pc[..., 2]
    eps = 1e-6
    behind = jnp.any(z > -eps, axis=-1)  # touches/behind the camera plane
    zsafe = jnp.minimum(z, -eps)
    fx, fy = camera.focal_length[0], camera.focal_length[1]
    # Pixel-center coordinates: pixel i's ray corresponds to px == i
    # (see camera.py:46-52 mapping).
    px = fx * pc[..., 0] / (-zsafe) + (w / 2 - 0.5)
    py = fy * pc[..., 1] / (-zsafe) + (h / 2 - 0.5)
    px_min, px_max = jnp.min(px, -1) - pad_px, jnp.max(px, -1) + pad_px
    py_min, py_max = jnp.min(py, -1) - pad_px, jnp.max(py, -1) + pad_px

    off_screen = (
        (px_max < -0.5) | (px_min > w - 0.5)
        | (py_max < -0.5) | (py_min > h - 0.5))
    live = (g.mask > 0) & (behind | ~off_screen)

    tx0 = jnp.clip(jnp.floor(px_min / tw), 0, ntx - 1).astype(jnp.int32)
    tx1 = jnp.clip(jnp.floor(px_max / tw), 0, ntx - 1).astype(jnp.int32)
    ty0 = jnp.clip(jnp.floor(py_min / th), 0, nty - 1).astype(jnp.int32)
    ty1 = jnp.clip(jnp.floor(py_max / th), 0, nty - 1).astype(jnp.int32)
    wx, wy = tx1 - tx0 + 1, ty1 - ty0 + 1

    is_global = live & (behind | (wx > mtx) | (wy > mty))
    is_local = live & ~is_global

    # --- Entry-depth lower-bound quantization (in-tile sort key, drop
    # order, and the kernel's early-termination bound). ---
    depth = -_camera_space(g.means, camera)[:, 2]
    lb = jnp.maximum(
        depth - math.sqrt(G.BOUNDING_THRESHOLD)
        * jnp.max(g.scales, axis=-1), 0.0)
    dmax = jnp.maximum(jnp.max(jnp.where(live, lb, 0.0)), 1e-6)
    # Truncation rounds DOWN, so dequantized dq·dmax/65535 ≤ lb ≤ t1 —
    # the bound stays conservative. Clamp to 65534, not 65535: at
    # num_tiles == 32767 the packed key num_tiles·65536 + 65535 equals
    # INT32_MAX — the dead-slot sentinel — and the farthest live splat
    # always quantizes to the top bucket, so its global-list pair would
    # silently vanish.
    dq = jnp.clip(lb / dmax * 65535.0, 0, 65534).astype(jnp.int32)

    # --- Local fan-out, two classes: almost every splat at typical
    # densities covers ≤ narrow×narrow tiles, so fanning every splat out
    # to the full (mtx, mty) rectangle would waste most of the pair slots
    # (and flat O(N·mtx·mty) arrays compile slowly at 1M splats). Narrow
    # splats fan out to narrow² slots; the rare wide ones are compacted to
    # a fixed budget (n/16) first and fan out to (mtx, mty); wide splats
    # beyond the budget spill to the GLOBAL list (conservative — appended
    # to every tile), never dropped. Narrow-class width (env
    # RTGS_BIN_NARROW, default 4): a narrower class fans out to fewer
    # slots per splat but sends more splats to the wide class, which at
    # 1M splats @ 1080p overflows its budget at narrow = 3 and spills to
    # the global list (dropping candidates); the overflow counters say
    # whether a configuration can use 3.
    import os as _os

    if narrow is None:
        narrow = int(_os.environ.get("RTGS_BIN_NARROW", "4"))
    narrow = min(narrow, mtx, mty)
    is_wide = is_local & ((wx > narrow) | (wy > narrow))
    is_narrow = is_local & ~is_wide

    def fan_out(sel, tx0s, ty0s, wxs, wys, dqs, span_x, span_y):
        # Layout: (span, span, N) with the LONG axis minor, not (N, 3, 3)
        # with tiny minor dims.
        dx = jnp.arange(span_x, dtype=jnp.int32)
        dy = jnp.arange(span_y, dtype=jnp.int32)
        txs = tx0s[None, :] + dx[:, None]              # (sx, L)
        tys = ty0s[None, :] + dy[:, None]              # (sy, L)
        tid = txs[:, None, :] * nty + tys[None, :, :]  # (sx, sy, L)
        ok = (sel[None, None, :]
              & (dx[:, None, None] < wxs[None, None, :])
              & (dy[None, :, None] < wys[None, None, :]))
        if num_tiles <= (1 << 15) - 1:
            key = jnp.where(ok, tid * 65536 + dqs[None, None, :],
                            _INT32_MAX)
        else:
            # Too many tiles for a packed int32 key: sort by tile only
            # (drop order becomes arbitrary within a tile).
            key = jnp.where(ok, tid, _INT32_MAX)
        return key.reshape(span_x * span_y, -1)

    shift = 65536 if num_tiles <= (1 << 15) - 1 else 1

    key_n = fan_out(is_narrow, tx0, ty0, wx, wy, dq, narrow, narrow)
    val_n = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.int32)[None, :], key_n.shape)

    ids = jnp.arange(n, dtype=jnp.int32)
    if mtx > narrow or mty > narrow:
        # Compact wide splats to a budget, then full-rectangle fan-out.
        wlimit = max(64, n // 16)
        wpos = _tree_cumsum(is_wide.astype(jnp.int32)) - 1
        wdst = jnp.where(is_wide & (wpos < wlimit), wpos, wlimit)
        widx = jnp.full((wlimit + 1,), n, jnp.int32).at[wdst].set(
            ids, mode="drop")[:wlimit]
        wlive = widx < n
        wsafe = jnp.minimum(widx, n - 1)
        key_w = fan_out(wlive, tx0[wsafe], ty0[wsafe], wx[wsafe],
                        wy[wsafe], dq[wsafe], mtx, mty)
        val_w = jnp.broadcast_to(wsafe[None, :], key_w.shape)
        # Budget spill → global list (kept conservative, not dropped).
        is_global = is_global | (is_wide & (wpos >= wlimit))
        key_mid = [key_n.reshape(-1), key_w.reshape(-1)]
        val_mid = [val_n.reshape(-1), val_w.reshape(-1)]
    else:
        key_mid, val_mid = [key_n.reshape(-1)], [val_n.reshape(-1)]

    # --- Global-list pairs ride the SAME sort under a sentinel tile id
    # (num_tiles): depth-keyed like every other pair, so the global list
    # comes out nearest-first with no separate top_k over N. ---
    if num_tiles <= (1 << 15) - 1:
        key_g = jnp.where(is_global, num_tiles * 65536 + dq, _INT32_MAX)
    else:
        key_g = jnp.where(is_global, num_tiles, _INT32_MAX)
    key_f = jnp.concatenate(key_mid + [key_g])
    val_f = jnp.concatenate(val_mid + [ids])

    # One sort of the raw pair stream (dead slots carry INT32_MAX and sink
    # to the tail; with the two-class fan-out the stream is ~14 slots per
    # splat, so sorting it directly beats compacting first — the
    # compaction's own scans/scatters cost more compile time than the
    # slightly larger sort).
    key_s, val_s = jax.lax.sort((key_f, val_f), num_keys=1)

    # Tile offsets by BINARY SEARCH on the sorted keys (tile t's pairs
    # span [offs[t], offs[t+1]) because the tile id rides the key's high
    # bits; dead pairs carry INT32_MAX and sink past the last boundary).
    # The search is ~20 gathers of T+2 instead of a scatter-add over all
    # pairs.
    # No overflow: num_tiles·shift ≤ (2¹⁵−1)·2¹⁶ < 2³¹ − 2¹⁶.
    bounds = jnp.concatenate([
        jnp.arange(num_tiles + 1, dtype=jnp.int32) * shift,
        jnp.asarray([_INT32_MAX], jnp.int32)])
    offs = jnp.searchsorted(key_s, bounds, side="left").astype(jnp.int32)
    tcounts = jnp.diff(offs)                     # (T+1,): locals + global

    # Candidate matrix as PER-TILE ROW SLICES of the sorted stream (each
    # tile's pairs are CONTIGUOUS there, so a vmapped dynamic_slice — an
    # XLA gather of whole rows — replaces a per-element scalar gather of
    # the whole candidate matrix). The global row's
    # pairs come FIRST in every tile's row (they carry no useful depth
    # ordering relative to the locals, and leading placement keeps the
    # local tail's suffix depth bounds tight for early termination), then
    # tile t's own pairs — valid indices form a contiguous prefix (the
    # kernel's chunk skipping keys off the count). Layout trick: build
    # [globals-right-aligned-in-mg | locals] rows and slice total_c
    # columns starting at mg − n_glob, which lands the globals exactly
    # ahead of the locals with one uniform dynamic column shift.
    cl = jnp.minimum(tcounts[:num_tiles], max_candidates)      # (T,)
    n_glob = jnp.minimum(tcounts[num_tiles], max_global)
    mg = max_global
    total_c = max_candidates + max_global
    if chunk:
        total_c += (-total_c) % chunk

    # Front/back-pad the stream so no slice start or extent ever clamps
    # (a clamped dynamic_slice silently shifts the window).
    val_sp = jnp.concatenate([jnp.full((mg,), -1, jnp.int32), val_s,
                              jnp.full((total_c,), -1, jnp.int32)])
    grow = jax.lax.dynamic_slice(val_sp, (offs[num_tiles] + n_glob,),
                                 (mg,))          # right-aligned globals
    lstarts = offs[:num_tiles] + mg
    lrows = jax.vmap(
        lambda o: jax.lax.dynamic_slice(val_sp, (o,), (total_c,)))(lstarts)
    combined = jnp.concatenate(
        [jnp.broadcast_to(grow[None, :], (num_tiles, mg)), lrows], axis=1)
    rows = jax.lax.dynamic_slice_in_dim(combined, mg - n_glob, total_c,
                                        axis=1)
    j = jnp.arange(total_c, dtype=jnp.int32)[None, :]          # (1, C+G)
    lj = j - n_glob
    ok = (j < n_glob) | ((lj >= 0) & (lj < cl[:, None]))
    candidates = jnp.where(ok, rows, -1)
    local_overflow = jnp.sum(
        jnp.maximum(tcounts[:num_tiles] - max_candidates, 0))
    global_overflow = jnp.maximum(tcounts[num_tiles] - max_global, 0)
    counts = cl + n_glob

    chunk_lb = None
    if chunk:
        # Per-chunk suffix-min entry-depth bound (see TileBinning), from
        # the same row slices applied to the sorted KEYS (low 16 bits =
        # quantized bound). Dead slots bound +inf (an empty suffix
        # terminates immediately). The many-tiles branch has no depth
        # bits — no bound, never stop.
        nchunk = total_c // chunk
        if shift == 65536:
            key_sp = jnp.concatenate(
                [jnp.full((mg,), _INT32_MAX, jnp.int32), key_s,
                 jnp.full((total_c,), _INT32_MAX, jnp.int32)])
            gkrow = jax.lax.dynamic_slice(
                key_sp, (offs[num_tiles] + n_glob,), (mg,))
            lkrows = jax.vmap(
                lambda o: jax.lax.dynamic_slice(key_sp, (o,),
                                                (total_c,)))(lstarts)
            kcomb = jnp.concatenate(
                [jnp.broadcast_to(gkrow[None, :], (num_tiles, mg)),
                 lkrows], axis=1)
            krows = jax.lax.dynamic_slice_in_dim(
                kcomb, mg - n_glob, total_c, axis=1)
            lb_slot = jnp.where(ok, (krows & 0xFFFF).astype(
                jnp.float32) * (dmax / 65535.0), jnp.inf)
            cmin = jnp.min(lb_slot.reshape(num_tiles, nchunk, chunk),
                           axis=2)
            chunk_lb = jax.lax.cummin(cmin, axis=1, reverse=True)
        else:
            chunk_lb = jnp.zeros((num_tiles, nchunk), jnp.float32)
        chunk_lb = jnp.concatenate(
            [chunk_lb, jnp.zeros((num_tiles, 1), jnp.float32)], axis=1)
    return TileBinning(candidates, ntx, nty, local_overflow, global_overflow,
                       counts, chunk_lb)

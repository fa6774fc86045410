"""Tile-binned renderers: the production keys path and its plain twin.

Pipeline per frame (all on-device, static shapes):

  1. :func:`rtgs_tpu.render.binning.tile_candidates` — conservative
     candidate lists per screen tile.
  2. :func:`precompute_features` — fold the camera position into each
     Gaussian once: with ``e = origin − μ`` and ``M = Σ⁻¹``, every
     per-(pixel, candidate) quadratic reduces to

        A = dᵀM d            (bilinear in per-pixel d-features and M)
        B = 2 dᵀ(Me)         (precomputed ``Me``)
        C = eᵀMe − 3         (precomputed scalar)

     and the reference's midpoint response (``ray_tracer.py:90-92``) is
     algebraically ``ρ = exp(B²/(4A) − eᵀMe)`` — no per-eval 3×3 inverse,
     no position reconstruction (the reference inverts Σ twice per
     candidate, ``gaussian.py:196,215``).
  3. per tile, the K nearest hits per pixel reproduce the reference's
     depth-peeling semantics exactly (one Gaussian per layer,
     front-to-back compositing, ``ray_tracer.py:79-104``) without
     re-traversal or host round trips. :func:`render_tiled_keys` (the
     production path) selects the winners' ids with
     :func:`rtgs_tpu.ops.peel.peel_keys` and shades only those;
     :func:`render_tiled` intersects and peels every candidate in plain
     XLA (K masked argmin steps) and is the parity twin.

Differentiable end-to-end: the binning and the selection are
non-differentiable index choices (piecewise constant); the shading and
composite are plain arithmetic that JAX reverse-differentiates.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rtgs_tpu import gaussians as G
from rtgs_tpu.camera import Camera
from rtgs_tpu.utils import quaternion as quat


class TileFeatures(NamedTuple):
    """Per-Gaussian camera-folded features, with one sentinel row appended
    (index N → never hits, used for ``-1`` candidate padding)."""

    m6: jnp.ndarray     # (N+1, 6)  Σ⁻¹ packed [m00,m01,m02,m11,m12,m22]
    me: jnp.ndarray     # (N+1, 3)  Σ⁻¹ (origin − μ)
    c0: jnp.ndarray     # (N+1,)    eᵀΣ⁻¹e − 3
    opacity: jnp.ndarray  # (N+1,)
    color: jnp.ndarray  # (N+1, 3)
    sh: jnp.ndarray     # (N+1, 15, 3)


def precompute_features(g: G.Gaussians, camera: Camera) -> TileFeatures:
    # Flat-component adjugate inverse (identical algorithm to
    # G.inv_covariance): (N,)-shaped components instead of an (N, 3, 3)
    # array with tiny, padding-prone minor dims.
    m00, m01, m02, m11, m12, m22 = G.inv_covariance_packed6(
        g.quats, g.scales)
    m6 = jnp.stack([m00, m01, m02, m11, m12, m22], axis=-1)
    e = camera.position[None, :] - g.means
    ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
    # Symmetric matvec Σ⁻¹ e, componentwise (the einsum this replaces
    # contracted a padded (N, 3, 3) operand).
    mex = m00 * ex + m01 * ey + m02 * ez
    mey = m01 * ex + m11 * ey + m12 * ez
    mez = m02 * ex + m12 * ey + m22 * ez
    me = jnp.stack([mex, mey, mez], axis=-1)
    c0 = (ex * mex + ey * mey + ez * mez) - G.BOUNDING_THRESHOLD

    def sentinel(x, row):
        row = jnp.asarray(row, x.dtype).reshape((1,) + x.shape[1:])
        return jnp.concatenate([x, row], axis=0)

    return TileFeatures(
        m6=sentinel(m6, [1.0, 0.0, 0.0, 1.0, 0.0, 1.0]),
        me=sentinel(me, [0.0, 0.0, 0.0]),
        c0=sentinel(c0, jnp.inf),
        opacity=sentinel(g.opacities, 0.0),
        color=sentinel(g.colors, [0.0, 0.0, 0.0]),
        sh=sentinel(g.sh, jnp.zeros((15, 3))),
    )


def direction_features(dirs: jnp.ndarray):
    """Per-pixel features for the quadratic: d-quadratic terms matching the
    ``m6`` packing, plus the SH basis. ``dirs`` must be unit length."""
    dx, dy, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    fd = jnp.stack(
        [dx * dx, 2 * dx * dy, 2 * dx * dz, dy * dy, 2 * dy * dz, dz * dz],
        axis=-1)  # (..., 6)
    y = G.sh_basis(dirs)  # (..., 15)
    return fd, y


def intersect_candidates(feats: TileFeatures, cand: jnp.ndarray,
                         dirs: jnp.ndarray):
    """Intersect a tile's pixel block with its candidate list.

    Args:
      feats: camera-folded features.
      cand: (C,) int32 candidate indices, -1 padded.
      dirs: (P, 3) unit pixel ray directions.

    Returns:
      (t1, alpha, rgb): (P, C), (P, C), (P, C, 3). Invalid entries have
      ``t1 = +inf`` and ``alpha = 0``.
    """
    n_sentinel = feats.c0.shape[0] - 1
    safe = jnp.where(cand >= 0, cand, n_sentinel)
    m6 = feats.m6[safe]           # (C, 6)
    me = feats.me[safe]           # (C, 3)
    c0 = feats.c0[safe]           # (C,)
    op = feats.opacity[safe]
    col = feats.color[safe]       # (C, 3)
    sh = feats.sh[safe]           # (C, 15, 3)

    fd, y = direction_features(dirs)          # (P, 6), (P, 15)
    # HIGHEST: a reduced-precision matmul (bf16 or TF32 inputs) breaks the
    # cancellation-sensitive quadratic (exp(B²/4A − eᵀMe) overflows).
    hp = jax.lax.Precision.HIGHEST
    a = jnp.matmul(fd, m6.T, precision=hp)     # (P, C)
    b = 2.0 * jnp.matmul(dirs, me.T, precision=hp)
    cq = c0[None, :]
    # Guard the sentinel's inf c0 from generating nan (0 * inf) downstream.
    cq = jnp.where(jnp.isfinite(cq), cq, 1e30)
    delta = b * b - 4.0 * a * cq
    sq = jnp.sqrt(jnp.where(delta > 0, delta, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    valid = (delta >= 0.0) & (t1 > 0.0)
    # ρ at the chord midpoint: exp(B²/4A − eᵀMe); Δ==0 → t2=inf → ρ=0
    # (reference gaussian.py:227-229 + ray_tracer.py:90-92 semantics).
    rho = jnp.where(delta > 0.0, jnp.exp(b * b / (4.0 * a) - (cq + 3.0)), 0.0)
    alpha = jnp.where(valid, op[None, :] * rho, 0.0)
    t1 = jnp.where(valid, t1, jnp.inf)
    # rgb[p, c, ch] = color[c, ch] + Σₖ y[p, k] sh[c, k, ch].
    rgb = col[None, :, :] + jnp.einsum("pk,ckh->pch", y, sh,
                                       precision=jax.lax.Precision.HIGHEST)
    return t1, alpha, rgb


def peel_block(t1, alpha, rgb, depth: int):
    """K masked-argmin peel steps over a (P, C) block — the reference's
    per-launch peeling (``ray_tracer.py:79-104``) as a fixed-trip-count loop.

    Returns (radiance (P, 3), transmittance (P,)).
    """
    p = t1.shape[0]

    def body(carry, _):
        t1m, rad, trans = carry
        m = jnp.min(t1m, axis=-1, keepdims=True)           # (P, 1)
        sel = (t1m == m) & jnp.isfinite(m)
        first = sel & (jnp.cumsum(sel.astype(jnp.int32), axis=-1) == 1)
        fw = first.astype(t1m.dtype)
        a = jnp.sum(fw * alpha, axis=-1)                   # (P,)
        c = jnp.einsum("pc,pch->ph", fw, rgb,
                       precision=jax.lax.Precision.HIGHEST)  # (P, 3)
        rad = rad + (trans * a)[:, None] * c
        trans = trans * (1.0 - a)
        t1m = jnp.where(first, jnp.inf, t1m)
        return (t1m, rad, trans), None

    init = (t1, jnp.zeros((p, 3), t1.dtype), jnp.ones((p,), t1.dtype))
    (t1m, rad, trans), _ = jax.lax.scan(body, init, None, length=depth)
    return rad, trans


def _peel_one_tile(feats: TileFeatures, depth: int, cand, dirs):
    t1, alpha, rgb = intersect_candidates(feats, cand, dirs)
    return peel_block(t1, alpha, rgb, depth)


def pack_features(feats: TileFeatures) -> jnp.ndarray:
    """TileFeatures → the (N+1, 64) lane-packed table the keys selection
    and the winner shading read. Lanes: [0:6] Σ⁻¹ sym6, [6:9] Me, [9] c0,
    [10] opacity, [11:14] base color, [14:29]/[29:44]/[44:59] SH for
    r/g/b, [59:64] zero. Differentiable, so XLA's VJP of this +
    precompute_features carries winner-shading gradients back to the scene
    parameters."""
    n1 = feats.c0.shape[0]
    sh = feats.sh  # (N+1, 15, 3)
    cols = [
        feats.m6,                        # 0:6
        feats.me,                        # 6:9
        feats.c0[:, None],               # 9
        feats.opacity[:, None],          # 10
        feats.color,                     # 11:14
        sh[:, :, 0],                     # 14:29
        sh[:, :, 1],                     # 29:44
        sh[:, :, 2],                     # 44:59
        jnp.zeros((n1, 5), jnp.float32),  # 59:64 pad
    ]
    packed = jnp.concatenate(cols, axis=1)
    # Neutralize the sentinel's inf c0 (guarded in the XLA twin; the keys
    # selection has no isfinite guard on c0 — a huge finite value keeps
    # Δ < 0).
    return packed.at[-1, 9].set(1e30)


def _tile_pixel_features(camera: Camera, tile, pixel_offset=None):
    """Per-pixel features arranged (T, P, 24): dir, d-quadratic
    features, SH basis. ``pixel_offset``: optional (2,) subpixel jitter in
    pixel units (progressive sampling)."""
    from rtgs_tpu.ops.peel import G_DIM

    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    censor = jnp.asarray((w, h), jnp.float32)
    ox, oy = ((0.0, 0.0) if pixel_offset is None
              else (pixel_offset[0], pixel_offset[1]))
    i = (jnp.arange(ntx * tw, dtype=jnp.float32) + 0.5 + ox) / w
    j = (jnp.arange(nty * th, dtype=jnp.float32) + 0.5 + oy) / h
    uv = jnp.stack(jnp.meshgrid(i, j, indexing="ij"), axis=-1)
    pxy = (censor * uv - 0.5 * censor) / camera.focal_length
    d_cam = jnp.concatenate([pxy, -jnp.ones_like(pxy[..., :1])], axis=-1)
    d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
    dirs = quat.rot_vec3(camera.rotation, d_cam)  # (W', H', 3)
    fd, y = direction_features(dirs)
    pix = jnp.concatenate([dirs, fd, y], axis=-1)  # (W', H', 24)
    assert pix.shape[-1] == G_DIM
    return (
        pix.reshape(ntx, tw, nty, th, G_DIM)
        .transpose(0, 2, 1, 3, 4)
        .reshape(ntx * nty, tw * th, G_DIM))


def shade_winners(packed: jnp.ndarray, sid_k: jnp.ndarray,
                  pix: jnp.ndarray):
    """Shade the K winning layers per pixel from their Gaussian indices.

    The keys selection (``ops/peel.py:peel_keys``) returns the winners'
    SPLAT IDS; this computes their contribution with plain differentiable
    XLA — the row gather transposes to a scatter-add under autodiff, so
    this function IS the renderer's backward path (no kernel VJP needed).

    Shape discipline: gather the ONE lane-packed (N+1, 64) feature row
    per winner instead of per-field tables (m6 (·,6), sh (·,15,3)) with
    tiny minor dims, and let XLA fuse every slice/multiply/reduce of it —
    nothing else materializes.

    The quadratic runs as *elementwise* f32 mul/add over the gathered
    rows — exact f32, so no reduced-precision matmul (bf16 or TF32
    inputs) can break its cancellation-sensitive discriminant.

    Args:
      packed: (N+1, 64) lane-packed feature table (``pack_features``;
        row N = sentinel with c0 = 1e30).
      sid_k: (T, P, K) f32 winning Gaussian indices, +inf for vacant.
      pix: (T, P, 24) per-pixel features (dir, d-quadratic, SH basis).

    Returns:
      (alpha, r, g, b) each (T, P, K) — channels SEPARATE (no stacked
      (T, P, K, 3) array with a minor dim of 3). Vacant layers get
      alpha = 0.

    Implemented as a transpose wrapper over :func:`shade_winners_kp` (the
    (T, K, P) production twin) so the quadratic chain exists once; like
    it, gradients flow to ``packed`` only.
    """
    out = shade_winners_kp(packed, sid_k.transpose(0, 2, 1), pix)
    return tuple(x.transpose(0, 2, 1) for x in out)


def _shade_kp_impl(packed, sid_kp, pix):
    t, k, p = sid_kp.shape
    f = packed.shape[1]
    n_sentinel = packed.shape[0] - 1
    safe = jnp.where(jnp.isfinite(sid_kp), sid_kp,
                     jnp.float32(n_sentinel)).astype(jnp.int32)

    # Gather rows, then ONE transpose to (T, F, K, P) so every lane slice
    # below cuts a MIDDLE axis: slicing the minor axis of a (…, 64) array
    # can materialize (…, 1) buffers inside the banded while loop.
    # Middle-axis slices are dense (T, K, P) arrays.
    rows = packed[safe.reshape(t, k * p)]              # (T, K·P, F)
    rows = rows.transpose(0, 2, 1).reshape(t, f, k, p)  # (T, F, K, P)

    # One small transpose (T, P, 24) → (T, 24, P); the contractions over
    # 6/3/15 feature lanes unroll as fused multiply-adds of (T, K, P)
    # slices — no padded temporaries.
    pixT = pix.transpose(0, 2, 1)                      # (T, 24, P)

    def pf(j):
        return pixT[:, None, j, :]                     # (T, 1, P)

    a = sum(pf(3 + j) * rows[:, j] for j in range(6))
    b = 2.0 * sum(pf(j) * rows[:, 6 + j] for j in range(3))
    c0 = rows[:, 9]                                    # (T, K, P)
    op = rows[:, 10]
    cq = jnp.minimum(c0, 1e30)
    delta = b * b - 4.0 * a * cq
    sq = jnp.sqrt(jnp.where(delta > 0, delta, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    valid = (delta > 0.0) & (t1 > 0.0)
    rho = jnp.exp(jnp.where(delta > 0.0,
                            b * b / (4.0 * a) - (cq + 3.0), -jnp.inf))
    alpha = jnp.where(valid, op * rho, 0.0)
    chans = [rows[:, 11 + ch]
             + sum(pf(9 + j) * rows[:, 14 + 15 * ch + j]
                   for j in range(15))
             for ch in range(3)]
    # NB: residuals are ONLY (safe, pixT) — the backward re-gathers the
    # rows and recomputes the quadratic chain. Saving the seven (T, K, P)
    # intermediates per band would keep 7·T·K·P·4 bytes live per band
    # (lax.map keeps every band's residuals); recomputation is one extra
    # gather + elementwise per band.
    return (alpha, chans[0], chans[1], chans[2]), (safe, pixT)


@jax.custom_vjp
def shade_winners_kp(packed: jnp.ndarray, sid_kp: jnp.ndarray,
                     pix: jnp.ndarray):
    """(T, K, P)-layout twin of :func:`shade_winners`.

    With P (=256) minor, every (T, K, P) intermediate is a dense,
    contiguous pixel row per layer — the keys kernel's own output layout.
    ``sid_kp`` is (T, K, P); pixel features broadcast along the K axis
    inside fusions.

    Hand-written VJP: autodiff of the unrolled forward builds the rows
    cotangent from 59 strided slice-VJPs; the custom backward assembles
    the SAME cotangent as one dense 64-lane stack and scatter-adds it per
    splat. Differentiable w.r.t. ``packed`` only —
    ``sid_kp`` is index selection and ``pix`` (camera) gradients are not
    propagated on this path (the oracle/tiled paths differentiate cameras
    if ever needed).

    Returns (alpha, r, g, b) each (T, K, P)."""
    out, _ = _shade_kp_impl(packed, sid_kp, pix)
    return out


def _shade_kp_fwd(packed, sid_kp, pix):
    out, res = _shade_kp_impl(packed, sid_kp, pix)
    # ``packed`` rides in the residuals only as a zeros_like template for
    # the scatter-add (an alias, not a copy).
    return out, (packed, res)


def _shade_lane_maps(f: int):
    """Constant lane maps for the backward's cotangent stack.

    Every feature-row cotangent lane factors as
    ``d_rows[l] = (Σ_c CS[c, l]·chain_c) ⊙ (Σ_q PL[q, l]·pixx_q)`` with a
    chain factor c(l) ∈ {d_a, d_b, d_c0, d_op, d_r, d_g, d_b} and a pixel
    feature q(l) ∈ {fd, d, y, 1} — so the whole (·, 64) cotangent is two
    THIN matmuls against these constants plus one elementwise product, in
    fully dense (64, T·K·P) layouts, with no (T, 1, K·P) pieces for XLA
    to materialize inside the banded loop."""
    import numpy as np

    cs = np.zeros((8, f), np.float32)   # chain-factor selector
    pl = np.zeros((25, f), np.float32)  # pixel-feature selector (24 + ones)
    ONES = 24
    for j in range(6):                  # 0:6  m6 ← a
        cs[0, j] = 1.0
        pl[3 + j, j] = 1.0
    for j in range(3):                  # 6:9  me ← b
        cs[1, 6 + j] = 2.0
        pl[j, 6 + j] = 1.0
    cs[2, 9] = 1.0                      # c0
    pl[ONES, 9] = 1.0
    cs[3, 10] = 1.0                     # opacity
    pl[ONES, 10] = 1.0
    for ch in range(3):
        cs[4 + ch, 11 + ch] = 1.0       # base color
        pl[ONES, 11 + ch] = 1.0
        for j in range(15):             # SH
            lane = 14 + 15 * ch + j
            cs[4 + ch, lane] = 1.0
            pl[9 + j, lane] = 1.0
    return jnp.asarray(cs), jnp.asarray(pl)


def _shade_kp_bwd(residuals, cots):
    packed, (safe, pixT) = residuals
    d_alpha, d_r, d_g, d_b_ch = cots
    t, k, p = safe.shape
    f = packed.shape[1]

    # Recompute the quadratic chain (see the forward; SH/color need no
    # recomputation — their cotangents are value-independent).
    rows = packed[safe.reshape(t, k * p)]
    rows = rows.transpose(0, 2, 1).reshape(t, f, k, p)

    def pf(j):
        return pixT[:, None, j, :]

    a = sum(pf(3 + j) * rows[:, j] for j in range(6))
    b = 2.0 * sum(pf(j) * rows[:, 6 + j] for j in range(3))
    cq = jnp.minimum(rows[:, 9], 1e30)
    op = rows[:, 10]
    delta = b * b - 4.0 * a * cq
    sq = jnp.sqrt(jnp.where(delta > 0, delta, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    valid = (delta > 0.0) & (t1 > 0.0)
    rho = jnp.exp(jnp.where(delta > 0.0,
                            b * b / (4.0 * a) - (cq + 3.0), -jnp.inf))

    validf = valid.astype(jnp.float32)
    pos = (delta > 0.0).astype(jnp.float32)
    d_op = validf * rho * d_alpha
    d_rho = validf * op * d_alpha
    d_q = pos * rho * d_rho          # rho = exp(q) when delta>0, else 0
    d_b = (b / (2.0 * a)) * d_q
    d_a = -(b * b) / (4.0 * a * a) * d_q
    d_c0 = jnp.where(cq < 1e30, -d_q, 0.0)

    m = t * k * p
    cs, pl = _shade_lane_maps(f)
    hp = jax.lax.Precision.HIGHEST
    # chain (8, M) — rows are flattened (T, K, P) arrays, minor dim M.
    chain = jnp.concatenate(
        [x.reshape(1, m) for x in
         (d_a, d_b, d_c0, d_op, d_r, d_g, d_b_ch,
          jnp.zeros_like(d_a))], axis=0)
    af = jnp.matmul(cs.T, chain, precision=hp)          # (F, M)
    # pixx (25, T·P): pixel features + a ones row; broadcast over K after
    # the matmul (B0 depends only on the pixel).
    pixx = jnp.concatenate(
        [pixT.transpose(1, 0, 2).reshape(24, t * p),
         jnp.ones((1, t * p), jnp.float32)], axis=0)
    b0 = jnp.matmul(pl.T, pixx, precision=hp)           # (F, T·P)
    d_rows = (af.reshape(f, t, k, p)
              * b0.reshape(f, t, 1, p))                 # (F, T, K, P)
    # One f32 scatter-add of the M (T·K·P) winner rows into the table
    # (vacant winners carry safe == N, the sentinel row, whose gradient
    # is discarded). A per-tile one-hot mask-matmul pre-reduction was
    # 30-40% slower end to end on an H100.
    d_rows = d_rows.reshape(f, m).T                     # (M, F)
    d_packed = jnp.zeros_like(packed).at[safe.reshape(-1)].add(d_rows)
    return d_packed, None, None


shade_winners_kp.defvjp(_shade_kp_fwd, _shade_kp_bwd)


def composite_layers_kp(alpha, r, g, b):
    """Composite for the (T, K, P) layout: exclusive cumprod over the K
    (sublane) axis. Returns radiance (T, P, 3)."""
    one_minus = 1.0 - alpha
    trans = jnp.concatenate(
        [jnp.ones_like(alpha[:, :1]),
         jnp.cumprod(one_minus[:, :-1], axis=1)], axis=1)
    w = trans * alpha
    return jnp.stack([jnp.sum(w * r, 1), jnp.sum(w * g, 1),
                      jnp.sum(w * b, 1)], axis=-1)


def composite_layers(alpha, r, g, b):
    """Front-to-back composite of depth-ascending CHANNEL-SPLIT layers
    (``ray_tracer.py:96-98`` semantics, exclusive-cumprod transmittance).
    All inputs (T, P, K); returns radiance (T, P, 3)."""
    one_minus = 1.0 - alpha
    trans = jnp.concatenate(
        [jnp.ones_like(alpha[..., :1]),
         jnp.cumprod(one_minus[..., :-1], axis=-1)], axis=-1)
    w = trans * alpha
    return jnp.stack([jnp.sum(w * r, -1), jnp.sum(w * g, -1),
                      jnp.sum(w * b, -1)], axis=-1)


@partial(jax.jit, static_argnames=("depth", "tile", "max_candidates",
                                   "max_global", "max_tiles_local",
                                   "with_stats",
                                   "tile_bands", "keys_impl",
                                   "shade_layout", "bin_narrow"))
def render_tiled_keys(
    g: G.Gaussians,
    camera: Camera,
    depth: int = 16,
    tile=(16, 16),
    max_candidates: int = 512,
    max_global: int = 64,
    max_tiles_local=None,
    with_stats: bool = False,
    tile_bands: int | None = None,
    pixel_offset=None,
    keys_impl: str = "auto",
    shade_layout: str = "kp",
    bin_narrow: int | None = None,
):
    """Full-frame render: keys selection + XLA winner shading — the
    production path (``render(renderer="auto")`` for N > 4096).

    Same semantics as :func:`render_tiled`. The selection
    (:func:`rtgs_tpu.ops.peel.peel_keys`; the Triton kernel on the GPU)
    only *chooses* the K nearest splats per pixel; alpha/rgb of those
    winners and the front-to-back composite are ordinary XLA, so the whole
    renderer differentiates by autodiff — with the kernel, the R·C
    candidate field never materializes, only the R·K winner list.

    ``keys_impl`` is passed to ``peel_keys`` ("auto", "triton", "xla" or
    "interpret"). ``tile_bands``: process the tile axis in this many
    sequential bands (``lax.map``), bounding the per-band shading (and,
    for the XLA selection, the (tiles, P, C) depth field) to one band.
    """
    from rtgs_tpu.ops.peel import peel_keys
    from rtgs_tpu.render.binning import tile_candidates

    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    from rtgs_tpu.ops.peel import CHUNK as _CHUNK

    binning = tile_candidates(
        g, camera, tile=tile, max_candidates=max_candidates,
        max_global=max_global, max_tiles_local=max_tiles_local,
        pad_px=0.0 if pixel_offset is None else 0.5,
        narrow=bin_narrow, chunk=_CHUNK)
    cand = binning.candidates          # already chunk-aligned
    lb = binning.chunk_lb              # (T, NC+1)

    packed = pack_features(precompute_features(g, camera))
    pix = _tile_pixel_features(camera, tile, pixel_offset)

    def band(cand_b, pix_b, lb_b):
        if shade_layout == "kp":
            # (Tb, K, P) is the kernel's own output layout.
            _t1_kp, sid_kp = peel_keys(packed, cand_b, pix_b, depth,
                                       impl=keys_impl, chunk_lb=lb_b,
                                       out_layout="kp")
            layers = shade_winners_kp(packed, sid_kp, pix_b)
            return composite_layers_kp(*layers)      # (Tb, P, 3)
        _t1_k, sid_k = peel_keys(packed, cand_b, pix_b, depth,
                                 impl=keys_impl, chunk_lb=lb_b)
        layers = shade_winners(packed, sid_k, pix_b)
        return composite_layers(*layers)             # (Tb, P, 3)

    t = cand.shape[0]
    if tile_bands and tile_bands > 1:
        nb = -(-t // tile_bands)
        pad_t = tile_bands * nb - t
        cand_b = jnp.pad(cand, ((0, pad_t), (0, 0)), constant_values=-1)
        pix_b = jnp.pad(pix, ((0, pad_t), (0, 0), (0, 0)))
        # Padded tiles: an all-+inf bound row stops their sweep at chunk 0
        # (their count is 0 anyway).
        lb_b = jnp.pad(lb, ((0, pad_t), (0, 0)),
                       constant_values=jnp.inf)
        # Remat each band: lax.map otherwise keeps every band's shade
        # residuals live simultaneously (alpha/rgb alone are 4·T·K·P·4
        # bytes for the frame). Recomputing a
        # band's forward during its backward trades ~1 extra kernel+shade
        # pass for a full-frame residual footprint of just (bands, P, 3).
        rad = jax.lax.map(
            jax.checkpoint(lambda args: band(*args)),
            (cand_b.reshape(tile_bands, nb, cand.shape[1]),
             pix_b.reshape(tile_bands, nb, *pix.shape[1:]),
             lb_b.reshape(tile_bands, nb, lb.shape[1])))
        rad = rad.reshape(tile_bands * nb, pix.shape[1], 3)[:t]
    else:
        rad = band(cand, pix, lb)
    img = (
        rad.reshape(ntx, nty, tw, th, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(ntx * tw, nty * th, 3))
    img = img[:w, :h]
    if with_stats:
        stats = {
            "live": jnp.sum(binning.candidates >= 0),
            "local_overflow": binning.local_overflow,
            "global_overflow": binning.global_overflow,
            # Chunk-padded candidate total the kernel sweeps (upper bound
            # under early termination) — the bench's FLOP-model input.
            "swept_pairs": jnp.sum(
                (-(-binning.counts // _CHUNK)) * _CHUNK),
        }
        return img, stats
    return img


@partial(jax.jit, static_argnames=("depth", "tile", "max_candidates",
                                   "max_global", "tile_chunk",
                                   "max_tiles_local", "bin_narrow"))
def render_tiled(
    g: G.Gaussians,
    camera: Camera,
    depth: int = 16,
    tile=(16, 16),
    max_candidates: int = 512,
    max_global: int = 64,
    tile_chunk: int | None = None,
    max_tiles_local=None,
    pixel_offset=None,
    bin_narrow: int | None = None,
):
    """Full-frame tiled render. Returns (W, H, 3) radiance.

    Exactly matches the oracle wherever candidate lists don't overflow
    (tested in tests/test_tiled.py); overflow drops farthest-first.
    """
    from rtgs_tpu.render.binning import tile_candidates

    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    num_tiles = ntx * nty

    binning = tile_candidates(
        g, camera, tile=tile, max_candidates=max_candidates,
        max_global=max_global, max_tiles_local=max_tiles_local,
        pad_px=0.0 if pixel_offset is None else 0.5, narrow=bin_narrow)
    feats = precompute_features(g, camera)

    # Pixel ray directions for the padded (ntx·tw, nty·th) grid, arranged
    # (T, P, 3) with T = tx * nty + ty, P = local (x, y) raster order.
    censor = jnp.asarray((w, h), jnp.float32)
    ox, oy = ((0.0, 0.0) if pixel_offset is None
              else (pixel_offset[0], pixel_offset[1]))
    i = (jnp.arange(ntx * tw, dtype=jnp.float32) + 0.5 + ox) / w
    j = (jnp.arange(nty * th, dtype=jnp.float32) + 0.5 + oy) / h
    uv = jnp.stack(jnp.meshgrid(i, j, indexing="ij"), axis=-1)
    pxy = (censor * uv - 0.5 * censor) / camera.focal_length
    d_cam = jnp.concatenate([pxy, -jnp.ones_like(pxy[..., :1])], axis=-1)
    d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
    dirs = quat.rot_vec3(camera.rotation, d_cam)  # (W', H', 3)
    dirs = (
        dirs.reshape(ntx, tw, nty, th, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(num_tiles, tw * th, 3))

    c2 = binning.candidates.shape[1]
    if tile_chunk is None:
        # Bound the (chunk, P, C) intermediates to ~2^24 elements.
        tile_chunk = max(1, min(num_tiles, (1 << 24) // (tw * th * c2)))
    n_chunks = -(-num_tiles // tile_chunk)
    pad = n_chunks * tile_chunk - num_tiles
    cand_p = jnp.pad(binning.candidates, ((0, pad), (0, 0)),
                     constant_values=-1)
    dirs_p = jnp.pad(dirs, ((0, pad), (0, 0), (0, 0)),
                     constant_values=1.0)
    cand_c = cand_p.reshape(n_chunks, tile_chunk, c2)
    dirs_c = dirs_p.reshape(n_chunks, tile_chunk, tw * th, 3)

    peel = jax.vmap(partial(_peel_one_tile, feats, depth))
    rad, trans = jax.lax.map(
        lambda args: peel(*args), (cand_c, dirs_c))
    rad = rad.reshape(n_chunks * tile_chunk, tw * th, 3)[:num_tiles]

    img = (
        rad.reshape(ntx, nty, tw, th, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(ntx * tw, nty * th, 3))
    return img[:w, :h]

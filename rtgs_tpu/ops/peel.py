"""Per-pixel top-K depth selection ("keys") for the tile-binned renderer.

For every pixel of every screen tile, select the K = ``depth`` nearest
entry depths t1 among the tile's candidate Gaussians, returning each
winner's t1 and splat id. This is the selection half of the reference's
depth peeling (one Gaussian per layer, front to back,
``ray_tracer.py:79-104``) done in one pass; the winners are shaded and
composited by plain differentiable XLA in ``render/tiled.py``, so the
selection itself needs no gradient (it is piecewise constant in the scene
parameters).

Two implementations with identical semantics:

  * :func:`peel_keys_triton` — a Pallas kernel for the GPU, compiled
    through Triton (``backend="triton"``). One program per tile holds the
    K running ``(t1, splat id)`` pairs of each of the tile's pixels in
    registers, reads each candidate's intersect lanes straight from the
    feature table by id (no gathered (T, C, F) block), and stops the sweep
    exactly once every pixel's K-th t1 is below the binning's suffix lower
    bound of the remaining candidates (``chunk_lb``).
  * :func:`peel_keys_xla` — the plain form: the (T, P, C) entry-depth field
    and one lexicographic ``lax.sort`` over all C candidates. It is the CPU
    path and the parity reference for the kernel.

Ties in t1 break to the LOWER SPLAT ID in both — the reference
traversal's first-seen-nearest rule over its primitive order
(``scene.py:429-437``) and the oracle's lane order.

Quadratic identities (see ``render/tiled.py``): with per-pixel direction
``d`` and its quadratic features ``fd`` (dx², 2dxdy, 2dxdz, dy², 2dydz,
dz²), and per-splat ``m6`` (packed Σ⁻¹), ``Me`` and ``c0 = eᵀMe − 3``:
A = fd·m6, B = 2 d·Me, C = c0; entry depth t1 = (−B − √Δ) / 2A with
Δ = B² − 4AC; a miss (Δ < 0 or t1 ≤ 0) gets t1 = +inf. Both forms
evaluate this with the same elementwise f32 operations in the same order
— 9 multiply-adds per (pixel, candidate), too thin for a matrix unit and
exact in f32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Pixel-feature lanes (``render/tiled.py:_tile_pixel_features``):
# [0:3] dir, [3:9] d-quadratic features, [9:24] SH basis.
G_DIM = 24
# Feature-table lanes the selection reads (``render/tiled.py:pack_features``):
# [0:6] Σ⁻¹ sym6, [6:9] Me, [9] c0.
KEY_LANES = 10
# Candidate-chunk width: the granularity of the binning's early-termination
# bounds (``tile_candidates(chunk=CHUNK)``) and of the kernel's stop test.
CHUNK = 128
# Triton warps per kernel program (P / (32·NUM_WARPS) pixels per thread);
# of 2, 4 and 8, 4 selected the 1M-splat 1080p frame fastest on an H100
# (8 was 5% faster on the 100k-splat 640x384 frame).
NUM_WARPS = 4
_VACANT_ID = jnp.iinfo(jnp.int32).max


def _gather(packed_feats, candidates):
    """Rows of the (N+1, F) table per candidate; -1 padding reads the
    sentinel row N (which never hits)."""
    n_sentinel = packed_feats.shape[0] - 1
    safe = jnp.where(candidates >= 0, candidates, n_sentinel)
    return packed_feats[safe], safe  # (T, C, F)


def _counts(candidates):
    """Per-tile candidate count = last valid slot + 1 (robust to interior
    -1 gaps; the binning emits contiguous prefixes so this is tight)."""
    t, c = candidates.shape
    lane = jax.lax.broadcasted_iota(jnp.int32, (t, c), 1)
    return jnp.max(jnp.where(candidates >= 0, lane + 1, 0), axis=1)


def _entry_depth(d, fd, m6, me, c0):
    """t1 (+inf on a miss) from broadcastable pixel lanes ``d`` (3 arrays),
    ``fd`` (6) and candidate lanes ``m6`` (6), ``me`` (3), ``c0``. Shared
    by the kernel and the XLA form so both round identically."""
    a = fd[0] * m6[0]
    for j in range(1, 6):
        a = a + fd[j] * m6[j]
    b = d[0] * me[0] + d[1] * me[1] + d[2] * me[2]
    b = 2.0 * b
    delta = b * b - 4.0 * a * c0
    sq = jnp.sqrt(jnp.where(delta > 0, delta, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    valid = (delta >= 0.0) & (t1 > 0.0)
    return jnp.where(valid, t1, jnp.inf)


def _intersect_t1(feats, pix):
    """feats (T, C, F) × pix (T, P, G) → t1 (T, P, C), +inf on a miss."""
    d = [pix[..., j][:, :, None] for j in range(3)]
    fd = [pix[..., 3 + j][:, :, None] for j in range(6)]
    m6 = [feats[..., j][:, None, :] for j in range(6)]
    me = [feats[..., 6 + j][:, None, :] for j in range(3)]
    return _entry_depth(d, fd, m6, me, feats[..., 9][:, None, :])


def peel_keys_xla(packed_feats, candidates, pix_feats, depth: int):
    """Plain-XLA keys: the full (T, P, C) t1 field and one lexicographic
    (t1, splat id) sort. Returns ``(t1, sid)`` each (T, P, K)."""
    gathered, _ = _gather(packed_feats, candidates)
    t1 = _intersect_t1(gathered, pix_feats)
    sid = jnp.where(candidates >= 0, candidates.astype(jnp.float32),
                    jnp.inf)
    sid = jnp.broadcast_to(sid[:, None, :], t1.shape)
    t1_s, sid_s = jax.lax.sort((t1, sid), dimension=-1, num_keys=2)
    t1_k = t1_s[..., :depth]
    # Vacant layers (no hit): mask the sid — a miss still carries its
    # candidate's id through the sort.
    sid_k = jnp.where(jnp.isfinite(t1_k), sid_s[..., :depth], jnp.inf)
    return t1_k, sid_k


def _insert(depth, st_t, st_i, v, vid):
    """Insert candidate (v, vid) — v a (P,) depth vector, vid a scalar id —
    into the per-pixel sorted K-lists ``st_t``/``st_i`` (K arrays of (P,)
    each, ascending by (t1, id)). ``lt[k]`` — the candidate sorts before
    slot k — is monotone in k, so slot k takes the candidate where it
    first becomes true and slot k−1's entry where it was already true."""
    lt = [(v < st_t[k]) | ((v == st_t[k]) & (vid < st_i[k]))
          for k in range(depth)]
    new_t, new_i = [], []
    for k in range(depth):
        if k == 0:
            nt = jnp.where(lt[0], v, st_t[0])
            ni = jnp.where(lt[0], vid, st_i[0])
        else:
            nt = jnp.where(lt[k], jnp.where(lt[k - 1], st_t[k - 1], v),
                           st_t[k])
            ni = jnp.where(lt[k], jnp.where(lt[k - 1], st_i[k - 1], vid),
                           st_i[k])
        new_t.append(nt)
        new_i.append(ni)
    return new_t, new_i


def _keys_kernel(depth, cand_ref, count_ref, lb_ref, feat_ref, pix_ref,
                 t1_ref, sid_ref):
    """One program = one tile. Refs are whole arrays indexed by the tile:
    cand (T, C) int32, count (T,) int32, lb (T, C/CHUNK + 1) f32,
    feat (N+1, 16) f32 (lanes [0:10] used), pix (T, 9, P) f32 (dir, then
    d-quadratic features); outputs (T, K, P) t1 and splat id (f32)."""
    t = pl.program_id(0)
    n_sentinel = feat_ref.shape[0] - 1
    d = [pix_ref[t, j, :] for j in range(3)]
    fd = [pix_ref[t, 3 + j, :] for j in range(6)]
    count = count_ref[t]
    n_chunks = (count + CHUNK - 1) // CHUNK
    p = d[0].shape[0]

    def candidate(j, st):
        cid = cand_ref[t, j]
        row = jnp.where(cid >= 0, cid, n_sentinel)
        f = [feat_ref[row, lane] for lane in range(KEY_LANES)]
        v = _entry_depth(d, fd, f[0:6], f[6:9], f[9])
        new_t, new_i = _insert(depth, st[:depth], st[depth:], v, cid)
        return tuple(new_t) + tuple(new_i)

    def chunk(c, carry):
        # Sweep chunk c only while some pixel's K-th nearest hit is still
        # beyond the lower bound of every remaining candidate. Once none
        # is, no later candidate can enter any list, so the result equals
        # the full sweep's; the remaining chunks run zero candidates. A
        # pixel with a vacant slot keeps its K-th t1 at +inf and the sweep
        # running. (The test sits in the loop body, not in a while_loop
        # condition: Triton's compiler crashed on a while loop whose
        # condition tests a value reduced in its body.)
        active, st = carry[0], carry[1:]
        worst = jnp.max(st[depth - 1])
        active = jnp.where(worst > lb_ref[t, c], active, 0)
        end = jnp.where(active > 0, jnp.minimum((c + 1) * CHUNK, count),
                        c * CHUNK)
        st = jax.lax.fori_loop(c * CHUNK, end, candidate, st)
        return (active,) + st

    init = ((jnp.full((p,), jnp.inf, jnp.float32),) * depth
            + (jnp.full((p,), _VACANT_ID, jnp.int32),) * depth)
    st = jax.lax.fori_loop(0, n_chunks, chunk, (jnp.int32(1),) + init)[1:]
    for k in range(depth):
        t1_k = st[k]
        t1_ref[t, k, :] = t1_k
        sid_ref[t, k, :] = jnp.where(jnp.isfinite(t1_k),
                                     st[depth + k].astype(jnp.float32),
                                     jnp.inf)


def peel_keys_triton(packed_feats, candidates, pix_feats, depth: int,
                     chunk_lb=None, *, interpret: bool = False):
    """Keys through the Pallas-Triton kernel (see :func:`_keys_kernel`).

    Args:
      packed_feats: (N+1, F ≥ 10) feature table (``pack_features``; row N
        is the never-hitting sentinel).
      candidates: (T, C) int32 splat ids per tile, -1 padded; C a multiple
        of ``CHUNK``.
      pix_feats: (T, P, ≥ 9) per-pixel features; P a power of two.
      depth: K.
      chunk_lb: optional (T, C/CHUNK + 1) suffix entry-depth lower bounds
        from ``tile_candidates(..., chunk=CHUNK)``; ``None`` → zeros →
        full sweep.
      interpret: run under the Pallas interpreter (tests on CPU).

    Returns ``(t1, sid)`` each (T, K, P), depth-ascending; ``sid`` is the
    winning splat id as f32 (+inf for vacant layers; exact for ids < 2²⁴,
    and the XLA form's tie order also needs ids < 2²⁴). Not differentiable —
    :func:`peel_keys` stops gradients at its inputs.
    """
    t, c = candidates.shape
    p = pix_feats.shape[1]
    assert c % CHUNK == 0, c
    assert p & (p - 1) == 0, p
    ncol = c // CHUNK + 1
    if chunk_lb is None:
        chunk_lb = jnp.zeros((t, ncol), jnp.float32)
    assert chunk_lb.shape == (t, ncol), (chunk_lb.shape, (t, ncol))
    feat = jnp.pad(packed_feats[:, :KEY_LANES].astype(jnp.float32),
                   ((0, 0), (0, 16 - KEY_LANES)))
    pix = pix_feats[..., :9].astype(jnp.float32).transpose(0, 2, 1)
    out = jax.ShapeDtypeStruct((t, depth, p), jnp.float32)
    return pl.pallas_call(
        functools.partial(_keys_kernel, depth),
        out_shape=(out, out),
        grid=(t,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="rtgs_keys",
    )(candidates.astype(jnp.int32), _counts(candidates), chunk_lb, feat, pix)


def peel_keys(packed_feats, candidates, pix_feats, depth: int,
              impl: str = "auto", chunk_lb=None, out_layout: str = "pk"):
    """Dispatcher for the keys-only top-K. Index selection is piecewise
    constant in the scene parameters, so the inputs are stop_gradient'ed
    here — gradients flow through the XLA winner shading instead
    (``render/tiled.py:shade_winners_kp``).

    ``impl``: "auto" (the Triton kernel on the GPU, the XLA form
    elsewhere), "triton", "xla", or "interpret" (the Triton kernel under
    the Pallas interpreter — for tests on CPU). A kernel that fails to
    compile raises; nothing falls back. ``chunk_lb`` enables the kernel's
    exact early termination; the XLA form ignores it, which makes comparing
    the two a check of the termination logic too. ``out_layout``: "pk" →
    (T, P, K) results, "kp" → (T, K, P) (the kernel's own layout and what
    the shading stage consumes)."""
    packed_feats = jax.lax.stop_gradient(packed_feats)
    pix_feats = jax.lax.stop_gradient(pix_feats)
    if chunk_lb is not None:
        # The bounds derive from the scene (the binning's entry-depth lower
        # bounds): without this they drag a JVP into the pallas_call.
        chunk_lb = jax.lax.stop_gradient(chunk_lb)
    if impl == "auto":
        impl = "triton" if jax.devices()[0].platform == "gpu" else "xla"
    if impl == "xla":
        out = peel_keys_xla(packed_feats, candidates, pix_feats, depth)
        if out_layout == "kp":
            return tuple(x.transpose(0, 2, 1) for x in out)
        return out
    if impl not in ("triton", "interpret"):
        raise ValueError(f"unknown keys impl {impl!r}")
    out = peel_keys_triton(packed_feats, candidates, pix_feats, depth,
                           chunk_lb=chunk_lb,
                           interpret=impl == "interpret")
    if out_layout == "pk":
        return tuple(x.transpose(0, 2, 1) for x in out)
    return out

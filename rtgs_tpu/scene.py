"""Gaussian-splat scene: load/save + activation contract + padding.

Mirrors the reference loader's exact activation semantics
(``/root/reference/src/rtgs/scene.py:89-160``):

  * quaternion reorder scalar-first ``rot_0..3`` → scalar-last
    ``(rot_1, rot_2, rot_3, rot_0)`` + normalize (``scene.py:103,110-111``),
  * ``scale = exp(scale_raw) · global_scale`` (``scene.py:112``),
  * ``color = sigmoid(f_dc)`` (``scene.py:113``) — note: **no** SH degree-0
    constant folded in (this differs from INRIA 3DGS, deliberate parity),
  * ``opacity = sigmoid(opacity_raw)`` (``scene.py:114``),
  * ``f_rest_0..44`` → 15 RGB SH coefficient triples.

SH layout note: the canonical 3DGS export stores ``f_rest_{c*15+k}`` =
channel ``c``, coefficient ``k`` (channel-major). The reference reshapes to
``(N, 3, 15)`` and pushes that buffer into a ``(N, 15)``-of-vec3 Taichi field
(``scene.py:106-107,122,127``) — a flat reinterpretation that scrambles
channel/coefficient pairing. We default to the *correct* pairing
(``sh_layout="inria"``) and offer ``sh_layout="reference_flat"`` to replicate
the reference's buffer reinterpretation bit-for-bit when strict bug-parity is
wanted (SURVEY.md §7 quirk 10).

No BVH is built at load time: the acceleration structure (tile binning /
LBVH) is constructed on-device per render/step, see
``rtgs_tpu/render/tiled.py`` and ``rtgs_tpu/bvh.py``.
"""

from __future__ import annotations

import logging
import pathlib
from typing import Dict

import jax.numpy as jnp
import numpy as np

from rtgs_tpu import gaussians as G
from rtgs_tpu.io.ply import read_ply, write_ply

logger = logging.getLogger(__name__)


def sigmoid(x: np.ndarray) -> np.ndarray:
    """Numerically-stable sigmoid (reference ``utils/math.py:8-14``)."""
    out = np.empty_like(x, dtype=np.float64)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def inverse_sigmoid(y: np.ndarray) -> np.ndarray:
    return np.log(y) - np.log1p(-y)


def load_scene(path, scale: float = 1.0,
               sh_layout: str = "inria") -> G.Gaussians:
    """Load a ``.ply`` (or ``.splt``/``.splat``) 3DGS scene into a
    :class:`Gaussians` SoA pytree.

    Args:
      path: scene file path. ``.ply`` uses the canonical 62-property schema;
        ``.splt``/``.splat`` is the 32-byte community format (the reference
        advertises splt support, ``scene.py:89-92``, but its PyntCloud
        loader cannot actually read it — here it works).
      scale: global Gaussian scale multiplier (reference ``--scale`` flag,
        ``scene.py:112``).
      sh_layout: ``"inria"`` (correct channel pairing) or
        ``"reference_flat"`` (replicate the reference's buffer
        reinterpretation).
    """
    path = pathlib.Path(path)
    if path.suffix.lower() in (".splt", ".splat"):
        from rtgs_tpu.io.splt import read_splt

        d = read_splt(path)
        n = d["means"].shape[0]
        logger.info("splt cloud loaded from %s with %d points.", path, n)
        return G.Gaussians(
            means=jnp.asarray(d["means"], jnp.float32),
            quats=jnp.asarray(d["quats"], jnp.float32),
            scales=jnp.asarray(d["scales"] * scale, jnp.float32),
            colors=jnp.asarray(d["colors"], jnp.float32),
            opacities=jnp.asarray(d["opacities"], jnp.float32),
            sh=jnp.asarray(d["sh"], jnp.float32),
            mask=jnp.ones((n,), jnp.float32),
        )
    cols = read_ply(path)
    n = len(cols["x"])
    logger.info("Point cloud loaded from %s with %d points.", path, n)

    means = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    # Scalar-first → scalar-last (scene.py:103) + normalize (scene.py:110-111).
    quats = np.stack(
        [cols["rot_1"], cols["rot_2"], cols["rot_3"], cols["rot_0"]], axis=1)
    quats = quats / np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = np.exp(
        np.stack([cols["scale_0"], cols["scale_1"], cols["scale_2"]], axis=1)
    ) * scale
    colors = sigmoid(
        np.stack([cols["f_dc_0"], cols["f_dc_1"], cols["f_dc_2"]], axis=1))
    opacities = sigmoid(cols["opacity"].astype(np.float64))

    frest = np.stack(
        [cols[f"f_rest_{i}"] for i in range(3 * G.NUM_SH_COEFFS)], axis=1)
    if sh_layout == "inria":
        # f_rest_{c*15+k} = (channel c, coeff k) → (N, coeff, channel).
        sh = frest.reshape(n, 3, G.NUM_SH_COEFFS).transpose(0, 2, 1)
    elif sh_layout == "reference_flat":
        # Reinterpret the (N, 3, 15) C-order buffer as (N, 15, 3) — what the
        # reference's from_numpy push does (scene.py:106-107,122,127).
        sh = frest.reshape(n, G.NUM_SH_COEFFS, 3)
    else:
        raise ValueError(f"unknown sh_layout: {sh_layout!r}")

    return G.Gaussians(
        means=jnp.asarray(means, jnp.float32),
        quats=jnp.asarray(quats, jnp.float32),
        scales=jnp.asarray(scales, jnp.float32),
        colors=jnp.asarray(colors, jnp.float32),
        opacities=jnp.asarray(opacities, jnp.float32),
        sh=jnp.asarray(sh, jnp.float32),
        mask=jnp.ones((n,), jnp.float32),
    )


def save_scene(path, g: G.Gaussians, scale: float = 1.0,
               sh_layout: str = "inria") -> None:
    """Write a scene back to the canonical 62-property 3DGS ``.ply`` schema
    with inverse activations (log scale, logit color/opacity, scalar-first
    quats), so optimized scenes round-trip into the reference viewer
    (SURVEY.md §5 checkpoint/resume). A ``.splt``/``.splat`` path writes the
    32-byte community format instead (SH dropped)."""
    live = np.asarray(g.mask) > 0
    path = pathlib.Path(path)
    if path.suffix.lower() in (".splt", ".splat"):
        from rtgs_tpu.io.splt import write_splt

        write_splt(path,
                   np.asarray(g.means)[live],
                   np.asarray(g.quats)[live],
                   np.asarray(g.scales)[live] / scale,
                   np.asarray(g.colors)[live],
                   np.asarray(g.opacities)[live])
        return
    means = np.asarray(g.means, np.float32)[live]
    quats = np.asarray(g.quats, np.float32)[live]
    scales = np.asarray(g.scales, np.float32)[live]
    colors = np.clip(np.asarray(g.colors, np.float64)[live], 1e-7, 1 - 1e-7)
    opac = np.clip(np.asarray(g.opacities, np.float64)[live], 1e-7, 1 - 1e-7)
    sh = np.asarray(g.sh, np.float32)[live]
    n = means.shape[0]

    cols: Dict[str, np.ndarray] = {}
    for i, k in enumerate("xyz"):
        cols[k] = means[:, i]
    for i, k in enumerate(["nx", "ny", "nz"]):
        cols[k] = np.zeros(n, np.float32)
    for i in range(3):
        cols[f"f_dc_{i}"] = inverse_sigmoid(colors[:, i]).astype(np.float32)
    if sh_layout == "inria":
        frest = sh.transpose(0, 2, 1).reshape(n, 45)
    else:
        frest = sh.reshape(n, 45)
    for i in range(45):
        cols[f"f_rest_{i}"] = frest[:, i]
    cols["opacity"] = inverse_sigmoid(opac).astype(np.float32)
    for i in range(3):
        cols[f"scale_{i}"] = np.log(
            np.maximum(scales[:, i] / scale, 1e-30)).astype(np.float32)
    # Scalar-last → scalar-first on disk.
    cols["rot_0"] = quats[:, 3]
    for i in range(3):
        cols[f"rot_{i + 1}"] = quats[:, i]
    write_ply(path, cols)


def pad_scene(g: G.Gaussians, multiple: int) -> G.Gaussians:
    """Pad N up to a multiple (for static-shape tiling / sharding) with dead
    Gaussians: ``mask = 0``, unit scale, zero opacity. Padded entries are
    masked out of every hit test."""
    n = g.num
    target = -(-n // multiple) * multiple
    pad = target - n
    if pad == 0:
        return g

    def pad_arr(x, fill=0.0):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill)

    return G.Gaussians(
        means=pad_arr(g.means),
        quats=pad_arr(g.quats).at[n:, 3].set(1.0),
        scales=pad_arr(g.scales, fill=1.0),
        colors=pad_arr(g.colors),
        opacities=pad_arr(g.opacities),
        sh=pad_arr(g.sh),
        mask=pad_arr(g.mask),
    )


def random_scene(key, n: int, extent: float = 1.0,
                 scale_range=(0.02, 0.1)) -> G.Gaussians:
    """Seeded synthetic scene for tests and benchmarks: random anisotropic
    Gaussians in a cube of half-size ``extent``.

    Jitted as one program: eagerly this is ~20 tiny dispatches, each with
    its own launch and host round trip.
    """
    import jax

    build = jax.jit(_random_scene_impl,
                    static_argnames=("n", "extent", "scale_range"))
    return build(key, n=n, extent=extent, scale_range=tuple(scale_range))


def _random_scene_impl(key, n: int, extent: float, scale_range):
    import jax

    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    means = jax.random.uniform(k1, (n, 3), minval=-extent, maxval=extent)
    quats = jax.random.normal(k2, (n, 4))
    quats = quats / jnp.linalg.norm(quats, axis=-1, keepdims=True)
    lo, hi = scale_range
    scales = jnp.exp(jax.random.uniform(
        k3, (n, 3), minval=jnp.log(lo), maxval=jnp.log(hi)))
    colors = jax.random.uniform(k4, (n, 3), minval=0.05, maxval=0.95)
    opacities = jax.random.uniform(k5, (n,), minval=0.2, maxval=0.95)
    sh = 0.05 * jax.random.normal(k6, (n, G.NUM_SH_COEFFS, 3))
    return G.Gaussians(
        means=means.astype(jnp.float32),
        quats=quats.astype(jnp.float32),
        scales=scales.astype(jnp.float32),
        colors=colors.astype(jnp.float32),
        opacities=opacities.astype(jnp.float32),
        sh=sh.astype(jnp.float32),
        mask=jnp.ones((n,), jnp.float32),
    )

"""Gaussian primitive math: covariance, SH color, ray–ellipsoid intersection.

Structure-of-arrays design: a scene is a :class:`Gaussians` pytree
of flat ``jnp`` arrays (no per-primitive structs), so every op below is
batched, differentiable, and shardable with ``NamedSharding``.

Numerical contract (kept bit-for-bit in spirit with the reference, each quirk
cited into ``/root/reference/src/rtgs``):

  * Covariance ``Σ = R · S · Sᵀ · Rᵀ`` with ``S = diag(scale)``
    (``gaussian.py:86-102``) — Σ is in units of scale².
  * Response ``ρ = exp(−dᵀ Σ⁻¹ d)`` — **no** ½ factor (``gaussian.py:197``).
  * Ray hit = intersection with the level-set ellipsoid ``xᵀ Σ⁻¹ x = 3``
    (``gaussian.py:203-230``, ``BOUNDING_THRESHOLD = 3`` at ``gaussian.py:13``).
  * AABB from the 6 endpoints ``μ ± R·(3·scaleᵢ·eᵢ)`` (``gaussian.py:104-138``).
  * Color = base color + SH₁..₃(normalized dir), no clamp, no offset
    (``gaussian.py:183-201``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rtgs_tpu.utils import quaternion as quat

# Level-set threshold for the hit ellipsoid and the 3σ AABB
# (reference ``gaussian.py:13``).
BOUNDING_THRESHOLD = 3.0

# Real spherical harmonics constants, degrees 1..3 (reference
# ``gaussian.py:16-23``).
C_0 = math.sqrt(3 / math.pi)
C_1 = math.sqrt(15 / math.pi)
C_2 = math.sqrt(5 / math.pi)
C_3 = math.sqrt(35 / (2 * math.pi))
C_4 = math.sqrt(105 / math.pi)
C_5 = math.sqrt(21 / (2 * math.pi))
C_6 = math.sqrt(7 / math.pi)

NUM_SH_COEFFS = 15  # degrees 1..3 → 3 + 5 + 7


class Gaussians(NamedTuple):
    """Structure-of-arrays Gaussian scene (a pytree of flat arrays).

    The reference stores an AoS Taichi struct field (``gaussian.py:26-55``);
    here we keep SoA arrays so XLA can tile them and ``NamedSharding`` can
    shard the leading (primitive) axis.

    Attributes:
      means:     (N, 3)  Gaussian centers.
      quats:     (N, 4)  rotation quaternions, scalar-last ``(x, y, z, w)``.
      scales:    (N, 3)  per-axis standard deviations (post-activation).
      colors:    (N, 3)  base RGB (post-sigmoid).
      opacities: (N,)    opacity in [0, 1] (post-sigmoid).
      sh:        (N, 15, 3)  SH coefficients, degree-major ``sh_10..sh_36``
                 (``gaussian.py:41-55``), innermost = RGB channel.
      mask:      (N,)    1.0 for live Gaussians, 0.0 for padding. Padded
                 entries never hit and never contribute.
    """

    means: jnp.ndarray
    quats: jnp.ndarray
    scales: jnp.ndarray
    colors: jnp.ndarray
    opacities: jnp.ndarray
    sh: jnp.ndarray
    mask: jnp.ndarray

    @property
    def num(self) -> int:
        return self.means.shape[0]


def new_gaussians(
    means,
    quats=None,
    scales=None,
    colors=None,
    opacities=None,
    sh=None,
    mask=None,
) -> Gaussians:
    """Python-scope constructor with the reference's defaults
    (``gaussian.py:233-247``): identity rotation, unit scale, magenta color,
    opacity 1, zero SH."""
    means = jnp.asarray(means, dtype=jnp.float32)
    n = means.shape[0]

    def dflt(x, value, shape):
        if x is None:
            return jnp.broadcast_to(jnp.asarray(value, jnp.float32), shape)
        return jnp.asarray(x, dtype=jnp.float32)

    return Gaussians(
        means=means,
        quats=dflt(quats, [0.0, 0.0, 0.0, 1.0], (n, 4)),
        scales=dflt(scales, [1.0, 1.0, 1.0], (n, 3)),
        colors=dflt(colors, [1.0, 0.0, 1.0], (n, 3)),
        opacities=dflt(opacities, 1.0, (n,)),
        sh=dflt(sh, 0.0, (n, NUM_SH_COEFFS, 3)),
        mask=dflt(mask, 1.0, (n,)),
    )


def covariance(quats: jnp.ndarray, scales: jnp.ndarray) -> jnp.ndarray:
    """``Σ = R S Sᵀ Rᵀ`` (reference ``gaussian.py:86-102``). → (..., 3, 3)."""
    r = quat.as_rotation_mat3(quats)
    rs = r * scales[..., None, :]  # R @ diag(s)
    return jnp.matmul(rs, jnp.swapaxes(rs, -1, -2),
                      precision=jax.lax.Precision.HIGHEST)


def _adjugate_inverse_3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a 3×3 via adjugate/determinant — the same algorithm
    ``ti.math.inverse`` uses in the reference (``gaussian.py:196,215``), so
    rounding behaviour is closest to the reference's."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = -(d * i - f * g)
    co02 = d * h - e * g
    co10 = -(b * i - c * h)
    co11 = a * i - c * g
    co12 = -(a * h - b * g)
    co20 = b * f - c * e
    co21 = -(a * f - c * d)
    co22 = a * e - b * d
    det = a * co00 + b * co01 + c * co02
    adj = jnp.stack(
        [
            jnp.stack([co00, co10, co20], axis=-1),
            jnp.stack([co01, co11, co21], axis=-1),
            jnp.stack([co02, co12, co22], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def inv_covariance(quats: jnp.ndarray, scales: jnp.ndarray) -> jnp.ndarray:
    """``Σ⁻¹`` via adjugate of the assembled Σ, mirroring the reference's
    ``ti.math.inverse(self.cov())`` (``gaussian.py:196,215``)."""
    return _adjugate_inverse_3x3(covariance(quats, scales))


def inv_covariance_direct(quats: jnp.ndarray, scales: jnp.ndarray) -> jnp.ndarray:
    """``Σ⁻¹ = R S⁻² Rᵀ`` — algebraically identical, fewer ops and better
    conditioned; used by the production kernels."""
    r = quat.as_rotation_mat3(quats)
    rs = r / scales[..., None, :]
    return jnp.matmul(rs, jnp.swapaxes(rs, -1, -2),
                      precision=jax.lax.Precision.HIGHEST)


def _rotation_columns(quats: jnp.ndarray):
    """The three rotated basis vectors (columns of R), each (..., 3) —
    the flat-component building block: the hot paths assemble what they
    need from these (N,)-shaped columns instead of materializing
    (..., 3, 3) arrays with tiny, padding-prone minor dims."""
    shape = quats.shape[:-1]
    ex = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), shape + (3,))
    ey = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), shape + (3,))
    ez = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), shape + (3,))
    return (quat.rot_vec3(quats, ex), quat.rot_vec3(quats, ey),
            quat.rot_vec3(quats, ez))


def inv_covariance_packed6(quats: jnp.ndarray, scales: jnp.ndarray):
    """``Σ⁻¹`` entries ``[m00, m01, m02, m11, m12, m22]`` as (..., 6).

    Identical algorithm to :func:`inv_covariance` (assemble
    ``Σ = R S² Rᵀ``, invert by adjugate/determinant — the reference's
    ``ti.math.inverse``, ``gaussian.py:196,215``) carried out entirely in
    flat per-component arrays: no (..., 3, 3) intermediate exists, so
    nothing pads (see :func:`_rotation_columns`)."""
    mx, my, mz = _rotation_columns(quats)
    sx, sy, sz = (scales[..., 0], scales[..., 1], scales[..., 2])
    ux, uy, uz = mx[..., 0] * sx, mx[..., 1] * sx, mx[..., 2] * sx
    vx, vy, vz = my[..., 0] * sy, my[..., 1] * sy, my[..., 2] * sy
    wx, wy, wz = mz[..., 0] * sz, mz[..., 1] * sz, mz[..., 2] * sz
    # Σ = u uᵀ + v vᵀ + w wᵀ (the R·diag(s) matmul's k-ascending sum).
    s00 = ux * ux + vx * vx + wx * wx
    s01 = ux * uy + vx * vy + wx * wy
    s02 = ux * uz + vx * vz + wx * wz
    s11 = uy * uy + vy * vy + wy * wy
    s12 = uy * uz + vy * vz + wy * wz
    s22 = uz * uz + vz * vz + wz * wz
    # Adjugate of the symmetric Σ (cofactor formulas verbatim from
    # _adjugate_inverse_3x3 with b=d=s01, c=g=s02, f=h=s12).
    co00 = s11 * s22 - s12 * s12
    co01 = -(s01 * s22 - s12 * s02)
    co02 = s01 * s12 - s11 * s02
    det = s00 * co00 + s01 * co01 + s02 * co02
    m00 = co00 / det
    m01 = co01 / det                       # adjᵀ: co10 == co01 for sym
    m02 = co02 / det
    m11 = (s00 * s22 - s02 * s02) / det
    m12 = -(s00 * s12 - s01 * s02) / det
    m22 = (s00 * s11 - s01 * s01) / det
    return m00, m01, m02, m11, m12, m22


def aabb(means: jnp.ndarray, quats: jnp.ndarray, scales: jnp.ndarray):
    """Axis-aligned bounds from the 6 principal-axis endpoints
    ``μ ± 3·scaleᵢ·(R eᵢ)`` (reference ``gaussian.py:104-138``).

    Returns ``(p_min, p_max)``, each (..., 3). Conservative for the
    ``xᵀΣ⁻¹x = 3`` ellipsoid because its semi-axes are ``√3·scaleᵢ`` and
    ``√3·√(Σⱼ R²ₖⱼ s²ⱼ) ≤ 3·maxⱼ|Rₖⱼ|sⱼ``. Assembled from the rotation
    COLUMNS, not an (..., 3, 3) matrix (see :func:`_rotation_columns`).
    """
    mx, my, mz = _rotation_columns(quats)
    ext = jnp.maximum(
        jnp.maximum(jnp.abs(mx * scales[..., 0:1]),
                    jnp.abs(my * scales[..., 1:2])),
        jnp.abs(mz * scales[..., 2:3])) * BOUNDING_THRESHOLD
    return means - ext, means + ext


def sh_basis(dirs: jnp.ndarray) -> jnp.ndarray:
    """Evaluate the reference's hardcoded real SH basis, degrees 1..3, at
    normalized directions (``gaussian.py:140-163``). → (..., 15)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    return jnp.stack(
        [
            0.5 * C_0 * y,
            0.5 * C_0 * z,
            0.5 * C_0 * x,
            0.5 * C_1 * x * y,
            0.5 * C_1 * y * z,
            0.25 * C_2 * (3 * z**2 - 1),
            0.5 * C_1 * x * z,
            0.25 * C_1 * (x**2 - y**2),
            0.25 * C_3 * y * (3 * x**2 - y**2),
            0.5 * C_4 * x * y * z,
            0.25 * C_5 * y * (5 * z**2 - 1),
            # Reference quirk kept verbatim: ``5z² − 3z`` (gaussian.py:160),
            # where the textbook Y₃₀ would be ``5z³ − 3z``.
            0.25 * C_6 * (5 * z**2 - 3 * z),
            0.25 * C_5 * x * (5 * z**2 - 1),
            0.25 * C_4 * (x**2 - y**2) * z,
            0.25 * C_3 * x * (x**2 - 3 * y**2),
        ],
        axis=-1,
    )


def eval_sh(sh: jnp.ndarray, dirs: jnp.ndarray) -> jnp.ndarray:
    """SH radiance ``Σₖ yₖ(dir) · shₖ`` (reference ``gaussian.py:165-181``).

    ``sh``: (..., 15, 3); ``dirs``: (..., 3) normalized. → (..., 3).
    """
    basis = sh_basis(dirs)  # (..., 15)
    return jnp.sum(basis[..., None] * sh, axis=-2)


def hit(
    cov_inv: jnp.ndarray,
    means: jnp.ndarray,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
):
    """Ray–Gaussian intersection against ``xᵀΣ⁻¹x = 3``
    (reference ``gaussian.py:203-230``).

    All args broadcast; returns ``(t1, t2)`` sorted ascending, with the
    reference's exact miss semantics: ``Δ < 0 → (inf, inf)``;
    ``Δ == 0 → (−B/2A, inf)``.
    """
    e = origins - means  # (..., 3)
    # HIGHEST: a reduced-precision matmul (bf16 or TF32 inputs) feeds the
    # cancellation-sensitive quadratic (c = eᵀΣ⁻¹e − 3 subtracts ~equal
    # magnitudes) and wrecks the rendered image.
    hp = jax.lax.Precision.HIGHEST
    me = jnp.einsum("...ij,...j->...i", cov_inv, e, precision=hp)
    md = jnp.einsum("...ij,...j->...i", cov_inv, directions, precision=hp)
    a = jnp.sum(directions * md, axis=-1)
    b = 2.0 * jnp.sum(directions * me, axis=-1)
    c = jnp.sum(e * me, axis=-1) - BOUNDING_THRESHOLD
    delta = b * b - 4 * a * c
    sq = jnp.sqrt(jnp.where(delta > 0, delta, 1.0))  # grad-safe sqrt
    inf = jnp.inf
    t1 = jnp.where(
        delta > 0,
        (-b - sq) / (2 * a),
        jnp.where(delta == 0, -b / (2 * a), inf),
    )
    t2 = jnp.where(delta > 0, (-b + sq) / (2 * a), inf)
    return t1, t2


def eval_gaussian(
    cov_inv: jnp.ndarray,
    means: jnp.ndarray,
    colors: jnp.ndarray,
    opacities: jnp.ndarray,
    sh: jnp.ndarray,
    pos: jnp.ndarray,
    dirs: jnp.ndarray,
):
    """Literal port of the reference's ``Gaussian.eval`` semantics
    (``gaussian.py:183-201``): evaluate the (unnormalized, no-½) Gaussian
    response at ``pos`` and the SH color for view direction ``dirs``.

    Returns ``(rgb, alpha)``.
    """
    d = pos - means
    md = jnp.einsum("...ij,...j->...i", cov_inv, d,
                    precision=jax.lax.Precision.HIGHEST)
    rho = jnp.exp(-jnp.sum(d * md, axis=-1))
    alpha = opacities * rho
    dirs_n = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb = colors + eval_sh(sh, dirs_n)
    return rgb, alpha

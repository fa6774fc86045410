"""Shared test helpers."""

import numpy as np


def assert_images_close(actual, desired, *, q=0.99, tol=5e-4, max_tol=0.12,
                        err_msg=""):
    """Image comparison robust to the reference semantics' grazing-incidence
    discontinuity: a ray tangent to the χ²=3 ellipsoid jumps from α=0 to
    α=opacity·e⁻³ (gaussian.py:203-230 makes this inherent, not a bug), so
    two f32 evaluations of the same quadratic can flip hit/miss on a
    measure-zero set of silhouette pixels.

    Asserts the q-quantile of |diff| is below ``tol`` (bulk parity) and the
    max below ``max_tol`` (any flip is bounded by one boundary alpha).
    """
    a, d = np.asarray(actual), np.asarray(desired)
    assert a.shape == d.shape, f"shape {a.shape} != {d.shape} {err_msg}"
    diff = np.abs(a - d)
    qv = np.quantile(diff, q)
    assert qv < tol, (
        f"{q:.3f}-quantile |diff| = {qv:.2e} >= {tol:.2e} {err_msg}")
    assert diff.max() < max_tol, (
        f"max |diff| = {diff.max():.2e} >= {max_tol:.2e} {err_msg}")


def t1_slack(packed, pix, sid):
    """Per winner, how far two f32 evaluations of its entry depth may
    differ: a few f32 ulps of the discriminant's terms (B² and 4AC; the
    compiler may fuse a multiply-add in one program and not the other),
    propagated through t1 = (−B − √Δ)/2A, i.e. divided by 4A√Δ, plus a few
    ulps of t1 itself. Computed in float64 from the winner's features."""
    f = np.asarray(packed, np.float64)[np.where(np.isfinite(sid), sid, 0)
                                       .astype(np.int64)]       # (T,P,K,F)
    x = np.asarray(pix, np.float64)[:, :, None, :]              # (T,P,1,G)
    a = sum(x[..., 3 + j] * f[..., j] for j in range(6))
    b = 2.0 * sum(x[..., j] * f[..., 6 + j] for j in range(3))
    four_ac = 4.0 * a * f[..., 9]
    delta = np.maximum(b * b - four_ac, 1e-30)
    t1 = (-b - np.sqrt(delta)) / (2.0 * a)
    eps = np.finfo(np.float32).eps
    return (8 * eps * np.maximum(b * b, np.abs(four_ac))
            / (4.0 * a * np.sqrt(delta)) + 8 * eps * np.abs(t1))

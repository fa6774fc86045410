"""The Pallas-Triton keys kernel (``rtgs_tpu.ops.peel``) under the Pallas
interpreter against its plain XLA form, the dispatch around it, and the
precision contract of the keys program. The compiled kernel runs only on
a GPU (``-m gpu``; ``chip_smoke.py`` phase (d) covers it there)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rtgs_tpu.camera import camera_from_fov
from rtgs_tpu.ops.peel import (CHUNK, peel_keys, peel_keys_triton,
                               peel_keys_xla)
from rtgs_tpu.render.binning import tile_candidates
from rtgs_tpu.render.tiled import (_tile_pixel_features, pack_features,
                                   precompute_features, render_tiled_keys)
from rtgs_tpu.scene import random_scene
from rtgs_tpu.viewer.orbit import orbit_camera_pose


def _cam(res, r=3.0):
    pos, rot, _, _ = orbit_camera_pose(
        0.3, 1.2, r, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    return camera_from_fov(pos, rot, res, 60.0)


def _inputs(g, cam, max_candidates=384):
    b = tile_candidates(g, cam, tile=(16, 16), max_candidates=max_candidates,
                        max_global=32, chunk=CHUNK)
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, (16, 16))
    return packed, b.candidates, pix, b.chunk_lb


def _assert_same_keys(kernel_out, xla_out, packed, pix):
    """Identical splat ids (selection, tie order, vacancies); identical
    hit pattern; each t1 within its own float32 slack (``t1_slack``)."""
    from tests._utils import t1_slack

    t1_k, sid_k = (np.asarray(x).transpose(0, 2, 1) for x in kernel_out)
    t1_x, sid_x = (np.asarray(x) for x in xla_out)
    np.testing.assert_array_equal(sid_k, sid_x)
    fin = np.isfinite(t1_k)
    np.testing.assert_array_equal(fin, np.isfinite(t1_x))
    slack = t1_slack(packed, pix, sid_x)
    err = np.abs(t1_k[fin] - t1_x[fin])
    assert (err <= slack[fin]).all(), (err / slack[fin]).max()
    return fin


@pytest.mark.parametrize("depth", [1, 4, 16])
def test_kernel_matches_xla_depths(key, depth):
    g = random_scene(key, 400, extent=1.0)
    packed, cand, pix, lb = _inputs(g, _cam((32, 32)))
    fin = _assert_same_keys(
        peel_keys_triton(packed, cand, pix, depth, chunk_lb=lb,
                         interpret=True),
        peel_keys_xla(packed, cand, pix, depth), packed, pix)
    assert fin.any()


def test_kernel_counts_not_chunk_multiples(key):
    """Multi-chunk tiles whose candidate counts are not multiples of the
    chunk: the last chunk's loop bound stops at the count."""
    g = random_scene(key, 1500, extent=0.6, scale_range=(0.01, 0.06))
    packed, cand, pix, lb = _inputs(g, _cam((32, 32), r=2.0),
                                    max_candidates=450)
    counts = np.asarray(jnp.sum(cand >= 0, axis=1))
    assert ((counts > CHUNK) & (counts % CHUNK != 0)).all(), counts
    _assert_same_keys(
        peel_keys_triton(packed, cand, pix, 8, chunk_lb=lb, interpret=True),
        peel_keys_xla(packed, cand, pix, 8), packed, pix)


def test_kernel_empty_tile(key):
    """A tile with no candidates returns all-vacant layers (t1 = sid =
    +inf) and leaves its neighbours untouched."""
    g = random_scene(key, 300, extent=1.0)
    packed, cand, pix, lb = _inputs(g, _cam((32, 32)))
    cand = cand.at[1].set(-1)
    t1, sid = peel_keys_triton(packed, cand, pix, 4, chunk_lb=lb,
                               interpret=True)
    assert np.isinf(np.asarray(t1[1])).all()
    assert np.isinf(np.asarray(sid[1])).all()
    _assert_same_keys((t1, sid), peel_keys_xla(packed, cand, pix, 4),
                      packed, pix)


def test_kernel_exact_depth_ties(key):
    """Duplicated splats give bitwise-equal t1; both forms break the tie
    to the LOWER splat id, and both copies enter the K-list."""
    g = random_scene(key, 200, extent=1.0)
    g = jax.tree.map(lambda x: jnp.concatenate([x, x], axis=0), g)
    packed, cand, pix, lb = _inputs(g, _cam((32, 32)))
    t1, sid = peel_keys_triton(packed, cand, pix, 8, chunk_lb=lb,
                               interpret=True)
    _assert_same_keys((t1, sid), peel_keys_xla(packed, cand, pix, 8),
                      packed, pix)
    t1, sid = np.asarray(t1), np.asarray(sid)
    fin = np.isfinite(t1[:, 1:])
    tie = fin & (t1[:, 1:] == t1[:, :-1])
    assert tie.any()
    # Within a tie the lower id comes first: copy i (< 200) before i+200.
    assert (sid[:, :-1][tie] < sid[:, 1:][tie]).all()
    assert (sid[:, 1:][tie] - sid[:, :-1][tie] == 200).all()


@pytest.mark.parametrize("depth", [1, 16])
def test_early_termination_equals_full_sweep(key, depth):
    """With the binning's suffix bounds the kernel stops early; the keys
    must be bitwise those of the bound-free full sweep."""
    g = random_scene(key, 3000, extent=0.6, scale_range=(0.01, 0.06))
    packed, cand, pix, lb = _inputs(g, _cam((32, 32), r=2.0),
                                    max_candidates=1024)
    assert int(jnp.max(jnp.sum(cand >= 0, axis=1))) > 2 * CHUNK
    # The bounds must be informative (> 0) past the first chunk.
    assert (np.asarray(lb)[:, 1] > 0).any()
    full = peel_keys_triton(packed, cand, pix, depth, interpret=True)
    early = peel_keys_triton(packed, cand, pix, depth, chunk_lb=lb,
                             interpret=True)
    for a, b in zip(full, early):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_render_auto_chooses_keys(key, monkeypatch):
    """render(renderer="auto") takes the keys path above 4096 splats on
    every backend, and the oracle at or below it."""
    from rtgs_tpu.render import api, oracle, tiled

    calls = []
    monkeypatch.setattr(tiled, "render_tiled_keys",
                        lambda *a, **k: calls.append("keys"))
    monkeypatch.setattr(oracle, "render_oracle",
                        lambda *a, **k: calls.append("oracle"))
    cam = _cam((16, 16))
    api.render(random_scene(key, api._ORACLE_MAX_N + 1), cam,
               renderer="auto", max_candidates=256)
    api.render(random_scene(key, api._ORACLE_MAX_N), cam, renderer="auto",
               max_candidates=256)
    assert calls == ["keys", "oracle"]


def _eqns(jaxpr):
    """Every equation of ``jaxpr`` and of its nested jaxprs."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    yield from _eqns(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    yield from _eqns(sub)


def test_peel_keys_never_interprets_unless_asked(key):
    """The interpreter runs only for impl="interpret"; "auto" on the CPU
    is the XLA form (no kernel at all); "triton" compiles the kernel for
    real — on the CPU that is an error, never a silent fallback."""
    g = random_scene(key, 100, extent=1.0)
    packed, cand, pix, lb = _inputs(g, _cam((32, 32)))

    def kernels(impl):
        jaxpr = jax.make_jaxpr(lambda p: peel_keys(
            p, cand, pix, 4, impl=impl, chunk_lb=lb))(packed)
        return [e for e in _eqns(jaxpr.jaxpr)
                if e.primitive.name == "pallas_call"]

    assert kernels("auto") == []
    assert kernels("xla") == []
    (k,) = kernels("triton")
    assert not k.params["interpret"]
    (k,) = kernels("interpret")
    assert k.params["interpret"]
    with pytest.raises(Exception):
        jax.block_until_ready(peel_keys(packed, cand, pix, 4, impl="triton",
                                        chunk_lb=lb))


def test_keys_program_precision_pinned(key):
    """Every dot_general of the keys forward+grad program carries
    Precision.HIGHEST, so none runs with TF32 inputs on the GPU: the
    quadratic's discriminant and the scales chain of the backward cancel
    large terms."""
    g = random_scene(key, 300, extent=1.0)
    cam = _cam((32, 32))
    kw = dict(depth=8, tile=(16, 16), max_candidates=256, max_global=32)

    def loss(gg):
        return jnp.sum(render_tiled_keys(gg, cam, keys_impl="interpret",
                                         **kw) ** 2)

    with jax.default_matmul_precision("default"):
        jaxpr = jax.make_jaxpr(jax.grad(loss))(g)
    hp = jax.lax.Precision.HIGHEST
    dots = [e for e in _eqns(jaxpr.jaxpr)
            if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        assert e.params["precision"] == (hp, hp), e


@pytest.mark.gpu
def test_kernel_compiled_matches_xla(gpu, key):
    """The kernel as the GPU compiles it against the XLA form: identical
    selection up to near-tie reorderings from last-bit t1 differences."""
    g = random_scene(key, 2000, extent=1.0)
    packed, cand, pix, lb = _inputs(g, _cam((64, 64)))
    t1_k, sid_k = peel_keys_triton(packed, cand, pix, 16, chunk_lb=lb)
    t1_x, sid_x = peel_keys_xla(packed, cand, pix, 16)
    same = np.asarray(sid_k).transpose(0, 2, 1) == np.asarray(sid_x)
    assert same.mean() > 0.999, same.mean()

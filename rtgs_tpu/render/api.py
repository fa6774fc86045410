"""Renderer dispatch: one ``render()`` entry point over the available paths.

  * ``oracle`` — brute force O(N·P), exact reference semantics
    (:mod:`rtgs_tpu.render.oracle`). Differentiable.
  * ``keys``   — tile-binned candidate lists, per-pixel top-K selection
    (the Triton kernel on the GPU) and XLA winner shading
    (:func:`rtgs_tpu.render.tiled.render_tiled_keys`). The production
    path. Differentiable.
  * ``tiled``  — the same binning with every candidate intersected and
    peeled in plain XLA (:func:`rtgs_tpu.render.tiled.render_tiled`).
  * ``auto``   — keys for large scenes, oracle for small ones, on every
    backend.
"""

from __future__ import annotations

import jax.numpy as jnp

from rtgs_tpu import gaussians as G
from rtgs_tpu.camera import Camera

# Below this many Gaussians brute force is both exact and faster than
# binning overhead.
_ORACLE_MAX_N = 4096


def render(g: G.Gaussians, camera: Camera, depth: int = 16,
           renderer: str = "auto", **kwargs) -> jnp.ndarray:
    """Render a full frame. Returns (W, H, 3) radiance."""
    if renderer == "auto":
        renderer = "oracle" if g.num <= _ORACLE_MAX_N else "keys"
    if renderer == "oracle":
        from rtgs_tpu.render.oracle import render_oracle

        # Tiled-only tuning knobs (candidate budgets, banding) have no
        # meaning for brute force — drop them instead of raising so one CLI
        # flag set drives every path.
        kwargs = {k: v for k, v in kwargs.items()
                  if k not in ("max_candidates", "max_global",
                               "tile_bands", "max_tiles_local", "tile",
                               "bin_narrow")}
        return render_oracle(g, camera, depth=depth, **kwargs)
    if renderer == "tiled":
        from rtgs_tpu.render.tiled import render_tiled

        # render_tiled has no banding knob (its per-chunk lax.map already
        # bounds memory) — accept and drop it.
        kwargs.pop("tile_bands", None)
        return render_tiled(g, camera, depth=depth, **kwargs)
    if renderer == "keys":
        from rtgs_tpu.render.tiled import render_tiled_keys

        return render_tiled_keys(g, camera, depth=depth, **kwargs)
    raise ValueError(f"unknown renderer {renderer!r}")


def render_progressive(g: G.Gaussians, camera: Camera, depth: int = 16,
                       samples: int = 1, renderer: str = "auto",
                       jitter: bool = False, key=None,
                       **kwargs) -> jnp.ndarray:
    """Progressive multi-sample render — the reference's sample-accumulation
    semantics (``/root/reference/src/rtgs/ray_tracer.py:39-77`` accumulated
    over the ``__main__.py:253-258`` loop), realized for an offline renderer.

    The reference casts deterministic pixel-center rays, so its ``N``
    accumulated samples are ``N`` copies of the same image and the converged
    display equals one sample exactly — with ``jitter=False`` (parity mode)
    this function therefore renders once, which IS the reference's converged
    buffer (tested in tests/test_progressive.py). With ``jitter=True`` each
    sample after the first gets a uniform subpixel offset (the accumulation
    machinery doing real antialiasing work — the capability the reference's
    progressive loop is built for); binning conservatively pads projected
    AABBs by the 0.5 px jitter radius.
    """
    if samples <= 1 or not jitter:
        return render(g, camera, depth=depth, renderer=renderer, **kwargs)
    import jax

    if key is None:
        key = jax.random.PRNGKey(0)
    accum = None
    for s in range(samples):
        off = (None if s == 0 else jax.random.uniform(
            jax.random.fold_in(key, s), (2,), minval=-0.5, maxval=0.5))
        img = render(g, camera, depth=depth, renderer=renderer,
                     pixel_offset=off, **kwargs)
        accum = img if accum is None else accum + img
    return accum / samples


class ProgressiveSampler:
    """Stateful sample accumulator mirroring the reference ``RayTracer``'s
    progressive-display contract (``ray_tracer.py:39-77``): ``sample()``
    adds one full peel pass to the buffer, ``clear()`` resets on camera
    motion, ``display()`` divides by the sample count.

    One ``sample()`` here composites all ``depth`` layers in a single fused
    program, where the reference runs one kernel launch per layer — so the
    reference's *fractional* denominator ``num_samples + steps/depth``
    (partial-pass display, ``ray_tracer.py:75-77``) collapses to the whole
    sample count: there are no partial passes to display. This is the one
    deliberate deviation from the progressive contract (documented +
    tested)."""

    def __init__(self, g, camera, depth: int = 16, renderer: str = "auto",
                 jitter: bool = False, key=None, **kwargs):
        import jax

        self._g, self._camera = g, camera
        self._depth, self._renderer = depth, renderer
        self._jitter, self._kwargs = jitter, kwargs
        self._key = key if key is not None else jax.random.PRNGKey(0)
        self.clear()

    def clear(self):
        self._buf = None
        self.num_samples = 0

    def sample(self):
        import jax

        off = (None if (self.num_samples == 0 or not self._jitter)
               else jax.random.uniform(
                   jax.random.fold_in(self._key, self.num_samples), (2,),
                   minval=-0.5, maxval=0.5))
        img = render(self._g, self._camera, depth=self._depth,
                     renderer=self._renderer, pixel_offset=off,
                     **self._kwargs)
        self._buf = img if self._buf is None else self._buf + img
        self.num_samples += 1
        return self

    def display(self) -> jnp.ndarray:
        if self._buf is None:
            raise RuntimeError("no samples accumulated; call sample() first")
        return self._buf / self.num_samples

"""3DGS optimization loop — the reference's stub ``Solver`` made real.

The reference sketches the recipe as TODOs (``/root/reference/src/rtgs/
solver.py:22-42``: update camera params → rasterize → L1 + D-SSIM loss →
optimize → adaptive density control); here it is a working loop:

  * raw (pre-activation) parameters in a :class:`SceneParams` pytree, the
    exact inverse of the loader's activations (``scene.py:103-114``), so
    optimized scenes round-trip through ``save_scene`` into the reference
    viewer;
  * differentiable forward through the tiled (or oracle / ring-sharded)
    renderer; Adam with the standard per-parameter-group 3DGS learning
    rates via ``optax.multi_transform``;
  * adaptive density control with **static capacity**: clone/split/prune
    rewrite masked slots on the host between jitted steps, so the train
    step never recompiles until capacity grows;
  * ``np.savez`` checkpoints of params + optimizer state.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pathlib
from functools import partial
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rtgs_tpu import gaussians as G
from rtgs_tpu.camera import Camera
from rtgs_tpu.config import TrainConfig
from rtgs_tpu.train.loss import psnr, render_loss

logger = logging.getLogger(__name__)


class SceneParams(NamedTuple):
    """Raw optimizable parameters (pre-activation).

    Activation contract (must match the loader, ``scene.py:103-114``):
    ``scales = exp(log_scales)``, ``colors = sigmoid(color_logits)``,
    ``opacities = sigmoid(opacity_logits)``, ``quats`` normalized.
    """

    means: jnp.ndarray          # (N, 3)
    quats: jnp.ndarray          # (N, 4) raw, normalized on activation
    log_scales: jnp.ndarray     # (N, 3)
    color_logits: jnp.ndarray   # (N, 3)
    opacity_logits: jnp.ndarray  # (N,)
    sh: jnp.ndarray             # (N, 15, 3)


def activate(params: SceneParams, mask: jnp.ndarray) -> G.Gaussians:
    """Raw params → renderable scene (the loader's activations)."""
    quats = params.quats / jnp.linalg.norm(
        params.quats, axis=-1, keepdims=True)
    return G.Gaussians(
        means=params.means,
        quats=quats,
        scales=jnp.exp(params.log_scales),
        colors=jax.nn.sigmoid(params.color_logits),
        opacities=jax.nn.sigmoid(params.opacity_logits),
        sh=params.sh,
        mask=mask,
    )


def init_params(g: G.Gaussians) -> SceneParams:
    """Inverse-activate an existing scene into raw parameters."""
    eps = 1e-6
    colors = jnp.clip(g.colors, eps, 1 - eps)
    opac = jnp.clip(g.opacities, eps, 1 - eps)
    return SceneParams(
        means=g.means,
        quats=g.quats,
        log_scales=jnp.log(jnp.maximum(g.scales, 1e-30)),
        color_logits=jnp.log(colors) - jnp.log1p(-colors),
        opacity_logits=jnp.log(opac) - jnp.log1p(-opac),
        sh=g.sh,
    )


def init_params_from_points(key, points: jnp.ndarray,
                            colors: Optional[jnp.ndarray] = None
                            ) -> SceneParams:
    """Fresh initialization from a point cloud (the fit-from-scratch path):
    isotropic scales from mean nearest-neighbor distance, opacity 0.1."""
    n = points.shape[0]
    # Cheap kNN proxy: median pairwise distance of a random subsample.
    sub = points[: min(n, 512)]
    d2 = jnp.sum((sub[:, None] - sub[None, :]) ** 2, -1)
    d2 = jnp.where(d2 > 0, d2, jnp.inf)
    nn = jnp.sqrt(jnp.min(d2, axis=-1))
    scale = jnp.clip(jnp.median(nn), 1e-4, 1.0)
    if colors is None:
        colors = jnp.full((n, 3), 0.5)
    eps = 1e-6
    colors = jnp.clip(colors, eps, 1 - eps)
    quats = jnp.zeros((n, 4)).at[:, 3].set(1.0)
    return SceneParams(
        means=jnp.asarray(points, jnp.float32),
        quats=quats,
        log_scales=jnp.full((n, 3), jnp.log(scale)),
        color_logits=jnp.log(colors) - jnp.log1p(-colors),
        opacity_logits=jnp.full((n,), float(np.log(0.1 / 0.9))),
        sh=jnp.zeros((n, G.NUM_SH_COEFFS, 3)),
    )


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    """Per-parameter-group Adam (3DGS standard recipe)."""
    def adam(lr):
        return optax.adam(lr, eps=1e-15)

    return optax.multi_transform(
        {
            "means": adam(cfg.lr_means),
            "quats": adam(cfg.lr_quats),
            "log_scales": adam(cfg.lr_scales),
            "color_logits": adam(cfg.lr_colors),
            "opacity_logits": adam(cfg.lr_opacities),
            "sh": adam(cfg.lr_sh),
        },
        SceneParams(
            means="means", quats="quats", log_scales="log_scales",
            color_logits="color_logits", opacity_logits="opacity_logits",
            sh="sh"),
    )


def make_train_step(cfg: TrainConfig, optimizer, depth: int = 16,
                    renderer: str = "auto", **render_kwargs):
    """Build the jitted training step.

    Returns ``step(params, mask, opt_state, camera, target) →
    (params, opt_state, metrics)`` where metrics carries loss, PSNR, and the
    per-Gaussian positional gradient norms the density controller consumes.
    """
    from rtgs_tpu.render.api import render

    def loss_fn(params, mask, camera, target):
        g = activate(params, mask)
        img = render(g, camera, depth=depth, renderer=renderer,
                     **render_kwargs)
        return render_loss(img, target, cfg.lambda_dssim), img

    @jax.jit
    def step(params, mask, opt_state, camera: Camera, target):
        (loss, img), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, mask, camera, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        metrics = {
            "loss": loss,
            "psnr": psnr(img, target),
            "grad_means_norm": jnp.linalg.norm(grads.means, axis=-1),
        }
        return params, opt_state, metrics

    return step


@dataclasses.dataclass
class Solver:
    """Training orchestrator (the realized ``solver.py:10-42``).

    Owns the host-side pieces a jitted step can't: camera sampling, adaptive
    density control over the padded capacity, opacity resets, checkpoints.
    """

    params: SceneParams
    mask: jnp.ndarray
    cfg: TrainConfig
    cameras: Sequence[Camera]
    targets: Sequence[jnp.ndarray]
    depth: int = 16
    renderer: str = "auto"
    render_kwargs: dict = dataclasses.field(default_factory=dict)
    capacity_multiple: int = 256

    def __post_init__(self):
        self.optimizer = make_optimizer(self.cfg)
        self.opt_state = self.optimizer.init(self.params)
        self.step_fn = make_train_step(
            self.cfg, self.optimizer, self.depth, self.renderer,
            **self.render_kwargs)
        self.step = 0
        self._grad_accum = np.zeros(self.mask.shape[0], np.float32)
        self._grad_count = np.zeros(self.mask.shape[0], np.int32)
        self.scene_extent = float(np.percentile(
            np.linalg.norm(np.asarray(self.params.means), axis=-1), 90))

    @property
    def num_live(self) -> int:
        return int(np.asarray(self.mask).sum())

    def scene(self) -> G.Gaussians:
        return activate(self.params, self.mask)

    def train_step(self) -> dict:
        i = self.step % len(self.cameras)
        params, opt_state, metrics = self.step_fn(
            self.params, self.mask, self.opt_state, self.cameras[i],
            self.targets[i])
        self.params, self.opt_state = params, opt_state
        gn = np.asarray(metrics["grad_means_norm"])
        self._grad_accum += gn
        # Visibility-weighted stats (3DGS recipe): a Gaussian's densify
        # signal averages only over steps where it actually received
        # gradient (≈ was visible in the sampled view), not all steps.
        self._grad_count += (gn > 0).astype(np.int32)
        self.step += 1

        c = self.cfg
        if (c.densify_from <= self.step <= c.densify_until
                and self.step % c.densify_every == 0):
            self.densify_and_prune()
        if c.opacity_reset_every and self.step % c.opacity_reset_every == 0:
            self.reset_opacity()
        return {k: float(np.asarray(v)) for k, v in metrics.items()
                if np.asarray(v).ndim == 0}

    # ----- adaptive density control (host-side, static capacity) -----

    def densify_and_prune(self):
        c = self.cfg
        mask0 = np.asarray(self.mask).astype(bool)
        grad_avg = self._grad_accum / np.maximum(self._grad_count, 1)
        self._grad_accum[:] = 0
        self._grad_count[:] = 0

        opac = 1 / (1 + np.exp(-np.asarray(self.params.opacity_logits)))
        scales = np.exp(np.asarray(self.params.log_scales))
        max_scale = scales.max(-1)

        prune = mask0 & ((opac < c.prune_opacity)
                         | (max_scale > c.prune_max_scale
                            * self.scene_extent))
        dense_limit = c.percent_dense * self.scene_extent
        hot = mask0 & ~prune & (grad_avg > c.densify_grad_threshold)
        clone = hot & (max_scale <= dense_limit)
        split = hot & (max_scale > dense_limit)

        needed = int(clone.sum() + split.sum())
        free_after_prune = int((~mask0).sum() + prune.sum())
        if needed > free_after_prune:
            self._grow(needed - free_after_prune)

        # Snapshot (possibly grown) state into mutable numpy arrays.
        params = jax.tree.map(
            lambda x: np.array(np.asarray(x)), self.params)
        mask = np.asarray(self.mask).astype(bool)
        mask[: len(prune)][prune] = False
        free = np.nonzero(~mask)[0]
        rng = np.random.default_rng(self.step)
        touched = np.zeros(mask.shape[0], bool)   # slots whose Adam moments
        touched[: len(prune)][prune] = True       # must be re-zeroed

        def copy_rows(dst_slots, src_idx):
            for f in params._fields:
                getattr(params, f)[dst_slots] = getattr(params, f)[src_idx]
            mask[dst_slots] = True
            touched[dst_slots] = True

        # Clone: duplicate in place (the 3DGS recipe the reference's stub
        # names at solver.py:36-38 "adaptive density control").
        idx = np.nonzero(clone)[0]
        slots, free = free[: len(idx)], free[len(idx):]
        copy_rows(slots, idx)

        # Split: two children sampled inside the parent, scales / 1.6.
        idx = np.nonzero(split)[0]
        slots, free = free[: len(idx)], free[len(idx):]
        touched[idx] = True  # split parents are rewritten in place too
        if len(idx):
            from rtgs_tpu.utils import quaternion as quat

            q = params.quats[idx]
            q = q / np.linalg.norm(q, axis=-1, keepdims=True)
            r = np.asarray(quat.as_rotation_mat3(jnp.asarray(q)))
            copy_rows(slots, idx)
            for tgt in (slots, idx):
                noise = rng.normal(size=(len(idx), 3)) * scales[idx]
                params.means[tgt] = (
                    params.means[idx] if tgt is slots else params.means[tgt])
                params.means[tgt] = (
                    params.means[tgt]
                    + np.einsum("nij,nj->ni", r, noise)).astype(np.float32)
                params.log_scales[tgt] = (
                    params.log_scales[idx] - np.log(1.6)
                ).astype(np.float32)

        self.params = jax.tree.map(jnp.asarray, params)
        self.mask = jnp.asarray(mask.astype(np.float32))
        # Per-slot Adam moments: ZERO only the touched rows (new children,
        # split parents whose geometry changed, pruned slots); every
        # untouched Gaussian keeps its momentum. (A full optimizer reset
        # every densify wipes Adam moments for all
        # parameters and is known to hurt 3DGS convergence.)
        self.opt_state = self._zero_opt_rows(np.asarray(touched))
        logger.info(
            "densify@%d: %d clones, %d splits, %d pruned, live=%d",
            self.step, int(clone.sum()), int(split.sum()),
            int(prune.sum()), self.num_live)

    def _map_opt_slot_arrays(self, fn):
        """Apply ``fn`` to every optimizer-state leaf that is a per-slot
        array (leading dim == capacity): Adam's mu/nu live there. Scalar
        counts and optax ``MaskedNode`` sentinels pass through."""
        cap = self.mask.shape[0]

        def visit(x):
            if (hasattr(x, "ndim") and getattr(x, "ndim", 0) >= 1
                    and x.shape[0] == cap):
                return fn(x)
            return x

        return jax.tree.map(visit, self.opt_state)

    def _zero_opt_rows(self, touched: np.ndarray):
        t = jnp.asarray(touched)

        def zero_rows(x):
            sel = t.reshape((-1,) + (1,) * (x.ndim - 1))
            return jnp.where(sel, jnp.zeros_like(x), x)

        return self._map_opt_slot_arrays(zero_rows)

    def _grow(self, min_extra: int):
        """Grow capacity to the next multiple (recompiles the step)."""
        cap = self.mask.shape[0]
        m = self.capacity_multiple
        # At least +50% headroom so growth (and recompiles) stay rare.
        new_cap = -(-max(cap + min_extra, cap + cap // 2) // m) * m
        pad = new_cap - cap
        logger.info("growing capacity %d → %d", cap, new_cap)

        def pad_arr(x, fill=0.0):
            widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths, constant_values=fill)

        p = self.params
        self.params = SceneParams(
            means=pad_arr(p.means),
            quats=pad_arr(p.quats).at[cap:, 3].set(1.0),
            log_scales=pad_arr(p.log_scales),
            color_logits=pad_arr(p.color_logits),
            opacity_logits=pad_arr(p.opacity_logits, fill=-10.0),
            sh=pad_arr(p.sh),
        )
        # Per-slot optimizer moments grow with the params (zeros for the
        # new slots); everything else (counts, MaskedNodes) is unchanged.
        # NOTE: uses the OLD capacity for the leading-dim match, so run
        # before self.mask is replaced.
        self.opt_state = self._map_opt_slot_arrays(pad_arr)
        self.mask = pad_arr(self.mask)
        self._grad_accum = np.pad(self._grad_accum, (0, pad))
        self._grad_count = np.pad(self._grad_count, (0, pad))

    def reset_opacity(self):
        """Clamp opacities down (3DGS recipe: combats floaters). Only the
        opacity group's Adam state is reset — the INRIA recipe resets the
        opacity optimizer after the clamp so stale momentum cannot undo it,
        but every other parameter keeps its moments."""
        cap = jnp.minimum(self.params.opacity_logits,
                          float(np.log(0.01 / 0.99)))
        self.params = self.params._replace(opacity_logits=cap)
        fresh = self.optimizer.init(self.params)
        inner = dict(self.opt_state.inner_states)
        inner["opacity_logits"] = fresh.inner_states["opacity_logits"]
        self.opt_state = self.opt_state._replace(inner_states=inner)

    # ----- checkpointing (np.savez) -----

    def _opt_array_leaves(self):
        """Array leaves of the optimizer state, in tree order (non-array
        leaves like optax MaskedNode sentinels are skipped — they carry no
        state and are reconstructed from a fresh init on restore)."""
        return [np.asarray(x) for x in jax.tree.leaves(self.opt_state)
                if hasattr(x, "ndim")]

    def checkpoint_path(self, directory, step: int) -> pathlib.Path:
        return pathlib.Path(directory) / f"step_{step}.npz"

    def save_checkpoint(self, directory) -> pathlib.Path:
        """Write params, mask, step and the optimizer's array leaves to
        ``<directory>/step_<step>.npz`` (written to a temporary name, then
        renamed, so a crash never leaves a truncated checkpoint)."""
        path = self.checkpoint_path(directory, self.step)
        path.parent.mkdir(parents=True, exist_ok=True)
        arrays = {f"params/{k}": np.asarray(v)
                  for k, v in self.params._asdict().items()}
        arrays["mask"] = np.asarray(self.mask)
        arrays["step"] = np.asarray(self.step, np.int64)
        for i, leaf in enumerate(self._opt_array_leaves()):
            arrays[f"opt/{i}"] = leaf
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        return path

    def restore_checkpoint(self, directory, step: int):
        with np.load(self.checkpoint_path(directory, step)) as z:
            state = {k: z[k] for k in z.files}
        self.params = SceneParams(**{
            f: jnp.asarray(state[f"params/{f}"])
            for f in SceneParams._fields})
        self.mask = jnp.asarray(state["mask"])
        self.step = int(state["step"])
        # Rehydrate optimizer state: fresh init gives the tree structure
        # (incl. MaskedNodes); saved array leaves slot back in tree order.
        fresh = self.optimizer.init(self.params)
        leaves, treedef = jax.tree.flatten(fresh)
        n_saved = sum(k.startswith("opt/") for k in state)
        if n_saved:
            arr_iter = (state[f"opt/{i}"] for i in range(n_saved))
            leaves = [jnp.asarray(next(arr_iter)) if hasattr(x, "ndim")
                      else x for x in leaves]
        self.opt_state = jax.tree.unflatten(treedef, leaves)

    def train(self, num_steps: Optional[int] = None, log_every: int = 50):
        """Run the loop (reference stub ``solver.py:40-42`` realized)."""
        from rtgs_tpu.parallel.launcher import touch_heartbeat

        num_steps = num_steps or self.cfg.iterations
        for _ in range(num_steps):
            metrics = self.train_step()
            touch_heartbeat()  # no-op unless under the fail-fast launcher
            if self.step % log_every == 0:
                logger.info(
                    "step %d: loss=%.5f psnr=%.2f live=%d",
                    self.step, metrics["loss"], metrics["psnr"],
                    self.num_live)
            if (self.cfg.checkpoint_every
                    and self.step % self.cfg.checkpoint_every == 0):
                self.save_checkpoint(self.cfg.checkpoint_dir)
        return metrics

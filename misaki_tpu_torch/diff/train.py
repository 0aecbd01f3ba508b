"""One differentiable training step on one device: render -> L2 image loss
-> gradients of the requested leaves; the single-device counterpart of
misaki_tpu/parallel/sharding.py `train_step_sharded` (:156-181)."""

import numpy as np
import torch

from misaki_tpu_torch.diff.backprop import image_grads
from misaki_tpu_torch.scene.types import MC_REFL, MC_SPEC_TRANS, SPEC_SLOT_COLS

# misaki_tpu/parallel/sharding.py:114
DEFAULT_TRAIN_LEAVES = ("materials", "rad_coeff", "rad_curve")


def train_step(scene, target_rgb, seed=0, depth_cap=4, leaves=DEFAULT_TRAIN_LEAVES,
               **grads_kw):
    """-> (loss, {leaf: gradient}) of mean((rgb - target_rgb)^2);
    `grads_kw` (`chunk_size`, `lanes`, `reduce`) as in
    `image_grads`. The scene is flipped into diff_mode, so microfacet
    alpha takes part through the detached-sampling estimator
    (misaki_tpu_torch.diff)."""
    target = torch.as_tensor(target_rgb, dtype=torch.float32, device=scene.device)
    loss, _, grads = image_grads(scene.replace(diff_mode=True), leaves,
                                 lambda rgb: torch.mean((rgb - target) ** 2), seed=seed,
                                 depth_cap=depth_cap, **grads_kw)
    return loss, grads


def lever_direction(g, top=8, step=0.6):
    """A directional finite-difference step for a materials gradient `g`
    (N_MAT_COLS, B) numpy: its `top` largest entries, each `step` along the
    gradient's sign divided by its coefficient's lever arm. A spectral
    slot's sigmoid coefficients c0 and c1 multiply lambda^2 ~ 600^2 and
    lambda ~ 600 (misaki_tpu's tests/test_diff_and_sharding.py:52-67)."""
    dc = np.zeros_like(g)
    for idx in np.argsort(np.abs(g).reshape(-1))[::-1][:top]:
        i, j = np.unravel_index(idx, g.shape)
        off = ((i - MC_REFL) % SPEC_SLOT_COLS
               if MC_REFL <= i < MC_SPEC_TRANS + SPEC_SLOT_COLS else None)
        dc[i, j] = np.sign(g[i, j]) * step / {1: 600.0 ** 2, 2: 600.0}.get(off, 1.0)
    return dc

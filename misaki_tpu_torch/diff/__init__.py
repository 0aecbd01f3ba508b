"""Differentiable rendering: parameter leaves, the gradient of an image loss
and a single-device train step (misaki_tpu/diff, `train_step_sharded`).

Gradients follow misaki_tpu's **detached-sampling** convention:

  * Sample placement is detached. Every ray going into a cast and every
    cast's result carry no gradient (accel/traverse.py); derivatives flow
    through evaluations at fixed sample positions. Unbiased for integrand
    parameters (reflectance, radiance, Fresnel eta, microfacet alpha), blind
    to silhouettes.
  * MIS weights and the Russian-roulette q are detached
    (render/integrator.py `sample_path`): pdf ratios whose gradient terms
    cancel in expectation.
  * Microfacet alpha and the Disney slots carry gradients only under
    `scene.diff_mode` (bsdf/kernels.py). There sampling uses detached alpha
    and the rough lobes' weight is recomputed as
    f_attached(wo_detached) / pdf_detached.

The texel fetch is a `torch.autograd.Function` whose backward is a CUDA
scatter kernel (render/texel_fetch.py `Fetch4`). `backprop.image_grads`
takes the gradient of an image loss (one autograd pass over a frame that
fits a chunk; otherwise a primal render, then a chunked re-render with
autograd); `train.train_step` is one training step.
"""

from misaki_tpu_torch.diff.leaves import (  # noqa: F401
    DIFF_LEAVES,
    get_leaves,
    leaf_names,
    replace_leaves,
)

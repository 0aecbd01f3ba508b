"""Gradient steps: a closed loop of `misaki_tpu_torch.diff.train.train_step`
(render under autograd, the L2 loss against a target image, the leaves'
gradients in one autograd pass), each followed by the benchmark's Adam
update of the leaves, each done when its loss is in host memory.

Set-up builds the one training object (the scene, its leaves and Adam's
state), drives it through its first `first_steps` steps, which warm every
shape, and hands it to the window. The check holds the program to the plain
reference (`benchmark/reference/path.py` `loss_and_grads`) twice:

- the first steps: the reference's own training object, from its own
  leaves, runs the same steps on the same target and seeds; each step's
  loss, the first gradient as Adam got it (its first moment after one step,
  over 1 - beta1) and the leaves' change over the first steps are compared,
  by the worst leaf;
- one step of the window, drawn from the seed: the program's leaves before
  it and the gradient Adam got in it are kept, and the reference takes the
  step again from those leaves, comparing the loss and the gradient. The
  reference follows the program's own state here; the first steps check the
  start of that state.

The program's material table holds a row of columns per shape; the
reference's `materials` leaf holds each shape's reflectance coefficients,
which are the columns that carry a gradient. A leaf's gradient is compared
by its norm, so an entry of the program's table that takes a gradient the
reference has not shows as a gap.
"""

import torch

from benchmark import common

# the window step compared: one of WINDOW_PICKS steps from the window's
# WINDOW_FIRST-th, so the leaves have moved a few steps from the set-up's
WINDOW_FIRST = 4
WINDOW_PICKS = 8


class Trainer:
    """Leaves, Adam's state and a target; `step(i)` is one gradient step of
    `grad_fn(leaves, seed) -> (loss, {leaf: gradient})` and Adam's update.
    Steps `keep_from` .. `keep_at` keep the leaves they start from and the
    loss and gradient they take (each overwriting the last)."""

    def __init__(self, cell, grad_fn, leaves, keep_from=None, keep_at=-1):
        self.cell = cell
        self.grad_fn = grad_fn
        self.params = {k: v.detach().clone() for k, v in leaves.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self.losses = []
        self.keep_from, self.keep_at = keep_from, keep_at
        self.kept = None

    def step(self, i):
        keep = self.keep_from is not None and self.keep_from <= i <= self.keep_at
        before = {k: v.clone() for k, v in self.params.items()} if keep else None
        seed = common.frame_seed(self.cell.seed, i)
        loss, grads = self.grad_fn(self.params, seed)
        if keep:
            self.kept = {"seed": seed, "params": before, "loss": loss.detach().clone(),
                         "grads": {k: g.clone() for k, g in grads.items()}}
        hp = self.cell.traffic["adam"]
        b1, b2 = hp["betas"]
        self.t += 1
        for k, g in grads.items():
            self.m[k] = b1 * self.m[k] + (1.0 - b1) * g
            self.v[k] = b2 * self.v[k] + (1.0 - b2) * g * g
            m_hat = self.m[k] / (1.0 - b1 ** self.t)
            v_hat = self.v[k] / (1.0 - b2 ** self.t)
            self.params[k] = self.params[k] - hp["lr"][k] * m_hat / (torch.sqrt(v_hat) + hp["eps"])
        self.losses.append(float(loss))

    def first_steps(self):
        """Run the first steps; -> {"losses", "grad1" (the first gradient
        from Adam's state), "p0", "pn"} on the host."""
        b1 = self.cell.traffic["adam"]["betas"][0]
        p0 = {k: v.cpu() for k, v in self.params.items()}
        grad1 = None
        for i in range(int(self.cell.traffic["first_steps"])):
            self.step(i)
            if i == 0:
                grad1 = {k: (m / (1.0 - b1)).cpu() for k, m in self.m.items()}
        return {"losses": list(self.losses), "grad1": grad1, "p0": p0,
                "pn": {k: v.cpu() for k, v in self.params.items()}}


def make_target(cell):
    """The target image, uniform in [0, 1), from a generator on the run's
    device seeded with --seed."""
    g = torch.Generator(device=cell.device).manual_seed(int(cell.seed) % (1 << 63))
    c = cell.config
    return torch.rand((int(c["height"]), int(c["width"]), 3), generator=g, device=cell.device)


def window_pick(cell):
    """The index of the window step the check compares (the window's last,
    where it ends before that one)."""
    first = int(cell.traffic["first_steps"])
    return first + WINDOW_FIRST + int(torch.randint(0, WINDOW_PICKS, (1,),
                                                    generator=common.sample_rng(cell)))


def setup(cell):
    from misaki_tpu_torch.diff.leaves import get_leaves, replace_leaves
    from misaki_tpu_torch.diff.train import train_step

    scene = common.program_scene(cell)
    target = make_target(cell)
    tr = cell.traffic

    def grad_fn(params, seed):
        return train_step(replace_leaves(scene, params), target, seed=seed,
                          depth_cap=int(tr["depth_cap"]), leaves=tuple(tr["leaves"]),
                          chunk_size=1 << int(tr["chunk_log2"]))

    trainer = Trainer(cell, grad_fn, get_leaves(scene, tr["leaves"]),
                      keep_from=int(tr["first_steps"]), keep_at=window_pick(cell))
    first = trainer.first_steps()
    return {"trainer": trainer, "first": first, "target": target.cpu()}


def step(st, i):
    st["trainer"].step(i + int(st["trainer"].cell.traffic["first_steps"]))


def reference_grad_fn(scene, target, lanes=None):
    from benchmark.reference import path

    def grad_fn(params, seed):
        return path.loss_and_grads(scene, params, target, seed, lanes=lanes)

    return grad_fn


def reference_first_steps(cell, target, lanes=None):
    """The reference's first steps from its own leaves, on the target (the
    gradients of the first `lanes` lanes alone, where given)."""
    scene = common.reference_scene(cell)
    tr = Trainer(cell, reference_grad_fn(scene, target.to(cell.device), lanes), scene.leaves)
    return tr.first_steps()


def to_reference_leaves(params, n_shapes):
    """The program's leaves in the reference's form: of the material table
    (columns, materials), each shape's reflectance coefficients (the three
    columns after the reflectance slot's mode)."""
    from misaki_tpu_torch.scene.types import MC_REFL

    out = dict(params)
    out["materials"] = params["materials"][MC_REFL + 1:MC_REFL + 4, :n_shapes].T.contiguous()
    return out


def reference_window_step(cell, kept, target):
    """The reference's loss and gradient of the kept window step, from the
    program's leaves before it."""
    scene = common.reference_scene(cell)
    params = {k: v.to(cell.device) for k, v in
              to_reference_leaves(kept["params"], scene.leaves["materials"].shape[0]).items()}
    loss, grads = reference_grad_fn(scene, target.to(cell.device))(params, kept["seed"])
    return {"loss": float(loss), "grads": {k: g.cpu() for k, g in grads.items()}}


def norm(x):
    return float(x.double().norm())


def grad_gap(prog, ref):
    """The worst leaf's gap between the gradients' norms, over the larger of
    the reference leaf's norm and the median leaf's."""
    g_ref = {k: norm(v) for k, v in ref.items()}
    g_med = float(torch.tensor(list(g_ref.values())).median())
    return common.worst(abs(norm(prog[k]) - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref), \
        g_ref, g_med


def numbers(prog, ref, prog_w=None, ref_w=None):
    """loss_rel: the worst step's |loss - reference| / reference, over the
    first steps and the window step; grad_rel: the worst leaf's gap between
    the norms of the gradients (`grad_gap`), of the first step's gradient as
    Adam holds it and of the window step's; change_rel: the same gap for the
    leaves' change over the first steps, over the leaves whose reference
    gradient is at least a thousandth of the median leaf's."""
    pairs = list(zip(prog["losses"], ref["losses"]))
    grad_rel, g_ref, g_med = grad_gap(prog["grad1"], ref["grad1"])
    if prog_w is not None:
        pairs.append((prog_w["loss"], ref_w["loss"]))
        grad_rel = common.worst([grad_rel, grad_gap(prog_w["grads"], ref_w["grads"])[0]])
    loss_rel = common.worst(abs(a - b) / abs(b) for a, b in pairs)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: norm(ref["pn"][k] - ref["p0"][k]) for k in moved}
    d_med = float(torch.tensor(list(d_ref.values())).median())
    change_rel = common.worst(abs(norm(prog["pn"][k] - prog["p0"][k]) - d_ref[k])
                              / max(d_ref[k], d_med) for k in moved)
    return {"loss_rel": loss_rel, "grad_rel": grad_rel, "change_rel": change_rel}


def check(st, cell, run):
    first, target = st["first"], st["target"]
    kept = st["trainer"].kept
    kept = {"seed": kept["seed"], "params": {k: v.cpu() for k, v in kept["params"].items()},
            "loss": float(kept["loss"]), "grads": {k: g.cpu() for k, g in kept["grads"].items()}}
    st.clear()
    if cell.device.startswith("cuda"):
        torch.cuda.empty_cache()
    return numbers(first, reference_first_steps(cell, target), kept,
                   reference_window_step(cell, kept, target))


def control(cell, fault=None):
    """The check's numbers with the reference in the program's place: in
    TF32 (fault None), or with half of the lanes left out ("half_batch":
    the gradient of the film of the frame's first half of lanes). The window
    step is the step after the first ones, from the float32 reference's
    leaves."""
    from benchmark.reference import path, precision

    target = make_target(cell)
    scene = common.reference_scene(cell)
    ref = reference_first_steps(cell, target)
    seed = common.frame_seed(cell.seed, int(cell.traffic["first_steps"]))
    params = {k: v.to(cell.device) for k, v in ref["pn"].items()}

    def window(**kw):
        loss, grads = path.loss_and_grads(scene, params, target, seed, **kw)
        return {"loss": float(loss), "grads": {k: g.cpu() for k, g in grads.items()}}

    ref_w = window()
    if fault == "half_batch":
        half = scene.width * scene.height * scene.spp // 2
        low, low_w = reference_first_steps(cell, target, lanes=half), window(lanes=half)
    else:
        with precision.tf32():
            low, low_w = reference_first_steps(cell, target), window()
    return numbers(low, ref, low_w, ref_w)

"""Piecewise-linear table evaluation.

`hat_eval` is the exact linear interpolation of a regularly sampled table at
a fractional index, clamped to the ends. `misaki_tpu` writes it as a sum of
hat (tent) basis functions because per-lane gathers are slow on its TPU
backend; on a GPU an indexed load is the natural form. Only the two bins
around the index carry weight, and they are weighted and summed in the same
order as the hat sum, so both forms give the same bits.
"""

import numpy as np
import torch

_CONSTS = {}


def const(array, device):
    """A static numpy table as a float32 tensor on `device` (cached). Made
    outside inference mode, so that a table first asked for by a frame under
    `torch.inference_mode` still serves a later render under autograd."""
    key = (id(array), str(device))
    hit = _CONSTS.get(key)
    if hit is None or hit[0] is not array:
        with torch.inference_mode(False):
            hit = (array, torch.as_tensor(np.asarray(array, np.float32), device=device))
        _CONSTS[key] = hit
    return hit[1]


def _as_table(tab, device):
    if isinstance(tab, torch.Tensor):
        return tab.to(device=device, dtype=torch.float32)
    return const(tab, device)


def hat_eval(values, t):
    """Sum_k values[k] * max(0, 1 - |t - k|): the piecewise-linear
    interpolation of `values` (N,) at fractional index `t` (any shape)."""
    return hat_eval_multi([values], t)[0]


def hat_eval_multi(tables, t):
    """hat_eval for several (N,) tables sharing the same index."""
    n = tables[0].shape[0]
    t = torch.clamp(t, 0.0, n - 1.0)
    i = torch.floor(t)
    w0 = torch.clamp(1.0 - torch.abs(t - i), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(t - (i + 1.0)), min=0.0)
    i0 = i.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    out = []
    for tab in tables:
        tab = _as_table(tab, t.device)
        # index_select, whose backward is an index_add_: advanced indexing's
        # accumulating index_put adds each bin's duplicates in turn
        a, b = (tab.index_select(0, i.reshape(-1)).view(i.shape) for i in (i0, i1))
        out.append(a * w0 + b * w1)
    return out


def sigmoid_inverse(v, eps=1e-4):
    """Map a reflectance value in [0,1] to the sigmoid-model constant c such
    that 0.5 c/sqrt(c^2+1) + 0.5 == v — used to encode `uniform` spectra as
    degenerate sigmoid coefficients (0, 0, c)."""
    v = np.clip(np.asarray(v, np.float64), eps, 1.0 - eps)
    return (v - 0.5) / np.sqrt(v * (1.0 - v))

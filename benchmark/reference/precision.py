"""The reference's matrix products, in float32 or, for the control, in TF32.

TF32 is how an H100's tensor cores multiply float32 matrices when a program
allows it: each input is rounded to 10 bits of mantissa (round to nearest
even), the products are exact and the sums float32. `matmul` computes that
itself, so the control does not depend on which cuBLAS kernel a shape gets.
"""

import contextlib

import torch

_state = {"tf32": False}


def tf32_round(x):
    """x (float32) rounded to TF32's 10 bits of mantissa, ties to even;
    inf and NaN kept."""
    i = x.contiguous().view(torch.int32)
    r = ((i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def _mm(a, b):
    """a @ b with float32 products and sums, TF32 off whatever the process
    allows."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


class _TF32MatMul(torch.autograd.Function):
    """a @ b in TF32, its backward's two products in TF32 too, as autograd
    would compute them on tensor cores."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return _mm(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = tf32_round(grad)
        grad_a = _mm(g, b.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        grad_b = None
        if ctx.needs_input_grad[1]:
            grad_b = _mm(a.reshape(-1, a.shape[-1]).T, g.reshape(-1, g.shape[-1]))
        return grad_a, grad_b


def matmul(a, b):
    """a @ b (b two-dimensional) with float32 products and sums; under
    `tf32()` in TF32, forward and backward."""
    if _state["tf32"]:
        return _TF32MatMul.apply(a, b)
    return _mm(a, b)


@contextlib.contextmanager
def tf32():
    """Every product of the reference in TF32 while the block runs: the
    control."""
    before = _state["tf32"]
    _state["tf32"] = True
    try:
        yield
    finally:
        _state["tf32"] = before

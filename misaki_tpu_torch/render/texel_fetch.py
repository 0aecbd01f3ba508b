"""Weighted 4-tap texel fetch: the counterpart of `misaki_tpu.render.paged_fetch`.

    out[c, l] = sum_{k=0..3} w4[k, l] * table[idx4[k, l], c]

Bilinear filtering is the four taps of one texel quad; bitmap textures and
the envmap emitter fetch through it. The table is texel-major RGB (N, 3),
read flat: no pages, no lane sort, no one-hot matmuls (those are how the TPU
kernel avoids a per-lane gather). A tap is live when w != 0 and
0 <= idx < N; a dead tap contributes exactly 0 and is never read.

On a CUDA tensor `fetch4` launches `csrc/texel_fetch.cu`; on a CPU tensor it
takes the plain twin `fetch4_plain`, the kernel's oracle. Both add the taps
in the order k = 0..3, each product rounded before the sum, so they agree
bit for bit.

The fetch is differentiable (`Fetch4`). Its backward scatters the output's
gradient into the table's,

    grad_table[idx4[k, l], c] += w4[k, l] * grad_out[c, l]   (live taps),

through `fetch4_backward`: on CUDA the kernels `fetch4_backward_kernel` and
`fetch4_backward_finalize_kernel` of the same source, on the CPU the plain
twin `fetch4_backward_plain`. Both round each product to float32. The twin
sums in float64 and rounds once. The kernel sums a warp's products per
texel in float64, and a block's, in a shared-memory table, for the texels
the block fetches more than once; each such partial, rounded to float32
once, goes into a float32 scratch with atomics, in an order that varies
from run to run: a texel takes a float32 addition per partial, not one per
tap. The JAX package has no backward kernel: its gradients take the
one-hot fetch (misaki_tpu/render/textures.py:49-72).
"""

import ctypes

import torch

from misaki_tpu_torch.utils import cuda_build, tracing

SRC = cuda_build.CSRC / "texel_fetch.cu"


def fetch4_plain(table, idx4, w4):
    """Plain PyTorch twin of the kernel. table (N, 3) float32; idx4 (4, L)
    int32; w4 (4, L) float32. Returns (3, L) float32."""
    n = table.shape[0]
    idx = idx4.to(torch.int64)
    live = (w4 != 0.0) & (idx >= 0) & (idx < n)
    safe = torch.where(live, idx, 0)
    acc = None
    for k in range(4):
        term = torch.where(live[k][None, :], table[safe[k]].T * w4[k][None, :], 0.0)
        acc = term if acc is None else acc + term
    return acc.contiguous()


def _live(idx4, w4, n):
    idx = idx4.to(torch.int64)
    return idx, (w4 != 0.0) & (idx >= 0) & (idx < n)


def fetch4_backward_plain(idx4, w4, grad_out, n):
    """Plain PyTorch twin of the backward kernel: the (n, 3) float32
    gradient of the table. Each live tap's product w4[k, l] * grad_out[c, l]
    is rounded to float32, the products are summed in float64 by
    `index_add_` in tap order k = 0..3, and the sums rounded to float32."""
    idx, live = _live(idx4, w4, n)
    grad = torch.zeros((n, 3), dtype=torch.float64, device=grad_out.device)
    for k in range(4):
        sel = live[k]
        grad.index_add_(0, idx[k][sel], (grad_out * w4[k][None, :]).T[sel].double())
    return grad.float()


def build():
    """Compile csrc/texel_fetch.cu with nvcc for sm_90a (once per source
    hash) and load it. Returns the ctypes library."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return cuda_build.load_library(SRC, {
        "fetch4_launch": ([p, i64, p, p, i64, p, p], i32),
        "fetch4_backward_launch": ([p, p, p, i64, i64, p, p], i32),
        "fetch4_backward_finalize_launch": ([p, i64, p, p], i32),
    })


def _check(tensors, dev):
    for name, x, dt in tensors:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no texel-fetch kernel for device {dev}")


def _check_taps(idx4, w4):
    if idx4.dim() != 2 or idx4.shape[0] != 4 or w4.shape != idx4.shape:
        raise ValueError(f"idx4 and w4 must both be (4, L), got {tuple(idx4.shape)} "
                         f"and {tuple(w4.shape)}")


def _fetch4(table, idx4, w4):
    """The forward: the plain twin on the CPU, the kernel on CUDA."""
    if table.device.type == "cpu":
        return fetch4_plain(table, idx4, w4)
    if table.data_ptr() % 16:
        raise ValueError("table must start on a 16-byte boundary (the kernel reads "
                         "bilinear rows as 16-byte spans)")
    L = idx4.shape[1]
    out = torch.empty((3, L), dtype=torch.float32, device=table.device)
    if L == 0:
        return out
    lib = build()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    cuda_build.check_launch(lib.fetch4_launch(
        table.data_ptr(), table.shape[0], idx4.data_ptr(), w4.data_ptr(), L, out.data_ptr(),
        stream), "texel-fetch kernel")
    tracing.launches["fetch"] += 1
    return out


def fetch4_backward(idx4, w4, grad_out, n):
    """The gradient of the (n, 3) table of a fetch at idx4 / w4 (4, L)
    whose output's gradient is grad_out (3, L) float32 -> (n, 3) float32.
    CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    dev = grad_out.device
    _check((("idx4", idx4, torch.int32), ("w4", w4, torch.float32),
            ("grad_out", grad_out, torch.float32)), dev)
    _check_taps(idx4, w4)
    if grad_out.shape != (3, idx4.shape[1]):
        raise ValueError(f"grad_out must be (3, L), got {tuple(grad_out.shape)}")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"the table must have 0 < N < 2^31 texels, got {n}")
    if dev.type == "cpu":
        return fetch4_backward_plain(idx4, w4, grad_out, n)
    if idx4.shape[1] == 0:
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)
    grad = backward_launch(build(), idx4, w4, grad_out, n)
    tracing.launches["fetch_bwd"] += 1
    return grad


def backward_launch(lib, idx4, w4, grad_out, n):
    """The backward kernel of the library `lib` (this source's, or another
    with its interface) on checked CUDA inputs with L > 0: the reduction
    into a zeroed (n, 4) float32 scratch, then the finalize into the (n, 3)
    gradient."""
    dev = grad_out.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    grad = torch.empty((n, 3), dtype=torch.float32, device=dev)
    cuda_build.check_launch(lib.fetch4_backward_launch(
        idx4.data_ptr(), w4.data_ptr(), grad_out.data_ptr(), idx4.shape[1], n,
        rows.data_ptr(), stream), "texel-fetch backward kernel")
    cuda_build.check_launch(lib.fetch4_backward_finalize_launch(
        rows.data_ptr(), n, grad.data_ptr(), stream), "texel-fetch backward finalize kernel")
    return grad


class Fetch4(torch.autograd.Function):
    """The fetch with its gradient: the table's through `fetch4_backward`,
    the weights' (where asked for) as sum_c grad_out[c, l] *
    table[idx4[k, l], c] over the live taps in plain PyTorch. The ids have
    none."""

    @staticmethod
    def forward(ctx, table, idx4, w4):
        ctx.save_for_backward(table, idx4, w4)
        return _fetch4(table, idx4, w4)

    @staticmethod
    def backward(ctx, grad_out):
        table, idx4, w4 = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        grad_table = grad_w4 = None
        if ctx.needs_input_grad[0]:
            grad_table = fetch4_backward(idx4, w4, grad_out, table.shape[0])
        if ctx.needs_input_grad[2]:
            idx, live = _live(idx4, w4, table.shape[0])
            texels = table[torch.where(live, idx, 0)]                     # (4, L, 3)
            grad_w4 = torch.where(live, (texels * grad_out.T[None]).sum(dim=2), 0.0)
        return grad_table, None, grad_w4


def fetch4(table, idx4, w4):
    """Weighted 4-tap fetch of the texel-major (N, 3) float32 `table` at
    idx4 (4, L) int32 with weights w4 (4, L) float32 -> (3, L) float32.
    CPU tensors take the plain twin; CUDA tensors launch the kernel. Where
    autograd records and the table or the weights require grad, the call
    goes through `Fetch4`; otherwise (under `inference_mode` or
    `no_grad`, or with constant inputs) straight to the forward."""
    _check((("table", table, torch.float32), ("idx4", idx4, torch.int32),
            ("w4", w4, torch.float32)), table.device)
    if table.dim() != 2 or table.shape[1] != 3 or not 0 < table.shape[0] < 2 ** 31:
        raise ValueError(f"table must be (N, 3) with 0 < N < 2^31, got {tuple(table.shape)}")
    _check_taps(idx4, w4)
    if torch.is_grad_enabled() and (table.requires_grad or w4.requires_grad):
        return Fetch4.apply(table, idx4, w4)
    return _fetch4(table, idx4, w4)

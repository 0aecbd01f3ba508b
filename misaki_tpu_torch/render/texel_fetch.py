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
"""

import ctypes

import torch

from misaki_tpu_torch.utils import cuda_build

SRC = cuda_build.CSRC / "texel_fetch.cu"

# Launch count of the CUDA kernel: `fetch4` adds one where it launches it,
# and nowhere else.
fetch_launches = 0


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


def build():
    """Compile csrc/texel_fetch.cu with nvcc for sm_90a (once per source
    hash) and load it. Returns the ctypes library."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return cuda_build.load_library(SRC, {
        "fetch4_launch": ([p, i64, p, p, i64, p, p], i32),
    })


def fetch4(table, idx4, w4):
    """Weighted 4-tap fetch of the texel-major (N, 3) float32 `table` at
    idx4 (4, L) int32 with weights w4 (4, L) float32 -> (3, L) float32.
    CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    global fetch_launches
    dev = table.device
    for name, x, dt in (("table", table, torch.float32), ("idx4", idx4, torch.int32),
                        ("w4", w4, torch.float32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, table on {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.dim() != 2 or table.shape[1] != 3 or not 0 < table.shape[0] < 2 ** 31:
        raise ValueError(f"table must be (N, 3) with 0 < N < 2^31, got {tuple(table.shape)}")
    if idx4.dim() != 2 or idx4.shape[0] != 4 or w4.shape != idx4.shape:
        raise ValueError(f"idx4 and w4 must both be (4, L), got {tuple(idx4.shape)} "
                         f"and {tuple(w4.shape)}")
    if dev.type == "cpu":
        return fetch4_plain(table, idx4, w4)
    if dev.type != "cuda":
        raise ValueError(f"no texel-fetch kernel for device {dev}")
    if table.data_ptr() % 16:
        raise ValueError("table must start on a 16-byte boundary (the kernel reads "
                         "bilinear rows as 16-byte spans)")
    L = idx4.shape[1]
    out = torch.empty((3, L), dtype=torch.float32, device=dev)
    if L == 0:
        return out
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check_launch(lib.fetch4_launch(
        table.data_ptr(), table.shape[0], idx4.data_ptr(), w4.data_ptr(), L, out.data_ptr(),
        stream), "texel-fetch kernel")
    fetch_launches += 1
    return out

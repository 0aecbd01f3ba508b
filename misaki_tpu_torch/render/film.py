"""Film accumulation and development
(reference: src/librender/imageblock.cpp, films/hdrfilm.cpp).

The film is a channel-major flat accumulator (C, H*W + 2*guard). The
wavefront is pixel-major (lane = pixel * spp + s), so a chunk covers a
contiguous pixel range: for each reconstruction-filter tap (ox, oy) the
chunk's per-pixel sums land at the flat offset oy*W + ox, and the splat is an
`index_add_` per tap. The indices of one `index_add_` are distinct and the
taps run one after another, so on CUDA too, where the adds are atomic, each
film texel sums its terms in one fixed order: the film is the same to the
bit from run to run, which a resumed render relies on.
"""

import struct

import numpy as np
import torch

from misaki_tpu_torch.core import spectrum as spec


def filter_footprint(filter_type, stddev):
    """Footprint half-width in pixels."""
    if filter_type == "box":
        return 0, 0.5
    radius = 4.0 * stddev  # gaussian.cpp: m_radius = 4 * stddev
    return int(np.ceil(radius)), radius


def pad_rows(W, filter_type, stddev):
    pad, _ = filter_footprint(filter_type, stddev)
    return (pad + 1) * W + pad + 1


def new_film_flat(H, W, channels=5, filter_type="gaussian", stddev=0.5, device="cpu"):
    guard = pad_rows(W, filter_type, stddev)
    return torch.zeros((channels, H * W + 2 * guard), dtype=torch.float32, device=device)


def splat_aligned(film_flat, pixel0, pos, values, W, H, spp,
                  filter_type="gaussian", stddev=0.5):
    """Accumulate an spp-aligned, pixel-major chunk into the flat film, in
    place. pixel0: first flat pixel id (int); pos: (px, py) tuple of (L,);
    values: tuple of C (L,) channel tensors; L = n_pix * spp. Pixels past
    the image (the last chunk's tail) must carry zero values."""
    C = len(values)
    L = values[0].shape[0]
    n_pix = L // spp
    dev = film_flat.device
    guard = pad_rows(W, filter_type, stddev)
    pad, radius = filter_footprint(filter_type, stddev)

    pix = pixel0 + torch.arange(n_pix, dtype=torch.int64, device=dev)
    px0 = (pix % W).to(torch.float32)
    py0 = (pix // W).to(torch.float32)

    v = torch.stack(values, 0).reshape(C, n_pix, spp)
    # jitter relative to the pixel corner, in discrete coords (-0.5-centered)
    jx = pos[0].reshape(n_pix, spp) - px0[:, None] - 0.5
    jy = pos[1].reshape(n_pix, spp) - py0[:, None] - 0.5

    if filter_type == "box":
        taps = [(0, 0)]

        def wfun(o, j):
            return torch.ones_like(j)
    else:
        alpha = -1.0 / (2.0 * stddev * stddev)
        bias = float(np.exp(alpha * radius * radius))
        taps = [(ox, oy) for oy in range(-pad, pad + 1) for ox in range(-pad, pad + 1)]

        def wfun(o, j):
            return torch.clamp(torch.exp(alpha * (o - j) ** 2) - bias, min=0.0)

    offs = sorted({o for t in taps for o in t})
    wx_all = {o: wfun(o, jx) for o in offs}  # (n_pix, spp)
    wy_all = {o: wfun(o, jy) for o in offs}
    in_x = {o: ((px0 + o >= 0) & (px0 + o < W)).to(torch.float32) for o in offs}
    in_y = {o: ((py0 + o >= 0) & (py0 + o < H)).to(torch.float32) for o in offs}

    # the last chunk may run past the image: its tail pixels (zero values)
    # are dropped so no index leaves the guarded film
    keep = pix < H * W
    for ox, oy in taps:
        w = wx_all[ox] * wy_all[oy] * (in_x[ox] * in_y[oy])[:, None]
        contrib = torch.sum(w[None, :, :] * v, dim=2)  # (C, n_pix)
        idx = guard + pix + (oy * W + ox)
        film_flat.index_add_(1, idx[keep], contrib[:, keep])
    return film_flat


def film_from_flat(film_flat, H, W, filter_type="gaussian", stddev=0.5):
    """(C, flat) accumulator -> (H, W, C) image-layout film."""
    guard = pad_rows(W, filter_type, stddev)
    C = film_flat.shape[0]
    return film_flat[:, guard: guard + H * W].movedim(0, -1).reshape(H, W, C)


def develop(film):
    """XYZAW (H, W, 5) -> linear sRGB + alpha (hdrfilm.cpp:44-88)."""
    xyz = film[..., 0:3]
    alpha = film[..., 3]
    weight = film[..., 4]
    # the inner where keeps 1 / 0 out of the gradient of unweighted pixels
    has_w = weight != 0.0
    inv_w = torch.where(has_w, 1.0 / torch.where(has_w, weight, 1.0), 0.0)
    rgb = spec.xyz_to_srgb_image(xyz) * inv_w[..., None]
    return rgb, alpha * inv_w


def to_srgb8(rgb):
    """Linear -> sRGB gamma, 8-bit (bitmap.cpp tonemap for PNG output)."""
    if isinstance(rgb, torch.Tensor):
        rgb = rgb.detach().cpu().numpy()
    rgb = np.clip(np.asarray(rgb), 0.0, 1.0)
    srgb = np.where(rgb <= 0.0031308, 12.92 * rgb, 1.055 * rgb ** (1 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).astype(np.uint8)


EXR_MAGIC = 20000630   # little-endian: the bytes 76 2f 31 01 that open an OpenEXR file


def _exr_attr(name, type_name, payload):
    return (name.encode() + b"\0" + type_name.encode() + b"\0"
            + struct.pack("<i", len(payload)) + payload)


def write_exr(path, rgb, alpha=None):
    """The developed image as a float32 OpenEXR file (the port's counterpart
    of misaki_tpu's imageio write, film.py:137-146): one part, scan lines,
    no compression, FLOAT channels R, G, B and, where given, A; a (H, W)
    image is written as the one channel Y. Channels are stored sorted by
    name, as the format asks. rgb: (H, W, 3) or (H, W); alpha: (H, W)."""
    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float32)

    img = host(rgb)
    planes = {"Y": img} if img.ndim == 2 else {"R": img[..., 0], "G": img[..., 1],
                                               "B": img[..., 2]}
    if alpha is not None:
        planes["A"] = host(alpha)
    names = sorted(planes)
    H, W = img.shape[:2]
    chlist = b"".join(n.encode() + b"\0" + struct.pack("<i4xii", 2, 1, 1) for n in names)
    window = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header = (struct.pack("<ii", EXR_MAGIC, 2)
              + _exr_attr("channels", "chlist", chlist + b"\0")
              + _exr_attr("compression", "compression", b"\0")
              + _exr_attr("dataWindow", "box2i", window)
              + _exr_attr("displayWindow", "box2i", window)
              + _exr_attr("lineOrder", "lineOrder", b"\0")
              + _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _exr_attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
              + _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    # per scan line: y, byte count, then each channel's W values in turn
    rows = np.stack([planes[n] for n in names], axis=1).astype("<f4")   # (H, C, W)
    line_bytes = rows.shape[1] * W * 4
    first = len(header) + 8 * H
    offsets = first + np.arange(H, dtype=np.int64) * (8 + line_bytes)
    with open(path, "wb") as f:
        f.write(header)
        f.write(offsets.astype("<u8").tobytes())
        for y in range(H):
            f.write(struct.pack("<ii", y, line_bytes))
            f.write(rows[y].tobytes())


def write_png(path, rgb):
    from PIL import Image

    Image.fromarray(to_srgb8(rgb)).save(str(path))

"""The texel-fetch kernel on the card: the cells of the envlit scene and the
split of a launch into its parts.

    python -m misaki_tpu_torch.tools.profile_texel_fetch [--reps N] [--out FILE]

Cells, 2^20 lanes each, on the envlit scene at full size (a 2048x4096 RGB
envmap, a 1024^2 bitmap with its mip chain):

  * env_random: bilinear taps at uniform random (u, v) of the envmap;
  * bitmap_camera_mips: a 1024^2 raster over the floor's bitmap, its
    footprint growing down the rows so that every mip level is fetched;
  * env_nee: the envmap taps of the emitter's own importance sampler
    (`_env_sample_dir` on uniform samples), the frame's NEE fetches;
  * split_dead: env_random's ids with every weight 0 (nothing is read but
    the taps and the output: the stream floor);
  * split_hot: env_random's weights with every id 0 (the stream and one
    line of texels);
  * split_l2: env_random's taps modulo a 4 MB table (the same pattern with
    the table held in L2).

Every launch is held against the plain twin (`fetch4_plain`) to the bit.
Times are device times (`profile_cluster_frame.device_ms`: CUDA events over
`--reps` launches enqueued while a device sleep holds the stream, so the
host's launch cost is not in them). Each cell gives its bound (bytes: ids,
weights and output once, each distinct live texel's 12 B once, over
3.35 TB/s), its `sector_bytes` (the distinct 32-byte sectors of the table
that live taps touch, times 32, plus the streamed ids, weights and output),
the plain twin's time and the library call `F.embedding_bag`'s time (never
used by the port). The table goes to `--out` (default
`chiprun_out/profile_texel_fetch.md`).
"""

import argparse
from pathlib import Path

import torch
import torch.nn.functional as F

from misaki_tpu_torch.render import texel_fetch as tf
from misaki_tpu_torch.tools.profile_cluster_frame import (HBM_BYTES_PER_S, bound_ms, device_ms,
                                                          smi_line)

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "chiprun_out" / "profile_texel_fetch.md"
SCENE_BUILD = ROOT / "build" / "scenes" / "envlit"
N_LANES = 1 << 20
L2_TABLE_BYTES = 4 << 20
STREAM_BYTES = 16 + 16 + 12     # ids, weights and output of one lane
CELLS = ("env_random", "bitmap_camera_mips", "env_nee", "split_dead", "split_hot", "split_l2")


def live_taps(table, idx4, w4):
    n = table.shape[0]
    return (w4 != 0.0) & (idx4 >= 0) & (idx4 < n)


def fetch_bound(table, idx4, w4):
    """The bound of one launch: ids, weights and output once, the 12 B of
    each distinct live texel once; 8 FP32 operations per channel and lane.
    Returns (ms, "bytes" or "operations", distinct live texels)."""
    L = idx4.shape[1]
    texels = int(torch.unique(idx4[live_taps(table, idx4, w4)]).numel())
    ms, by = bound_ms(L * STREAM_BYTES + texels * 12, L * 8 * 3)
    return ms, by, texels


def sector_bytes(table, idx4, w4):
    """The distinct 32-byte sectors of the (N, 3) table that the live taps'
    12 RGB bytes touch, times 32, plus the streamed ids, weights and
    output."""
    ids = idx4[live_taps(table, idx4, w4)].to(torch.int64)
    first = ids * 12 // 32
    last = (ids * 12 + 11) // 32
    sectors = int(torch.unique(torch.cat([first, last])).numel())
    return sectors * 32 + idx4.shape[1] * STREAM_BYTES


def make_cells(scene, n=N_LANES, seed=0):
    """{cell: (table (N, 3), idx4, w4)} on the scene's device (see the
    module's docstring)."""
    from misaki_tpu_torch.emitter import kernels as em
    from misaki_tpu_torch.render import textures as ptex

    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    env = scene.emitters.env_rgb.reshape(-1, 3)
    u, v = (torch.rand(n, device=dev, generator=gen) for _ in range(2))
    idx, w = em.env_taps(scene, u, v)
    cells = {"env_random": (env, idx, w)}
    # a raster over the floor's texture (repeated twice, as the floor's uv
    # transform does), its footprint growing down the rows from one texel to
    # the whole texture: every mip level in bands of rows
    side = int(n ** 0.5)
    ij = torch.arange(n, device=dev)
    x, y = (ij % side).float(), (ij // side).float()
    W0, _, levels = scene.bitmap_meta[0]
    fp = torch.exp2(y / side * len(levels)) / W0
    zero = torch.zeros_like(fp)
    cells["bitmap_camera_mips"] = (scene.bitmaps, *ptex.bitmap_taps(
        scene, 0, (x + 0.5) / side * 2.0, (y + 0.5) / side * 2.0, ((fp, zero), (zero, zero))))
    u2 = tuple(torch.rand(n, device=dev, generator=gen) for _ in range(2))
    _, _, nu, nv = em._env_sample_dir(scene, u2)
    cells["env_nee"] = (env, *em.env_taps(scene, nu, nv))
    cells["split_dead"] = (env, idx, torch.zeros_like(w))
    cells["split_hot"] = (env, torch.zeros_like(idx), w)
    small = L2_TABLE_BYTES // 12
    cells["split_l2"] = (env[:small], torch.remainder(idx, small).contiguous(), w)
    return cells


def embedding_bag_call(table, idx4, w4):
    """F.embedding_bag computing the same sums over the live taps (a dead
    tap: weight 0 on a clamped id); may add in another order."""
    n = table.shape[0]
    ids = idx4.T.clamp(0, n - 1).long().contiguous()
    w = torch.where(live_taps(table, idx4, w4), w4, 0.0).T.contiguous()
    return ids, w, lambda: F.embedding_bag(ids, table, per_sample_weights=w, mode="sum")


def profile(scene=None, reps=30, out=DEFAULT_OUT):
    """Profile the texel-fetch kernel on the cells of `scene` (default: the
    envlit scene at full size on cuda). Returns a dict with, per cell, its
    size, bound, sector bytes, the kernel's time, whether it equals the twin
    and its largest difference, the plain twin's and embedding_bag's times;
    whether every launch equals the twin; the card; the table's path."""
    if not torch.cuda.is_available():
        raise RuntimeError("the texel-fetch profile needs a CUDA device")
    if scene is None:
        from misaki_tpu_torch.scene.compiler import load_and_compile
        from misaki_tpu_torch.scenes.envlit import assets

        scene = load_and_compile(str(assets.prepared(SCENE_BUILD)), device="cuda")
    cells = make_cells(scene)
    res = {"cells": {}, "equal": True}
    for name in CELLS:
        table, idx4, w4 = cells[name]
        want = tf.fetch4_plain(table, idx4, w4)
        got = tf.fetch4(table, idx4, w4)
        same = bool(torch.equal(got, want))
        bms, by, texels = fetch_bound(table, idx4, w4)
        ids, w, lib_call = embedding_bag_call(table, idx4, w4)
        lib_err = ((lib_call() - want.T).abs()
                   / (w.abs()[:, :, None] * table[ids].abs()).sum(1).clamp(min=1e-30)
                   ).max().item()
        res["cells"][name] = {
            "lanes": idx4.shape[1], "texels": table.shape[0],
            "live_taps": live_taps(table, idx4, w4).float().mean().item(),
            "distinct_live_texels": texels, "bound_ms": bms, "bound_by": by,
            "sector_bytes": sector_bytes(table, idx4, w4),
            "ms": device_ms(lambda: tf.fetch4(table, idx4, w4), reps), "equal": same,
            "max_abs_err": (got - want).abs().max().item(),
            "plain_ms": device_ms(lambda: tf.fetch4_plain(table, idx4, w4), 5),
            "embedding_bag_ms": device_ms(lib_call, reps), "embedding_bag_rel_err": lib_err}
        res["equal"] &= same
    res["card"] = f"{torch.cuda.get_device_name(0)} ({smi_line()})"
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(report(res, reps))
    res["table"] = str(out)
    return res


def report(res, reps):
    lines = [
        "# Texel-fetch profile",
        "",
        f"Card: {res['card']}; torch {torch.__version__}, CUDA {torch.version.cuda}.",
        f"Device ms per launch (CUDA events over {reps} launches enqueued behind a held "
        "stream), 2^20 lanes per cell; every launch equal to the plain twin: "
        f"{res['equal']}.",
        "",
        "| cell | texels | live taps | distinct live texels | kernel ms | bound ms | share of "
        "bound | sector bytes | sector floor ms | plain ms | embedding_bag ms |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for name, c in res["cells"].items():
        lines.append(
            f"| {name} | {c['texels']} | {c['live_taps']:.4f} | {c['distinct_live_texels']} | "
            f"{c['ms']:.4f}{'' if c['equal'] else ' DIFFERS'} | {c['bound_ms']:.4f} "
            f"({c['bound_by']}) | {c['bound_ms'] / c['ms']:.3f} | {c['sector_bytes']} | "
            f"{c['sector_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} | {c['plain_ms']:.4f} | "
            f"{c['embedding_bag_ms']:.4f} |")
    return "\n".join(lines) + "\n"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args()
    res = profile(reps=args.reps, out=args.out)
    print(Path(res["table"]).read_text(), end="")
    if not res["equal"]:
        raise SystemExit("a texel-fetch launch differs from the plain twin")


if __name__ == "__main__":
    main()

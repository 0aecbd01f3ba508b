"""The texel-fetch kernel on the card: the cells of the envlit scene and the
split of a launch into its parts.

    python -m misaki_tpu_torch.tools.profile_texel_fetch [--reps N] [--out FILE]
    python -m misaki_tpu_torch.tools.profile_texel_fetch --backward [--compare SRC ...]

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

`backward_case` does the same for the fetch's backward kernel on one set of
taps (`profile_backward`: the first three cells): allclose to its
`index_add_` twin in each of `checks` calls (atomics add in an order that
varies from run to run), its time beside the twin's, the library call
`index_add_`'s and that of its scratch (`finalize_ms`: the call's time
less that of its reduction kernel alone: the scratch's zeroing and the
finalize), and its bound. `--backward` times the backward kernel on those
cells and on the taps of one envlit gradient (`gradient_taps`), beside each
`--compare` source's (`profile_backward_versions`), into
`chiprun_out/profile_texel_fetch_backward.md`; `--spread N` adds the share
of the tolerance that the port uses in each of N calls on each cell
(`tolerance_spread`), its quantiles in the same file.
"""

import argparse
import contextlib
import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from misaki_tpu_torch.render import texel_fetch as tf
from misaki_tpu_torch.tools.profile_cluster_frame import (HBM_BYTES_PER_S, bound_ms, device_ms,
                                                          smi_line)
from misaki_tpu_torch.utils import cuda_build

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "chiprun_out" / "profile_texel_fetch.md"
BACKWARD_OUT = ROOT / "chiprun_out" / "profile_texel_fetch_backward.md"
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


BACKWARD_CELLS = ("env_random", "bitmap_camera_mips", "env_nee")
CHECKS = 10     # calls of the backward kernel held to its twin per set of taps


def index_add_call(idx4, w4, grad_out, n):
    """The library call computing the backward's sums: one `index_add_` of
    every tap's w * grad_out (a dead tap: weight 0 on a clamped id) into a
    zeroed (n, 3) table; may add in another order. Never used by the port."""
    live = (w4 != 0.0) & (idx4 >= 0) & (idx4 < n)
    ids = idx4.clamp(0, n - 1).long().reshape(-1)
    vals = (torch.where(live, w4, 0.0)[:, None, :] * grad_out[None]).permute(0, 2, 1)
    vals = vals.reshape(-1, 3).contiguous()
    return lambda: torch.zeros((n, 3), device=grad_out.device).index_add_(0, ids, vals)


def backward_bound(idx4, w4, n):
    """The bound of one backward launch: (ms, "bytes" or "operations") with
    ids, weights and grad_out read once (44 B a lane) and the (n, 3)
    gradient written once (12 B a texel), 24 FP32 operations a lane; and,
    beside it, the read-modify-write count of the atomics (44 B a lane and
    24 B per distinct live texel) in ms; and the distinct live texels."""
    L = idx4.shape[1]
    texels = int(torch.unique(idx4[(w4 != 0.0) & (idx4 >= 0) & (idx4 < n)]).numel())
    ms, by = bound_ms(L * STREAM_BYTES + n * 12, L * 24)
    return ms, by, (L * STREAM_BYTES + texels * 24) / HBM_BYTES_PER_S * 1e3, texels


def reduce_call(idx4, w4, grad_out, n):
    """The backward's reduction kernel alone (no finalize), adding into a
    scratch of its own again and again: the kernel's time without the
    finalize."""
    lib = tf.build()
    rows = torch.zeros((n, 4), device=grad_out.device)

    def run():
        cuda_build.check_launch(lib.fetch4_backward_launch(
            idx4.data_ptr(), w4.data_ptr(), grad_out.data_ptr(), idx4.shape[1], n,
            rows.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "texel-fetch backward kernel")

    return run


def backward_case(idx4, w4, grad_out, n, reps=30, launch=None, checks=None, want=None):
    """The backward kernel (`fetch4_backward`, or `launch` with its
    arguments) on one set of taps: against its plain twin (`want`, if
    given) with allclose(rtol 1e-5, atol 1e-6 of the twin's largest
    magnitude) in each of `checks` (default CHECKS) calls (atomics add in
    another order from run to run; `tolerance_used`: the largest |error| /
    (atol + rtol |want|) of those calls, at most 1 where allclose), its time
    and its bound; for the port's kernel also the
    twin's, `index_add_`'s and the finalize's (`finalize_ms`: the call's time
    less its reduction kernel's alone). Returns the numbers."""
    port = launch is None
    launch = launch or tf.fetch4_backward
    checks = checks or CHECKS
    if want is None:
        want = tf.fetch4_backward_plain(idx4, w4, grad_out, n)
    scale = want.abs().max().item()
    tol = 1e-6 * scale + 1e-5 * want.abs()
    ok, err, used = True, 0.0, 0.0
    for _ in range(checks):
        got = launch(idx4, w4, grad_out, n)
        ok &= bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6 * scale))
        err = max(err, (got - want).abs().max().item())
        used = max(used, ((got - want).abs() / tol).max().item())
    del got, tol
    bms, by, rmw_ms, texels = backward_bound(idx4, w4, n)
    res = {"lanes": idx4.shape[1], "texels": n, "distinct_live_texels": texels,
           "allclose": ok, "checks": checks, "max_abs_err": err, "scale": scale,
           "tolerance_used": used,
           "ms": device_ms(lambda: launch(idx4, w4, grad_out, n), reps),
           "bound_ms": bms, "bound_by": by, "rmw_bound_ms": rmw_ms}
    if port:
        lib = index_add_call(idx4, w4, grad_out, n)
        res.update({
            "plain_ms": device_ms(lambda: tf.fetch4_backward_plain(idx4, w4, grad_out, n), 5),
            "index_add_ms": device_ms(lib, reps),
            "index_add_allclose": bool(torch.allclose(lib(), want, rtol=1e-5,
                                                      atol=1e-6 * scale)),
            "finalize_ms": res["ms"] - device_ms(reduce_call(idx4, w4, grad_out, n), reps)})
    return res


def backward_cells(scene, seed=1):
    """{cell: (idx4, w4, grad_out, n)} for the cells BACKWARD_CELLS of
    `scene` at 2^20 lanes, grad_out drawn from a seeded generator."""
    cells = make_cells(scene)
    gen = torch.Generator(device=scene.device).manual_seed(seed)
    res = {}
    for name in BACKWARD_CELLS:
        table, idx4, w4 = cells[name]
        grad_out = torch.randn((3, idx4.shape[1]), device=scene.device, generator=gen)
        res[name] = (idx4, w4, grad_out, table.shape[0])
    return res


def profile_backward(scene, reps=30, seed=1, launch=None):
    """`backward_case` on `backward_cells(scene, seed)`. Returns {cell:
    numbers}."""
    return {name: backward_case(*case, reps=reps, launch=launch)
            for name, case in backward_cells(scene, seed).items()}


def tolerance_spread(scene, calls, seed=1):
    """The share of the twin's tolerance (largest |error| / (atol + rtol
    |want|), at most 1 where allclose) that the port's backward uses in each
    of `calls` calls on each of `backward_cells(scene, seed)`: atomics add in
    an order that varies from call to call. Returns {cell: sorted list}."""
    res = {}
    for name, (idx4, w4, grad_out, n) in backward_cells(scene, seed).items():
        want = tf.fetch4_backward_plain(idx4, w4, grad_out, n)
        tol = 1e-6 * want.abs().max() + 1e-5 * want.abs()
        res[name] = sorted(((tf.fetch4_backward(idx4, w4, grad_out, n) - want).abs() / tol)
                           .max().item() for _ in range(calls))
    return res


@contextlib.contextmanager
def captured_backward():
    """Inside it, every `fetch4_backward` call (Fetch4's backward) runs as
    before and appends its (idx4, w4, grad_out, n) to the yielded list."""
    taps, real = [], tf.fetch4_backward

    def spy(idx4, w4, grad_out, n):
        taps.append((idx4, w4, grad_out, n))
        return real(idx4, w4, grad_out, n)

    tf.fetch4_backward = spy
    try:
        yield taps
    finally:
        tf.fetch4_backward = real


def gradient_taps(scene, names=("bitmaps", "env_rgb"), seed=0, depth_cap=4):
    """The (idx4, w4, grad_out, n) of every backward launch of one
    `image_grads` of the image mean over `names`: the shapes and the data
    that a gradient step gives the kernel."""
    from misaki_tpu_torch.diff.backprop import image_grads

    with captured_backward() as taps:
        image_grads(scene, names, lambda rgb: rgb.mean(), seed=seed, depth_cap=depth_cap)
    return taps


def profile_gradient_taps(taps, reps=10, launch=None, wants=None):
    """`backward_case` on each captured launch of `gradient_taps` (`wants`:
    their twins' gradients, if computed), and their sum: {"launches":
    [numbers], "allclose", "max_abs_err", "bound_by" (the largest bound's),
    and the sums over the launches of each time and bound}."""
    wants = wants or [None] * len(taps)
    each = [backward_case(*t, reps=reps, launch=launch, want=w) for t, w in zip(taps, wants)]
    total = {k: sum(c[k] for c in each)
             for k in ("ms", "plain_ms", "index_add_ms", "finalize_ms", "bound_ms",
                       "rmw_bound_ms") if k in each[0]}
    return {"launches": each, "allclose": all(c["allclose"] for c in each),
            "max_abs_err": max(c["max_abs_err"] for c in each),
            "tolerance_used": max(c["tolerance_used"] for c in each),
            "bound_by": max(each, key=lambda c: c["bound_ms"])["bound_by"], **total}


def source_backward(src):
    """`fetch4_backward` through the `fetch4_backward_launch` of another
    texel-fetch source, for comparing two versions of the kernel in one
    process: a source with this one's interface (it has
    `fetch4_backward_finalize_launch`) or with the previous kernel's (a
    float64 (n, 3) scratch, rounded here)."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = cuda_build.load_library(src, {"fetch4_backward_launch": ([p, p, p, i64, i64, p, p],
                                                                   i32)})
    if hasattr(lib, "fetch4_backward_finalize_launch"):
        lib.fetch4_backward_finalize_launch.argtypes = [p, i64, p, p]
        lib.fetch4_backward_finalize_launch.restype = i32
        return lambda idx4, w4, grad_out, n: tf.backward_launch(lib, idx4, w4, grad_out, n)

    def launch(idx4, w4, grad_out, n):
        grad = torch.zeros((n, 3), dtype=torch.float64, device=grad_out.device)
        cuda_build.check_launch(lib.fetch4_backward_launch(
            idx4.data_ptr(), w4.data_ptr(), grad_out.data_ptr(), idx4.shape[1], n,
            grad.data_ptr(), torch.cuda.current_stream().cuda_stream), str(src))
        return grad.float()

    return launch


def profile(scene=None, reps=30, out=DEFAULT_OUT):
    """Profile the texel-fetch kernel on the cells of `scene` (default: the
    envlit scene at full size on cuda). Returns a dict with, per cell, its
    size, bound, sector bytes, the kernel's time, whether it equals the twin
    and its largest difference, the plain twin's and embedding_bag's times;
    whether every launch equals the twin; the card; the table's path."""
    if not torch.cuda.is_available():
        raise RuntimeError("the texel-fetch profile needs a CUDA device")
    if scene is None:
        scene = _envlit()
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


def _envlit(**kw):
    from misaki_tpu_torch.scene.compiler import load_and_compile
    from misaki_tpu_torch.scenes.envlit import assets

    return load_and_compile(str(assets.prepared(SCENE_BUILD)), device="cuda", **kw)


def profile_backward_versions(compare=(), reps=30, out=BACKWARD_OUT, spread=0):
    """The backward kernel of the port and the `fetch4_backward_launch` of
    each `compare` source, in one process, on the BACKWARD_CELLS and on the
    taps of one envlit gradient at its declared 256x256 x 64 spp (depth cap
    4: a launch of 2^22 lanes per fetch of the frame), in the order port,
    compare..., then the reverse; each held to its twin in CHECKS calls per
    set of taps. With `spread` > 0, also `tolerance_spread` over that many
    calls. Writes a table to `out`; returns {"runs": [(version, cells,
    gradient)], "spread": {cell: sorted list}, "card", "table"}."""
    if not torch.cuda.is_available():
        raise RuntimeError("the texel-fetch profile needs a CUDA device")
    compare = [Path(c) for c in compare]
    cuda_build.compile_sources(list(dict.fromkeys([tf.SRC, *compare])))
    scene = _envlit()
    taps = gradient_taps(scene)
    wants = [tf.fetch4_backward_plain(*t) for t in taps]
    launches = {"port": None, **{str(c): source_backward(c) for c in compare}}
    order = list(launches) + list(reversed(launches))
    runs = [(v, profile_backward(scene, reps, launch=launches[v]),
             profile_gradient_taps(taps, max(reps // 3, 5), launches[v], wants)) for v in order]
    card = f"{torch.cuda.get_device_name(0)} ({smi_line()})"
    lines = [
        "# Texel-fetch backward profile", "",
        f"Card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}.",
        "Device ms (CUDA events over launches enqueued behind a held stream), each "
        "including the wrapper's scratch (finalize, zeroing or rounding); cells of 2^20 "
        f"lanes, and the {len(taps)} launches of one envlit gradient (sums over them); "
        f"allclose to the twin in each of {CHECKS} calls per set of taps (tolerance used: "
        "the largest |error| / (atol + rtol |want|) of those calls). The port's rows "
        "also give its finalize (the call less its reduction kernel alone), the plain twin "
        "and `index_add_`. Share of bound: bound ms / kernel ms.", "",
        "| version | taps | lanes | distinct live texels | allclose | max abs err | tolerance "
        "used | kernel ms | bound ms | share of bound | finalize ms | plain ms | index_add_ ms |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]

    def row(v, name, c, lanes, texels):
        extra = " | ".join(f"{c[k]:.4f}" if k in c else "" for k in
                           ("finalize_ms", "plain_ms", "index_add_ms"))
        return (f"| {v} | {name} | {lanes} | {texels} | {c['allclose']} | "
                f"{c['max_abs_err']:.3e} | {c['tolerance_used']:.3f} | {c['ms']:.4f} | "
                f"{c['bound_ms']:.4f} | "
                f"{c['bound_ms'] / c['ms']:.3f} | {extra} |")

    for v, cells, grad in runs:
        for name, c in cells.items():
            lines.append(row(v, name, c, c["lanes"], c["distinct_live_texels"]))
        for k, c in enumerate(grad["launches"]):
            lines.append(row(v, f"gradient launch {k}", c, c["lanes"],
                             c["distinct_live_texels"]))
        lines.append(row(v, f"envlit gradient, {len(grad['launches'])} launches", grad,
                         sum(c["lanes"] for c in grad["launches"]),
                         sum(c["distinct_live_texels"] for c in grad["launches"])))
    spreads = tolerance_spread(scene, spread) if spread > 0 else {}
    if spreads:
        qs = (0.0, 0.5, 0.9, 0.99, 0.999, 1.0)
        lines += ["", f"Share of the tolerance the port uses, over {spread} calls per cell "
                  "(quantiles):", "",
                  "| cell | " + " | ".join(f"q{q:g}" for q in qs) + " | calls over 0.8 |",
                  "|---|" + "---|" * (len(qs) + 1)]
        for name, used in spreads.items():
            at = [used[min(int(q * len(used)), len(used) - 1)] for q in qs]
            lines.append(f"| {name} | " + " | ".join(f"{u:.4f}" for u in at)
                         + f" | {sum(u > 0.8 for u in used)} |")
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    return {"runs": runs, "spread": spreads, "card": card, "table": str(out)}


def main():
    global CHECKS
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=None)
    ap.add_argument("--backward", action="store_true",
                    help="profile the backward kernel (profile_backward_versions)")
    ap.add_argument("--compare", action="append", default=[],
                    help="with --backward: another texel-fetch source whose "
                         "fetch4_backward_launch is timed on the same taps")
    ap.add_argument("--checks", type=int, default=CHECKS,
                    help="with --backward: calls held to the twin per set of taps")
    ap.add_argument("--spread", type=int, default=0,
                    help="with --backward: calls per cell for the spread of the share "
                         "of the tolerance used (tolerance_spread)")
    args = ap.parse_args()
    CHECKS = args.checks
    if args.backward:
        res = profile_backward_versions(args.compare, args.reps, args.out or BACKWARD_OUT,
                                        args.spread)
        print(Path(res["table"]).read_text(), end="")
        if not all(cells[c]["allclose"] for _, cells, _ in res["runs"] for c in cells) or \
                not all(grad["allclose"] for _, _, grad in res["runs"]) or \
                any(u > 1.0 for used in res["spread"].values() for u in used):
            raise SystemExit("a texel-fetch backward launch differs from the plain twin")
        return
    res = profile(reps=args.reps, out=args.out or DEFAULT_OUT)
    print(Path(res["table"]).read_text(), end="")
    if not res["equal"]:
        raise SystemExit("a texel-fetch launch differs from the plain twin")


if __name__ == "__main__":
    main()

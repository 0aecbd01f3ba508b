"""The levers tried on the texel-fetch kernel, each timed on the cells of
`profile_texel_fetch`.

    python -m misaki_tpu_torch.tools.profile_texel_fetch_levers
        [--compare SRC ...] [--reps N] [--out FILE]

`texel_fetch_levers.cu`, beside this file, is the kernel of
`csrc/texel_fetch.cu` with each lever of its design on or off: the stream
evict-first, the texels evict-last, bilinear rows read as 16-byte spans,
two lanes per thread, and an (N, 4) copy of the table (one 16-byte load per
tap). The render path never builds it; the port launches the set this tool
measured best. Beside the variants the tool times the port's `fetch4` and
each `--compare` source: a texel-fetch source with the port's
`fetch4_launch` interface, such as an earlier commit's `csrc/texel_fetch.cu`.

Every variant is held against the plain twin (`fetch4_plain`) to the bit,
then timed with `profile_cluster_frame.device_ms` twice: all variants in
order, then in reverse. Texel loads with an evict-last hint leave their
lines pinned in L2 for the kernels that follow, so the persisting lines are
reset (`cuCtxResetPersistingL2Cache`) before every check and every timing.
The table of ms per launch goes to `--out` (default
`chiprun_out/profile_texel_fetch_levers.md`).
"""

import argparse
import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from misaki_tpu_torch.render import texel_fetch as tf
from misaki_tpu_torch.tools import profile_texel_fetch as ptf
from misaki_tpu_torch.tools.profile_cluster_frame import device_ms, smi_line
from misaki_tpu_torch.utils import cuda_build

SRC = Path(__file__).resolve().parent / "texel_fetch_levers.cu"
DEFAULT_OUT = ptf.ROOT / "chiprun_out" / "profile_texel_fetch_levers.md"
CELLS = ("env_random", "bitmap_camera_mips", "env_nee", "split_dead", "split_l2")
# lever flags of texel_fetch_levers.cu
EF, EL, SPANS, TWO_LANES = 1, 2, 4, 8
# (label, table row pitch in floats, levers): the variants the source builds
VARIANTS = (
    ("(N, 3) no lever", 3, 0),
    ("(N, 3) stream evict-first (EF)", 3, EF),
    ("(N, 3) row spans", 3, SPANS),
    ("(N, 3) EF + spans (the port's set)", 3, EF | SPANS),
    ("(N, 3) EF + spans + texels evict-last", 3, EF | SPANS | EL),
    ("(N, 3) EF + spans + two lanes", 3, EF | SPANS | TWO_LANES),
    ("(N, 4) no lever", 4, 0),
    ("(N, 4) EF", 4, EF),
    ("(N, 4) EF + texels evict-last", 4, EF | EL),
)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def lever_fetch(lib, stride, levers):
    """fetch(t3, t4, idx4, w4) launching one variant of the lever source on
    the (N, 3) table t3 or its (N, 4) copy t4."""
    def fetch(t3, t4, idx4, w4):
        t = t3 if stride == 3 else t4
        out = torch.empty((3, idx4.shape[1]), dtype=torch.float32, device=t.device)
        cuda_build.check_launch(lib.fetch4_lever_launch(
            t.data_ptr(), t.shape[0], stride, idx4.data_ptr(), w4.data_ptr(), idx4.shape[1],
            out.data_ptr(), levers, _stream()), "texel-fetch lever kernel")
        return out
    return fetch


def source_fetch(lib, label):
    """fetch(t3, t4, idx4, w4) launching `fetch4_launch` of another texel-
    fetch source on the (N, 3) table."""
    def fetch(t3, t4, idx4, w4):
        out = torch.empty((3, idx4.shape[1]), dtype=torch.float32, device=t3.device)
        cuda_build.check_launch(lib.fetch4_launch(
            t3.data_ptr(), t3.shape[0], idx4.data_ptr(), w4.data_ptr(), idx4.shape[1],
            out.data_ptr(), _stream()), label)
        return out
    return fetch


def profile(compare=(), reps=30, out=DEFAULT_OUT, scene=None):
    """Time every variant, the port's `fetch4` and each source of `compare`
    on the cells of `scene` (default: the envlit scene at full size on
    cuda). Returns {"ms": {label: {cell: [ms in order, ms in reverse]}},
    "card", "table"}; raises if any launch differs from the twin."""
    if not torch.cuda.is_available():
        raise RuntimeError("the lever profile needs a CUDA device")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    compare = [Path(s) for s in compare]
    cuda_build.compile_sources(list(dict.fromkeys([tf.SRC, SRC, *compare])))
    lib = cuda_build.load_library(SRC, {
        "fetch4_lever_launch": ([p, i64, i32, p, p, i64, p, i32, p], i32)})
    fetches = {f"{s} (compare)": source_fetch(cuda_build.load_library(
        s, {"fetch4_launch": ([p, i64, p, p, i64, p, p], i32)}), str(s)) for s in compare}
    fetches["port: fetch4"] = lambda t3, t4, idx4, w4: tf.fetch4(t3, idx4, w4)
    for label, stride, levers in VARIANTS:
        fetches[label] = lever_fetch(lib, stride, levers)
    libcuda = ctypes.CDLL("libcuda.so.1")

    def reset():
        torch.cuda.synchronize()
        err = libcuda.cuCtxResetPersistingL2Cache()
        if err != 0:
            raise RuntimeError(f"cuCtxResetPersistingL2Cache failed: CUDA error {err}")

    if scene is None:
        from misaki_tpu_torch.scene.compiler import load_and_compile
        from misaki_tpu_torch.scenes.envlit import assets

        scene = load_and_compile(str(assets.prepared(ptf.SCENE_BUILD)), device="cuda")
    cells = ptf.make_cells(scene)
    ms = {label: {} for label in fetches}
    for cell in CELLS:
        t3, idx4, w4 = cells[cell]
        t4 = F.pad(t3, (0, 1)).contiguous()
        want = tf.fetch4_plain(t3, idx4, w4)
        for order in (list(fetches), list(fetches)[::-1]):
            for label in order:
                fn = fetches[label]
                reset()
                if not torch.equal(fn(t3, t4, idx4, w4), want):
                    raise RuntimeError(f"{label} differs from the plain twin on {cell}")
                reset()
                ms[label].setdefault(cell, []).append(
                    device_ms(lambda: fn(t3, t4, idx4, w4), reps))
        del t4
    reset()
    res = {"ms": ms, "card": f"{torch.cuda.get_device_name(0)} ({smi_line()})"}
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(report(res, reps))
    res["table"] = str(out)
    return res


def report(res, reps):
    lines = [
        "# Texel-fetch levers",
        "",
        f"Card: {res['card']}; torch {torch.__version__}, CUDA {torch.version.cuda}.",
        f"Device ms per launch (`device_ms`, {reps} launches behind a held stream), 2^20 "
        "lanes per cell, persisting L2 lines reset before each timing; timed in order / in "
        "reverse order. Every launch equal to the plain twin.",
        "",
        "| variant | " + " | ".join(CELLS) + " |",
        "|---|" + "---|" * len(CELLS),
    ]
    for label, per in res["ms"].items():
        lines.append(f"| {label} | " + " | ".join(
            "/".join(f"{t:.4f}" for t in per[c]) for c in CELLS) + " |")
    return "\n".join(lines) + "\n"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", action="append", default=[],
                    help="another texel-fetch source with the port's fetch4_launch")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args()
    res = profile(args.compare, reps=args.reps, out=args.out)
    print(Path(res["table"]).read_text(), end="")


if __name__ == "__main__":
    main()

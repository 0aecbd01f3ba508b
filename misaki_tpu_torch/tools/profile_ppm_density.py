"""The photon density estimate on the card: the port's grid kernel held
against the plain twin and timed on a captured photon depth.

    python -m misaki_tpu_torch.tools.profile_ppm_density [--reps N] [--out FILE]

Cells: the first splatted photon depth of a cbox frame (256x256, 262,144
photons) under `scenes/cbox/sppm.xml` and under `photonmapper.xml`,
captured from `render_ppm` with the frame's own grid, and `adversarial`,
the synthetic inputs of `adversarial` below (photons at the largest
float32 distance that still passes, on cell boundaries, crowded into one
cell, outside the grid's box, at inf and NaN positions; radii varying
100x, one larger than a cell) all in one estimate.

The port's estimate (`ppm.density_launch`) is held against the plain twin
`density_plain`: counts equal to the bit and phi allclose (rtol 1e-5, atol
1e-6 of the twin's largest magnitude) in each of `--checks` calls, and phi
equal to the bit between calls; then both are timed with
`profile_cluster_frame.device_ms`, in order, then in reverse. The table,
with the CUDA launches of one estimate, the pairs the grid tested and the
bounds, goes to `--out` (default `chiprun_out/profile_ppm_density.md`).
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from misaki_tpu_torch.render import ppm
from misaki_tpu_torch.tools.profile_cluster_frame import ROOT, bound_ms, device_ms, smi_line

DEFAULT_OUT = ROOT / "chiprun_out" / "profile_ppm_density.md"
SCENES = ROOT / "misaki_tpu_torch" / "scenes"

# ---------------------------------------------------------------------------
# adversarial inputs (numpy, seeded): the grid is the unit cube in 16 cells
# of h = 1/16 an axis
# ---------------------------------------------------------------------------

CASES = ("max_distance", "cell_boundaries", "radii", "one_cell", "outside", "nonfinite",
         "empty")
H = 1.0 / 16.0


def adversarial_grid():
    return ppm.density_grid((0.5, 0.5, 0.5), 0.5, H)


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _near_z(rs, k, spread=0.1):
    """k unit vectors (3, k) float32 near +z."""
    v = rs.normal(0.0, spread, (3, k))
    v[2] += 1.0
    return _f32(v / np.linalg.norm(v, axis=0))


def _photons(rs, p, ok=0.95):
    """Photons at positions p (3, P): wi and n near +z (wi . n > 0), flux in
    [0, 2), a share `ok` alive."""
    P = p.shape[1]
    return {"p": _f32(p), "wi": _near_z(rs, P), "n": _near_z(rs, P),
            "flux": _f32(rs.uniform(0.0, 2.0, (4, P))), "ok": rs.uniform(size=P) < ok}


def _vps(rs, p, r):
    """Visible points at p (3, L) with radii r (L,): wi and n near +z, 95%
    valid, 5% glossy. Returns (vp, r2)."""
    L = p.shape[1]
    r = _f32(r)
    return ({"p": _f32(p), "wi": _near_z(rs, L), "n": _near_z(rs, L),
             "valid": rs.uniform(size=L) < 0.95, "glossy": rs.uniform(size=L) < 0.05},
            _f32(r * r))


def _directions():
    """The 26 directions of the axes and the diagonals, unit, float64."""
    d = np.array([(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1)
                  if (x, y, z) != (0, 0, 0)], np.float64).T
    return d / np.linalg.norm(d, axis=0)


def farthest(p, r2, u, iters=80):
    """For visible points p (3, N) float32 with r2 (N,) and unit directions
    u (3, N): photon positions q = fl(p + t u) at the largest t that still
    passes the twin's float32 test d2 < r2 (q_in), and at the next t found
    that does not (q_out), by bisection on t."""
    p64 = p.astype(np.float64)

    def at(t):
        return _f32(p64 + t[None, :] * u)

    def passes(q):
        d = q - p   # float32
        return d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < r2

    lo = np.zeros(p.shape[1])
    hi = 2.0 * np.sqrt(r2.astype(np.float64)) + 1e-30
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = passes(at(mid))
        lo, hi = np.where(ok, mid, lo), np.where(ok, hi, mid)
    return at(lo), at(hi)


def adversarial(case, seed=0):
    """One adversarial case: (vp, r2, photons) as numpy float32 / bool
    arrays; the grid is `adversarial_grid()`."""
    rs = np.random.default_rng([seed, CASES.index(case)])
    if case == "max_distance":
        # visible points at random places, on cell boundaries, at cell
        # centres and where the sphere's extreme touches a boundary; a photon
        # at the farthest passing point and one just beyond, along each axis
        # and diagonal
        k = rs.integers(4, 13, (3, 6))
        r = H * np.array([1.0, 0.99999, 0.75, 0.5, 0.25, 1.0] * 4)
        p = np.concatenate([rs.uniform(0.25, 0.75, (3, 6)), k * H, (k + 0.5) * H,
                            k * H - r[None, 18:]], axis=1)
        vp, r2 = _vps(rs, p, r)
        vp["valid"][:] = True
        vp["glossy"][:] = False
        u = _directions()
        n_vp, n_dir = p.shape[1], u.shape[1]
        pp = np.repeat(vp["p"], n_dir, axis=1)
        q_in, q_out = farthest(pp, np.repeat(r2, n_dir), np.tile(u, n_vp))
        ph = _photons(rs, np.concatenate([q_in, q_out], axis=1), ok=1.0)
    elif case == "cell_boundaries":
        b = _f32(rs.integers(0, 17, (3, 3000)) * H)
        step = rs.integers(-1, 2, (3, 3000))
        b = np.where(step > 0, np.nextafter(b, _f32(np.inf)),
                     np.where(step < 0, np.nextafter(b, _f32(-np.inf)), b))
        ph = _photons(rs, b)
        p = np.concatenate([rs.integers(1, 16, (3, 100)) * H, rs.uniform(0.0, 1.0, (3, 300))],
                           axis=1)
        vp, r2 = _vps(rs, p, H * rs.uniform(0.3, 1.0, 400))
    elif case == "radii":
        p = rs.uniform(0.1, 0.9, (3, 300))
        r = H * 10.0 ** rs.uniform(-2.0, 0.0, 300)
        r[7] = 3.7 * H
        vp, r2 = _vps(rs, p, r)
        ph = _photons(rs, p[:, rs.integers(0, 300, 4000)] + rs.normal(0.0, H, (3, 4000)))
    elif case == "one_cell":
        ph = _photons(rs, 7 * H + rs.uniform(0.0, H, (3, 4000)))
        vp, r2 = _vps(rs, 7.5 * H + rs.uniform(-2 * H, 2 * H, (3, 300)),
                      H * rs.uniform(0.3, 1.0, 300))
    elif case == "outside":
        face = rs.integers(0, 3, 1500)
        near = rs.uniform(0.0, 1.0, (3, 1500))
        near[face, np.arange(1500)] = np.where(rs.uniform(size=1500) < 0.5,
                                               -rs.uniform(0.0, H, 1500),
                                               1.0 + rs.uniform(0.0, H, 1500))
        ph = _photons(rs, np.concatenate([rs.uniform(-1.0, 2.0, (3, 1500)), near], axis=1))
        vp, r2 = _vps(rs, rs.uniform(-0.1, 1.1, (3, 400)), H * rs.uniform(0.5, 2.0, 400))
    elif case == "nonfinite":
        p = rs.uniform(0.1, 0.9, (3, 300))
        vp, r2 = _vps(rs, p, H * rs.uniform(0.3, 1.0, 300))
        ph = _photons(rs, np.concatenate(
            [p[:, rs.integers(0, 300, 1000)] + rs.normal(0.0, H, (3, 1000)),
             rs.choice(_f32([np.inf, -np.inf, np.nan, 0.5]), (3, 1000))], axis=1))
        ph["ok"][1000:1500] = False                      # dead
        ph["ok"][1500:] = True                           # alive, wi . n <= 0
        ph["wi"][:, 1500:] = -ph["n"][:, 1500:]
        ph["wi"][:, 1900:] = np.nan
    elif case == "empty":
        vp, r2 = _vps(rs, rs.uniform(0.0, 1.0, (3, 200)), H * rs.uniform(0.3, 1.0, 200))
        ph = _photons(rs, np.zeros((3, 0)))
    else:
        raise ValueError(f"no adversarial case {case!r}")
    return vp, r2, ph


def mixed(seed=0):
    """Every adversarial case in one estimate: their visible points and
    photons concatenated."""
    parts = [adversarial(c, seed) for c in CASES]
    vp = {k: np.concatenate([v[k] for v, _, _ in parts], axis=-1) for k in parts[0][0]}
    ph = {k: np.concatenate([q[k] for _, _, q in parts], axis=-1) for k in parts[0][2]}
    return vp, np.concatenate([r2 for _, r2, _ in parts]), ph


def to_args(vp, r2, ph, sppm_mode, device):
    """The estimate's arguments from numpy arrays: (vp, radius2, ph_p, ph_wi,
    ph_n, ph_flux, ph_ok, sppm_mode)."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def t3(x):
        return tuple(t(c) for c in x)

    return ({k: t3(v) if v.ndim == 2 else t(v) for k, v in vp.items()}, t(r2), t3(ph["p"]),
            t3(ph["wi"]), t3(ph["n"]), t(ph["flux"]), t(ph["ok"]), sppm_mode)


# ---------------------------------------------------------------------------
# captured depths, checks, bounds
# ---------------------------------------------------------------------------

class _Captured(Exception):
    pass


def capture(integrator, width=256, height=256, seed=21, depth_cap=4, device="cuda", **kw):
    """The arguments and grid of the first density estimate of a cbox frame
    under `integrator` (`scenes/cbox/<integrator>.xml`, `kw` replacing its
    settings): (args, grid). The frame stops there."""
    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.scene.compiler import load_and_compile

    scene = load_and_compile(str(SCENES / "cbox" / f"{integrator}.xml"), width=width,
                             height=height, device=device)
    if kw:
        scene = scene.replace(**kw)
    got = {}
    estimate = ppm.density_estimate

    def grab(*args, grid=None):
        got.update(args=args, grid=grid)
        raise _Captured()

    ppm.density_estimate = grab
    try:
        render(scene, seed=seed, depth_cap=depth_cap, progress=lambda done, total: None)
    except _Captured:
        pass
    finally:
        ppm.density_estimate = estimate
    if "args" not in got:
        raise RuntimeError(f"the {integrator} frame made no density estimate")
    return got["args"], got["grid"]


def check(fn, want, calls=10):
    """fn() -> (phi, count) against the twin's `want` in each of `calls`
    calls: counts equal, phi allclose (rtol 1e-5, atol 1e-6 of the twin's
    largest magnitude), phi equal to the bit between calls; the largest
    error and the share of the tolerance it used."""
    phi_t, count_t = want
    scale = float(phi_t.abs().max()) if phi_t.numel() else 0.0
    res = {"counts_equal": True, "allclose_every_call": True, "bit_equal_between_calls": True,
           "max_abs_err": 0.0, "tolerance_used": 0.0, "calls": calls}
    first = None
    for _ in range(calls):
        phi, count = fn()
        if phi.is_cuda:
            torch.cuda.synchronize()
        res["counts_equal"] &= bool(torch.equal(count, count_t))
        res["allclose_every_call"] &= bool(torch.allclose(phi, phi_t, rtol=1e-5,
                                                          atol=1e-6 * scale))
        if phi.numel():
            err = (phi - phi_t).abs()
            res["max_abs_err"] = max(res["max_abs_err"], float(err.max()))
            res["tolerance_used"] = max(res["tolerance_used"], float(
                (err / (1e-6 * scale + 1e-5 * phi_t.abs()).clamp(min=1e-30)).max()))
        if first is None:
            first = phi.clone()
        else:
            res["bit_equal_between_calls"] &= bool(torch.equal(phi, first))
    res["ok"] = (res["counts_equal"] and res["allclose_every_call"]
                 and res["bit_equal_between_calls"])
    return res


def bounds(args, want):
    """The bounds of one estimate on `args`. The least work any
    implementation must do: read the bytes the function needs once (every
    photon's alive flag; an alive photon's wi and n, for wi . n > 0; a
    photon that may contribute, its position and flux; every visible
    point's live flag; a live one's position, the one direction the mode
    tests and r2) and write the (4, L) phi and (L,) count once, against the
    FP32 operations of the alive photons' wi . n (5 each) and of the
    passing pairs (20 each: the pair test and the sums), the larger.
    Beside it the dense form's: every input row read once, 15 operations
    for every pair of a live visible point and a photon that may
    contribute, 5 more a passing pair. Returns a dict of the counts and
    both bounds in ms."""
    vp, r2, ph_p, ph_wi, ph_n, flux, ok, _ = args
    L, P = r2.shape[0], ok.shape[0]
    wiz = ph_wi[0] * ph_n[0] + ph_wi[1] * ph_n[1] + ph_wi[2] * ph_n[2]
    n_alive = int(ok.sum())
    n_live = int((vp["valid"] & ~vp["glossy"]).sum())
    n_ok = int((ok & (wiz > 0.0)).sum())
    passed = int(want[1].sum())
    n_bytes = 4 * (P + 6 * n_alive + 7 * n_ok + L + 7 * n_live + 5 * L)
    dense_bytes = 4 * (14 * P + 11 * L + 5 * L)
    ms, by = bound_ms(n_bytes, 5 * n_alive + 20 * passed)
    dense_ms, dense_by = bound_ms(dense_bytes, 15 * n_live * n_ok + 5 * passed)
    return {"photons": P, "visible_points": L, "live_visible_points": n_live,
            "alive_photons": n_alive, "contributing_photons": n_ok, "pairs_passed": passed,
            "bytes": n_bytes, "bound_ms": ms, "bound_by": by, "dense_bytes": dense_bytes,
            "dense_bound_ms": dense_ms, "dense_bound_by": dense_by,
            "dense_pairs": n_live * n_ok}


def kernel_times(fn, reps=10):
    """Device ms per call of each CUDA kernel that fn() launches, over
    `reps` calls under torch.profiler: {kernel name: (ms, launches)}; empty
    where the profiler records no device time."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        name = re.sub(r"\(.*$", "", re.sub(r"^void |\(anonymous namespace\)::", "", e.key))
        ms, n = out.get(name, (0.0, 0.0))
        out[name] = (ms + t / 1e3 / reps, n + e.count / reps)
    return out


def cells(device="cuda"):
    """{cell: (args, grid)}: the captured cbox depths and the adversarial
    mix."""
    out = {f"cbox_{i}": capture(i, device=device) for i in ("sppm", "photonmapper")}
    out["adversarial"] = (to_args(*mixed(), True, device), adversarial_grid())
    return out


def profile(reps=10, checks=3, out=DEFAULT_OUT):
    """Check and time the port's estimate and the twin on every cell.
    Returns {"cells": {cell: {"bounds", "grid", "port_kernels",
    "cuda_launches", "pair_tests", "pair_tests_plain", "check", "ms": {label:
    [in order, in reverse]}}}, "card", "table"}; raises if the port
    disagrees with the twin."""
    if not torch.cuda.is_available():
        raise RuntimeError("the density profile needs a CUDA device")
    lib = ppm.build()
    res = {"cells": {}, "card": f"{torch.cuda.get_device_name(0)} ({smi_line()})"}
    for name, (args, grid) in cells().items():
        sppm_mode = args[-1]
        ph, vps = ppm.pack_inputs(*args[:-1])
        want = ppm.density_plain(*args)
        stats, plain_stats = {}, {}
        ppm.density_launch(lib, ph, vps, sppm_mode, grid, stats=stats, pair_tests=True)
        ppm.density_binned_plain(*args, grid, stats=plain_stats)
        fns = {"port": lambda: ppm.density_launch(lib, ph, vps, sppm_mode, grid),
               "plain twin": lambda: ppm.density_plain(*args)}
        cell = {"bounds": bounds(args, want), "grid": list(grid.dims),
                "port_kernels": kernel_times(fns["port"]),
                "cuda_launches": stats["cuda_launches"],
                "pair_tests": int(stats["pair_tests"].item()),
                "pair_tests_plain": plain_stats["pair_tests"],
                "check": check(fns["port"], want, checks), "ms": {}}
        if not cell["check"]["ok"]:
            raise RuntimeError(f"the port disagrees with the plain twin on {name}: "
                               f"{cell['check']}")
        for order in (list(fns), list(fns)[::-1]):
            for label in order:
                cell["ms"].setdefault(label, []).append(
                    device_ms(fns[label], 2 if label == "plain twin" else reps))
        res["cells"][name] = cell
        del ph, vps, want, fns
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(report(res, reps))
    res["table"] = str(out)
    return res


def report(res, reps):
    names = list(res["cells"])
    lines = [
        "# Photon density estimate: the grid kernel against its plain twin",
        "",
        f"Card: {res['card']}; torch {torch.__version__}, CUDA {torch.version.cuda}.",
        f"Device ms per estimate (`device_ms`, {reps} estimates behind a held stream; the "
        "twin 2), timed in order / in reverse order. The port's counts equal the twin's and "
        "its phi is allclose in every check, and equal to the bit between calls.",
        "",
    ]
    for name in names:
        c, b = res["cells"][name], res["cells"][name]["bounds"]
        lines.append(
            f"- {name}: {b['photons']} photons ({b['alive_photons']} alive, "
            f"{b['contributing_photons']} may contribute) x "
            f"{b['visible_points']} visible points ({b['live_visible_points']} live), "
            f"{b['pairs_passed']} pairs pass; grid {c['grid']}; the port's estimate is "
            f"{c['cuda_launches']} CUDA launches and tests {c['pair_tests']} pairs "
            f"(`density_binned_plain` {c['pair_tests_plain']}; the dense form "
            f"{b['dense_pairs']}); bound {b['bound_ms']:.6f} ms ({b['bound_by']}, "
            f"{b['bytes']} bytes), the dense form's {b['dense_bound_ms']:.4f} ms; the port's "
            "kernels (ms an estimate, torch.profiler): " + ", ".join(
                f"{k} {ms:.4f} x{n:g}" for k, (ms, n) in c["port_kernels"].items()))
    lines += ["", "| estimate | " + " | ".join(names) + " |", "|---|" + "---|" * len(names)]
    for label in res["cells"][names[0]]["ms"]:
        lines.append(f"| {label} | " + " | ".join(
            "/".join(f"{t:.4f}" for t in res["cells"][n]["ms"][label]) for n in names) + " |")
    return "\n".join(lines) + "\n"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--checks", type=int, default=3)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args()
    res = profile(reps=args.reps, checks=args.checks, out=args.out)
    print(Path(res["table"]).read_text(), end="")


if __name__ == "__main__":
    main()

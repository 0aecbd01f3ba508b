"""Cluster-BVH intersection: host build, visit schedule, and the closest-hit
and any-hit kernels with their plain PyTorch twins.

  * **Build (host, NumPy)**: recursive largest-extent splits of the faces
    into clusters of `CLUSTER_FACES` triangles, packed into a dense
    (C, B, 10) table [p0, e1, e2, face_id] plus the face table in cluster
    order (C, T, B) and the cluster AABBs (8, Cpad).
  * **Schedule (`cull_order`, plain torch)**: the wavefront is cut into tiles
    of `R_TILE` consecutive rays. Each tile's rays are bounded by component
    intervals, every cluster AABB is tested against them with interval
    arithmetic, and the clusters the tile can reach are sorted front to back
    by a conservative entry distance (the key).
  * **Walk (`closest_hit` / `any_hit`)**: each tile walks its visit list,
    running dense Moller-Trumbore over each visited cluster's faces, and
    stops once no ray of the tile can find a nearer hit behind the next key.

On a CUDA tensor the walk is `csrc/cluster.cu`; on a CPU tensor it is the
plain twin below, which computes the same walk with tensor ops. The twins are
the kernels' oracles, and both follow `misaki_tpu.accel.cluster` exactly: the
same schedule, the same tie rules (inside a cluster the largest face id
wins; across clusters the first one visited wins), the same miss encoding.
"""

import ctypes

import numpy as np
import torch

from misaki_tpu_torch.scene.types import ClusterAccel
from misaki_tpu_torch.utils import cuda_build

CLUSTER_FACES = 128   # faces per cluster (B)
R_TILE = 256          # rays per tile: one CUDA block, one thread per ray
MAX_VISITS = 128      # visit-list cap per tile; overflow -> full scan
_BIG = 3.0e38

# Launch counts of the CUDA kernels. Each wrapper adds one where it
# launches its kernel, and nowhere else.
closest_launches = 0
anyhit_launches = 0

SRC = cuda_build.CSRC / "cluster.cu"


def build_clusters(p0, e1, e2, target=CLUSTER_FACES, face_tab=None):
    """Host-side cluster build: recursive largest-extent splits, each at the
    `target`-multiple nearest the median, so every leaf but one ragged tail
    per chain holds exactly `target` faces (the `balanced` packer of
    misaki_tpu.accel.cluster.build_clusters, with the same output)."""
    F = len(p0)
    v0 = np.asarray(p0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    v1, v2 = v0 + e1, v0 + e2
    tri_lo = np.minimum(np.minimum(v0, v1), v2)
    tri_hi = np.maximum(np.maximum(v0, v1), v2)
    cen = 0.5 * (tri_lo + tri_hi)

    clusters = []
    stack = [np.arange(F)]
    while stack:
        idx = stack.pop()
        if len(idx) <= target:
            clusters.append(idx)
            continue
        c = cen[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        o = np.argsort(c[:, ax], kind="stable")
        mid = int(round(len(idx) / 2 / target)) * target
        mid = min(max(mid, target), len(idx) - 1)
        stack.append(idx[o[mid:]])
        stack.append(idx[o[:mid]])

    C = len(clusters)
    Cpad = max(-(-C // 128) * 128, 128)
    tri = np.zeros((C, target, 10), np.float32)
    tri[:, :, 9] = -1.0
    T = 1 if face_tab is None else face_tab.shape[0]
    tab = np.zeros((C, T, target), np.float32)
    bounds = np.empty((8, Cpad), np.float32)
    bounds[0:3, :] = np.float32(np.inf)    # padded clusters: lo=+inf, hi=-inf
    bounds[3:6, :] = np.float32(-np.inf)
    bounds[6:8, :] = 0.0
    for ci, idx in enumerate(clusters):
        n = len(idx)
        tri[ci, :n, 0:3] = v0[idx]
        tri[ci, :n, 3:6] = e1[idx]
        tri[ci, :n, 6:9] = e2[idx]
        tri[ci, :n, 9] = idx.astype(np.float32)   # exact to 2^24 faces
        if face_tab is not None:
            tab[ci, :, :n] = np.asarray(face_tab)[:, idx]
        bounds[0:3, ci] = tri_lo[idx].min(axis=0)
        bounds[3:6, ci] = tri_hi[idx].max(axis=0)
    return ClusterAccel(bounds=bounds, tri=tri, tab=tab, n_clusters=C)


# ---------------------------------------------------------------------------
# ray packing and the visit schedule (plain torch on every device)
# ---------------------------------------------------------------------------

def _safe_rcp(c):
    return 1.0 / torch.where(torch.abs(c) < 1e-20, torch.where(c < 0, -1e-20, 1e-20), c)


def pack_rays(o, d, mint, maxt):
    """Components -> (8, Lp) lane-last ray matrix, Lp a multiple of R_TILE.
    Padded rays have o = d = 0, mint = 0, maxt = -1: they hit nothing."""
    L = o[0].shape[0]
    Lp = max(R_TILE, -(-L // R_TILE) * R_TILE)
    rays = torch.zeros((8, Lp), dtype=torch.float32, device=o[0].device)
    rays[7, L:] = -1.0
    for k, comp in enumerate((o[0], o[1], o[2], d[0], d[1], d[2], mint, maxt)):
        rays[k, :L] = comp
    return rays


def cull_order(rays, bounds, n_clusters):
    """Per-tile cluster cull and front-to-back visit order
    (misaki_tpu.accel.cluster._cull_order with R_TILE tiles).

    rays: (8, Lp); bounds: (8, Cpad). Returns order (nt, MAX_VISITS) int32,
    keys (nt, MAX_VISITS) float32 (sorted entry distances) and count (nt,)
    int32, negative when the tile reaches more than MAX_VISITS clusters (the
    kernels then scan every cluster in id order)."""
    nt = rays.shape[1] // R_TILE
    rv = rays.reshape(8, nt, R_TILE)
    inv = _safe_rcp(rv[3:6])
    o_lo, o_hi = rv[0:3].amin(dim=2), rv[0:3].amax(dim=2)     # (3, nt)
    i_lo, i_hi = inv.amin(dim=2), inv.amax(dim=2)
    cpad = bounds.shape[1]
    tn_lower = rv[6].amin(dim=1)[:, None].expand(nt, cpad)
    tf_upper = rv[7].amax(dim=1)[:, None].expand(nt, cpad)
    for k in range(3):
        lo_c = bounds[k][None, :]
        hi_c = bounds[k + 3][None, :]
        il = i_lo[k][:, None]
        ih = i_hi[k][:, None]

        def imul(a_lo, a_hi):
            p1, p2 = a_lo * il, a_lo * ih
            p3, p4 = a_hi * il, a_hi * ih
            return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                    torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

        t0_lo, t0_hi = imul(lo_c - o_hi[k][:, None], lo_c - o_lo[k][:, None])
        t1_lo, t1_hi = imul(hi_c - o_hi[k][:, None], hi_c - o_lo[k][:, None])
        tn_lower = torch.maximum(tn_lower, torch.minimum(t0_lo, t1_lo))
        tf_upper = torch.minimum(tf_upper, torch.maximum(t0_hi, t1_hi))

    valid = (bounds[0] <= bounds[3])[None, :]
    possible = (tn_lower <= tf_upper) & valid
    key = torch.where(possible, tn_lower, _BIG)
    key_sorted, order = torch.sort(key, dim=1, stable=True)
    count = (key < _BIG).sum(dim=1).to(torch.int32)
    count = torch.where(count > MAX_VISITS, -n_clusters, count).to(torch.int32)
    return (order[:, :MAX_VISITS].to(torch.int32).contiguous(),
            key_sorted[:, :MAX_VISITS].contiguous(), count.contiguous())


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

_TILE_BATCH = 128  # tiles per step of the plain walk (bounds its temporaries)


def _mt(r, blk, t_cap):
    """Dense Moller-Trumbore of tiles of rays against one cluster each.
    r: (8, m, R); blk: (m, B, 10); t_cap: (m, R). Returns t, u, v, hit,
    each (m, B, R) — the arithmetic of misaki_tpu's _mt_cluster."""
    p0x, p0y, p0z = blk[:, :, 0:1], blk[:, :, 1:2], blk[:, :, 2:3]
    e1x, e1y, e1z = blk[:, :, 3:4], blk[:, :, 4:5], blk[:, :, 5:6]
    e2x, e2y, e2z = blk[:, :, 6:7], blk[:, :, 7:8], blk[:, :, 8:9]
    ox, oy, oz, dx, dy, dz, mint = (r[k][:, None, :] for k in range(7))

    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = ((torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= mint) & (t <= t_cap[:, None, :]))
    return t, u, v, hit


def closest_hit_plain(rays, tri, tab, order, keys, count):
    """Plain twin of the closest-hit kernel. Returns out (4, Lp) rows
    [t (3e38 on miss), u, v, face id (-1 on miss)] and fd (T, Lp), the
    winner's face-table row (zeros on miss)."""
    Lp = rays.shape[1]
    nt = Lp // R_TILE
    C, B, _ = tri.shape
    dev = rays.device
    out = torch.empty((4, Lp), dtype=torch.float32, device=dev)
    c_win = torch.empty(Lp, dtype=torch.int64, device=dev)
    s_win = torch.empty(Lp, dtype=torch.int64, device=dev)
    slots = torch.arange(B, device=dev)[None, :, None]
    for s in range(0, nt, _TILE_BATCH):
        e = min(nt, s + _TILE_BATCH)
        m = e - s
        r = rays[:, s * R_TILE:e * R_TILE].reshape(8, m, R_TILE)
        t_b = torch.clamp(r[7], max=_BIG)
        u_b = torch.zeros_like(t_b)
        v_b = torch.zeros_like(t_b)
        f_b = torch.full_like(t_b, -1.0)
        cw = torch.zeros((m, R_TILE), dtype=torch.int64, device=dev)
        sw = torch.zeros((m, R_TILE), dtype=torch.int64, device=dev)
        n_raw = count[s:e].to(torch.int64)
        full = n_raw < 0
        n = torch.abs(n_raw)
        alive = torch.ones(m, dtype=torch.bool, device=dev)
        for k in range(int(n.max())):
            kk = min(k, MAX_VISITS - 1)
            open_ = full | (keys[s:e, kk] < t_b.amax(dim=1))
            alive = alive & (k < n) & open_
            idx = alive.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            c = torch.where(full[idx], k, order[s + idx, kk].to(torch.int64))
            c = torch.clamp(c, max=C - 1)
            blk = tri[c]
            t_i = t_b[idx]
            t, u, v, hit = _mt(r[:, idx], blk, t_i)
            fid = blk[:, :, 9:10]
            tm = torch.where(hit & (fid >= 0.0), t, _BIG)
            tmin = tm.amin(dim=1)
            sel = tm <= tmin[:, None, :]
            fwin = torch.where(sel, fid, -1.0).amax(dim=1)
            sel2 = sel & (fid == fwin[:, None, :])
            um = torch.where(sel2, u, -_BIG).amax(dim=1)
            vm = torch.where(sel2, v, -_BIG).amax(dim=1)
            slot = torch.where(sel2, slots, -1).amax(dim=1)
            take = tmin < t_i
            t_b[idx] = torch.where(take, tmin, t_i)
            u_b[idx] = torch.where(take, um, u_b[idx])
            v_b[idx] = torch.where(take, vm, v_b[idx])
            f_b[idx] = torch.where(take, fwin, f_b[idx])
            cw[idx] = torch.where(take, c[:, None], cw[idx])
            sw[idx] = torch.where(take, slot, sw[idx])
        lanes = slice(s * R_TILE, e * R_TILE)
        out[0, lanes] = torch.where(f_b >= 0.0, t_b, _BIG).reshape(-1)
        out[1, lanes] = u_b.reshape(-1)
        out[2, lanes] = v_b.reshape(-1)
        out[3, lanes] = f_b.reshape(-1)
        c_win[lanes] = cw.reshape(-1)
        s_win[lanes] = sw.reshape(-1)
    fd = tab[c_win, :, s_win].T                       # (T, Lp)
    fd = torch.where(out[3][None, :] >= 0.0, fd, 0.0)
    return out, fd.contiguous()


def any_hit_plain(rays, tri, order, keys, count):
    """Plain twin of the any-hit kernel: (Lp,) float32, 1 = occluded."""
    Lp = rays.shape[1]
    nt = Lp // R_TILE
    C = tri.shape[0]
    dev = rays.device
    out = torch.empty(Lp, dtype=torch.float32, device=dev)
    for s in range(0, nt, _TILE_BATCH):
        e = min(nt, s + _TILE_BATCH)
        m = e - s
        r = rays[:, s * R_TILE:e * R_TILE].reshape(8, m, R_TILE)
        maxt_cap = torch.clamp(r[7], max=_BIG)
        occ = torch.zeros((m, R_TILE), dtype=torch.bool, device=dev)
        n_raw = count[s:e].to(torch.int64)
        full = n_raw < 0
        n = torch.abs(n_raw)
        alive = torch.ones(m, dtype=torch.bool, device=dev)
        for k in range(int(n.max())):
            kk = min(k, MAX_VISITS - 1)
            bound = torch.where(occ, -_BIG, maxt_cap).amax(dim=1)
            alive = alive & (k < n) & (full | (keys[s:e, kk] <= bound))
            idx = alive.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            c = torch.where(full[idx], k, order[s + idx, kk].to(torch.int64))
            blk = tri[torch.clamp(c, max=C - 1)]
            r_i = r[:, idx]
            _, _, _, hit = _mt(r_i, blk, r_i[7])
            occ[idx] = occ[idx] | (hit & (blk[:, :, 9:10] >= 0.0)).any(dim=1)
        out[s * R_TILE:e * R_TILE] = occ.reshape(-1).to(torch.float32)
    return out


# ---------------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------

def build():
    """Compile csrc/cluster.cu with nvcc for sm_90a (once per source hash)
    and load it. Returns the ctypes library."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return cuda_build.load_library(SRC, {
        "closest_hit_launch": ([p, i64, p, p, i32, i32, i32, p, p, p, i32, p, p, p], i32),
        "any_hit_launch": ([p, i64, p, i32, i32, p, p, p, i32, p, p], i32),
    })


def _check_inputs(rays, tri, order, keys, count):
    dev = rays.device
    for name, x, dt in (("rays", rays, torch.float32), ("tri", tri, torch.float32),
                        ("order", order, torch.int32), ("keys", keys, torch.float32),
                        ("count", count, torch.int32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Lp = rays.shape[1]
    nt = Lp // R_TILE
    if rays.shape[0] != 8 or Lp % R_TILE or Lp == 0:
        raise ValueError(f"rays must be (8, k*{R_TILE}), got {tuple(rays.shape)}")
    if tri.dim() != 3 or tri.shape[2] != 10 or tri.shape[1] > CLUSTER_FACES:
        raise ValueError(f"tri must be (C, B<={CLUSTER_FACES}, 10), got {tuple(tri.shape)}")
    if order.shape != (nt, MAX_VISITS) or keys.shape != (nt, MAX_VISITS) or count.shape != (nt,):
        raise ValueError("schedule shapes do not match the ray tiles")


def closest_hit(rays, tri, tab, order, keys, count):
    """Closest hit of packed rays over the cluster tables, walking the
    schedule of `cull_order`. CPU tensors take the plain twin; CUDA tensors
    launch the kernel. Returns (out (4, Lp), fd (T, Lp))."""
    global closest_launches
    _check_inputs(rays, tri, order, keys, count)
    C, B, _ = tri.shape
    if tab.shape[0] != C or tab.shape[2] != B or tab.device != rays.device \
            or tab.dtype != torch.float32 or not tab.is_contiguous():
        raise ValueError("tab must be a contiguous float32 (C, T, B) tensor on the rays' device")
    if rays.device.type == "cpu":
        return closest_hit_plain(rays, tri, tab, order, keys, count)
    if rays.device.type != "cuda":
        raise ValueError(f"no closest-hit kernel for device {rays.device}")
    lib = build()
    Lp = rays.shape[1]
    T = tab.shape[1]
    out = torch.empty((4, Lp), dtype=torch.float32, device=rays.device)
    fd = torch.empty((T, Lp), dtype=torch.float32, device=rays.device)
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    cuda_build.check_launch(lib.closest_hit_launch(
        rays.data_ptr(), Lp, tri.data_ptr(), tab.data_ptr(), C, B, T, order.data_ptr(),
        keys.data_ptr(), count.data_ptr(), MAX_VISITS, out.data_ptr(), fd.data_ptr(), stream),
        "closest-hit kernel")
    closest_launches += 1
    return out, fd


def any_hit(rays, tri, order, keys, count):
    """Occlusion of packed rays (any hit in [mint, maxt]); (Lp,) float32,
    1 = occluded. CPU tensors take the plain twin; CUDA tensors launch the
    kernel."""
    global anyhit_launches
    _check_inputs(rays, tri, order, keys, count)
    if rays.device.type == "cpu":
        return any_hit_plain(rays, tri, order, keys, count)
    if rays.device.type != "cuda":
        raise ValueError(f"no any-hit kernel for device {rays.device}")
    lib = build()
    Lp = rays.shape[1]
    C, B, _ = tri.shape
    out = torch.empty(Lp, dtype=torch.float32, device=rays.device)
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    cuda_build.check_launch(lib.any_hit_launch(
        rays.data_ptr(), Lp, tri.data_ptr(), C, B, order.data_ptr(), keys.data_ptr(),
        count.data_ptr(), MAX_VISITS, out.data_ptr(), stream), "any-hit kernel")
    anyhit_launches += 1
    return out


# ---------------------------------------------------------------------------
# wavefront entry points
# ---------------------------------------------------------------------------

def intersect_clusters(acc, o, d, mint, maxt):
    """Closest hit over the cluster accel; o/d vec3 tuples of (L,).
    Returns {"t", "prim", "u", "v", "fd"} with t = inf / prim = -1 / fd = 0
    on a miss; "fd" is the winner's face-table row, (T, L)."""
    L = o[0].shape[0]
    rays = pack_rays(o, d, mint, maxt)
    order, keys, count = cull_order(rays, acc.bounds, acc.n_clusters)
    out, fd = closest_hit(rays, acc.tri, acc.tab, order, keys, count)
    prim = out[3, :L].to(torch.int32)
    return {
        "t": torch.where(prim >= 0, out[0, :L], torch.inf),
        "prim": prim,
        "u": out[1, :L],
        "v": out[2, :L],
        "fd": fd[:, :L],
    }


def ray_test_clusters(acc, o, d, mint, maxt):
    """Any-hit visibility test; True = occluded."""
    L = o[0].shape[0]
    rays = pack_rays(o, d, mint, maxt)
    order, keys, count = cull_order(rays, acc.bounds, acc.n_clusters)
    return any_hit(rays, acc.tri, order, keys, count)[:L] > 0.5

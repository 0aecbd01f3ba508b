"""Cluster-BVH intersection: host build, the closest-hit and any-hit kernels,
and their plain PyTorch twins.

  * **Build (host, NumPy)**: recursive largest-extent splits of the faces
    into clusters of `CLUSTER_FACES` triangles, packed into misaki_tpu's
    tables: a dense (C, B, 10) face table [p0, e1, e2, face_id], the face
    table in cluster order (C, T, B) and the cluster AABBs (8, Cpad). The
    recursion, recorded, is the top of a BVH2 that goes on with the same
    split rule inside each cluster down to leaves of `LEAF_FACES` faces
    (`nodes`, `leaf_tri`).
  * **Kernels (`closest_hit` / `any_hit` on CUDA tensors, csrc/cluster.cu)**:
    one thread per ray walks the BVH2 with a stack of its own.
  * **Twins (`closest_hit_plain` / `any_hit_plain`, the CPU path)**:
    misaki_tpu's tile walk over the cluster tables. The wavefront is cut
    into tiles of `R_TILE` rays, `cull_order` sorts the clusters each tile
    can reach front to back, and each tile runs dense Moller-Trumbore over
    its list until no later cluster can hold a nearer hit.

Kernel and twin compute one function, the exact lexicographic closest hit:
the smallest t wins, and among equal t the largest face id, whatever order
the faces are visited in. (misaki_tpu lets the first cluster visited win a
tie across clusters; that rule depends on the walk's order, which a per-ray
traversal does not share. t is the same either way.) Misses give t = 3e38
(inf at the entry points), face id -1 and an all-zero face row.

Moller-Trumbore is not watertight: rounding lets it accept a ray that passes
just outside a face, so a box that holds the face exactly can still be
missed by a ray the face test accepts (a ray with a zero direction component
in the plane of a ring of vertices does this). Both sides therefore grow
every box they prune with: the kernels by `PAD` * (the ray's largest
|origin component| + the scene's largest |coordinate|, node 0's copy), the
twins' cull by the same pad taken at the launch's farthest origin and the
cluster boxes' largest |coordinate|. misaki_tpu grows no box,
so on such rays it can miss a face the port finds, a t an ulp or so nearer.
"""

import ctypes

import numpy as np
import torch

from misaki_tpu_torch.scene.types import ClusterAccel
from misaki_tpu_torch.utils import cuda_build

CLUSTER_FACES = 128   # faces per cluster (B)
LEAF_FACES = 4        # faces per BVH2 leaf (at most 7: the leaf ref's count bits)
STACK_DEPTH = 64      # stack entries per thread; the launchers refuse a larger need
PAD = 2.0 ** -14      # box growth per unit of origin and scene reach; passed to the kernels
R_TILE = 256          # rays per tile of the plain walk; packed rays are a multiple
MAX_VISITS = 128      # visit-list cap per tile; overflow -> full scan
_BIG = 3.0e38

# Launch counts of the CUDA kernels. Each wrapper adds one where it
# launches its kernel, and nowhere else.
closest_launches = 0
anyhit_launches = 0

SRC = cuda_build.CSRC / "cluster.cu"


def _split(idx, cen, target):
    """The split rule of both levels: order `idx` along the largest extent
    of its centroids and cut at the `target`-multiple nearest the median."""
    c = cen[idx]
    ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
    o = np.argsort(c[:, ax], kind="stable")
    mid = int(round(len(idx) / 2 / target)) * target
    mid = min(max(mid, target), len(idx) - 1)
    return idx[o[:mid]], idx[o[mid:]]


def build_clusters(p0, e1, e2, target=CLUSTER_FACES, face_tab=None):
    """Host-side build. The cluster tables are misaki_tpu's: recursive
    largest-extent splits, each at the `target`-multiple nearest the median,
    so every cluster but one ragged tail per chain holds exactly `target`
    faces (the `balanced` packer of misaki_tpu.accel.cluster.build_clusters,
    with the same output). The recursion is kept as the top of the BVH2."""
    F = len(p0)
    v0 = np.asarray(p0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    v1, v2 = v0 + e1, v0 + e2
    tri_lo = np.minimum(np.minimum(v0, v1), v2)
    tri_hi = np.maximum(np.maximum(v0, v1), v2)
    cen = 0.5 * (tri_lo + tri_hi)

    clusters = []

    def split(idx):
        """Cluster tree of `idx`: a cluster id, or a (left, right) pair."""
        if len(idx) <= target:
            clusters.append(idx)
            return len(clusters) - 1
        left, right = _split(idx, cen, target)
        return split(left), split(right)

    tree = split(np.arange(F))

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
        if n == 0:        # no faces at all: one empty cluster, a padded box
            continue
        tri[ci, :n, 0:3] = v0[idx]
        tri[ci, :n, 3:6] = e1[idx]
        tri[ci, :n, 6:9] = e2[idx]
        tri[ci, :n, 9] = idx.astype(np.float32)   # exact to 2^24 faces
        if face_tab is not None:
            tab[ci, :, :n] = np.asarray(face_tab)[:, idx]
        bounds[0:3, ci] = tri_lo[idx].min(axis=0)
        bounds[3:6, ci] = tri_hi[idx].max(axis=0)
    nodes, leaf_tri = build_bvh(tri, tree)
    return ClusterAccel(bounds=bounds, tri=tri, tab=tab, nodes=nodes, leaf_tri=leaf_tri,
                        n_clusters=C)


def _round_out(x, toward):
    """float64 -> float32, rounded toward `toward` (+-inf) where inexact."""
    y = x.astype(np.float32)
    off = y < x if toward > 0 else y > x
    return np.where(off, np.nextafter(y, np.float32(toward)), y)


def build_bvh(tri, tree):
    """The BVH2 over a (C, B, 10) cluster table. `tree` (a cluster id, or a
    (left, right) pair of trees) gives the top levels; inside each cluster
    the split rule of `build_clusters` goes on down to leaves of at most
    `LEAF_FACES` faces. Boxes are computed in float64 from the float32 faces
    and rounded outward to float32. Returns numpy (nodes (N, 16) float32,
    leaf_tri (F, 12) float32) in the layout of `ClusterAccel`; node 0 is the
    root and always an inner node, and its column 14 holds the largest
    |coordinate| of any vertex (rounded up), the scale of the kernels'
    spatial pad."""
    C, B, _ = tri.shape
    t64 = tri.reshape(C * B, 10).astype(np.float64)
    v0 = t64[:, 0:3]
    v1, v2 = v0 + t64[:, 3:6], v0 + t64[:, 6:9]
    f_lo = np.minimum(np.minimum(v0, v1), v2)      # by flat (cluster, slot) id
    f_hi = np.maximum(np.maximum(v0, v1), v2)
    cen = 0.5 * (f_lo + f_hi)
    live = tri[:, :, 9].reshape(-1) >= 0.0
    empty_box = (np.full(3, np.inf), np.full(3, -np.inf))
    children = []      # per inner node: its two children (ref, lo, hi)
    leaf_ids = []      # flat (cluster, slot) ids of the faces in leaf order
    depth = 0

    def leaf(ids):
        start = len(leaf_ids)
        leaf_ids.extend(ids.tolist())
        lo, hi = (f_lo[ids].min(axis=0), f_hi[ids].max(axis=0)) if len(ids) else empty_box
        return ~(start * 8 + len(ids)), lo, hi

    def inner(level, make_left, make_right):
        nonlocal depth
        depth = max(depth, level + 1)
        i = len(children)
        children.append(None)
        a, b = make_left(), make_right()
        children[i] = (a, b)
        return i, np.minimum(a[1], b[1]), np.maximum(a[2], b[2])

    def faces(ids, level):
        if len(ids) <= LEAF_FACES:
            return leaf(ids)
        left, right = _split(ids, cen, LEAF_FACES)
        return inner(level, lambda: faces(left, level + 1), lambda: faces(right, level + 1))

    def top(t, level):
        if isinstance(t, tuple):
            return inner(level, lambda: top(t[0], level + 1), lambda: top(t[1], level + 1))
        return faces(t * B + np.nonzero(live[t * B:(t + 1) * B])[0], level)

    root = top(tree, 0)
    if root[0] < 0:                     # one leaf: the root holds it beside an empty child
        children, depth = [(root, leaf(np.zeros(0, np.int64)))], 1
    if depth > STACK_DEPTH:
        raise ValueError(f"BVH depth {depth} exceeds the kernels' stack of {STACK_DEPTH}")

    N = len(children)
    ref = np.array([[a[0], b[0]] for a, b in children], np.int64).reshape(N, 2)
    lo = np.array([[a[1], b[1]] for a, b in children], np.float64).reshape(N, 2, 3)
    hi = np.array([[a[2], b[2]] for a, b in children], np.float64).reshape(N, 2, 3)
    lo32, hi32 = _round_out(lo, -np.inf), _round_out(hi, np.inf)
    empty = ~(lo <= hi).all(axis=2)
    lo32[empty] = np.inf                # a +inf box: every ray misses it
    hi32[empty] = np.inf
    nodes = np.zeros((N, 16), np.float32)
    for k in range(2):
        nodes[:, 4 * k + 0] = lo32[:, k, 0]
        nodes[:, 4 * k + 1] = hi32[:, k, 0]
        nodes[:, 4 * k + 2] = lo32[:, k, 1]
        nodes[:, 4 * k + 3] = hi32[:, k, 1]
        nodes[:, 8 + 2 * k] = lo32[:, k, 2]
        nodes[:, 9 + 2 * k] = hi32[:, k, 2]
    nodes.view(np.int32)[:, 12:14] = ref
    if live.any():
        reach = np.maximum(np.abs(f_lo[live]), np.abs(f_hi[live])).max()
        nodes[0, 14] = _round_out(np.array(reach), np.inf)

    order = np.asarray(leaf_ids, np.int64)
    flat = tri.reshape(C * B, 10)[order]
    leaf_tri = np.zeros((len(order), 12), np.float32)
    leaf_tri[:, 0:3] = flat[:, 0:3]
    leaf_tri[:, 3] = flat[:, 9]
    leaf_tri[:, 4:7] = flat[:, 3:6]
    leaf_tri[:, 8:11] = flat[:, 6:9]
    leaf_tri.view(np.int32)[:, 7] = order // B
    leaf_tri.view(np.int32)[:, 11] = order % B
    return nodes, leaf_tri


# ---------------------------------------------------------------------------
# ray packing and the plain twins' visit schedule
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
    """Per-tile cluster cull and front-to-back visit order of the plain walk
    (misaki_tpu.accel.cluster._cull_order with R_TILE tiles).

    rays: (8, Lp); bounds: (8, Cpad). Returns order (nt, MAX_VISITS) int32,
    keys (nt, MAX_VISITS) float32 (sorted entry distances) and count (nt,)
    int32, negative when the tile reaches more than MAX_VISITS clusters (the
    walk then scans every cluster in id order)."""
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


def scene_reach(bounds, n_clusters):
    """The largest |coordinate| of the live cluster boxes (0 when there are
    none): the twins' own measure of the scene's reach, from misaki_tpu's
    tables and not from the BVH2."""
    b = bounds[0:6, :n_clusters]
    live = b[0:3] <= b[3:6]
    return torch.where(torch.cat([live, live]), b.abs(), 0.0).amax()


def grown_bounds(rays, acc):
    """The cluster boxes (8, Cpad) grown by the kernels' pad at the farthest
    origin of `rays`, so no box is narrower than any ray's box in the kernel.
    Padded clusters stay empty."""
    pad = PAD * (rays[0:3].abs().amax() + scene_reach(acc.bounds, acc.n_clusters))
    b = acc.bounds.clone()
    b[0:3] -= pad
    b[3:6] += pad
    return b


def closest_hit_plain(rays, acc):
    """Plain twin of the closest-hit kernel: misaki_tpu's tile walk over the
    schedule of `cull_order` on the grown boxes, with the lexicographic tie
    rule. Returns out (4, Lp) rows [t (3e38 on miss), u, v, face id (-1 on
    miss)] and fd (T, Lp), the winner's face-table row (zeros on miss)."""
    tri, tab = acc.tri, acc.tab
    order, keys, count = cull_order(rays, grown_bounds(rays, acc), acc.n_clusters)
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
            # a cluster whose entry equals the committed t can still hold a tie
            open_ = full | (keys[s:e, kk] <= t_b.amax(dim=1))
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
            live = hit & (fid >= 0.0)
            tm = torch.where(live, t, _BIG)
            tmin = tm.amin(dim=1)
            sel = live & (tm <= tmin[:, None, :])
            fwin = torch.where(sel, fid, -1.0).amax(dim=1)
            sel2 = sel & (fid == fwin[:, None, :])
            um = torch.where(sel2, u, -_BIG).amax(dim=1)
            vm = torch.where(sel2, v, -_BIG).amax(dim=1)
            slot = torch.where(sel2, slots, -1).amax(dim=1)
            f_i = f_b[idx]
            take = (tmin < t_i) | ((tmin == t_i) & (fwin > f_i))
            t_b[idx] = torch.where(take, tmin, t_i)
            u_b[idx] = torch.where(take, um, u_b[idx])
            v_b[idx] = torch.where(take, vm, v_b[idx])
            f_b[idx] = torch.where(take, fwin, f_i)
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


def any_hit_plain(rays, acc):
    """Plain twin of the any-hit kernel: (Lp,) float32, 1 = occluded."""
    tri = acc.tri
    order, keys, count = cull_order(rays, grown_bounds(rays, acc), acc.n_clusters)
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
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    return cuda_build.load_library(SRC, {
        "closest_hit_launch": ([p, i64, p, p, p, i32, i32, p, p, p, f32, i32, p], i32),
        "any_hit_launch": ([p, i64, p, p, p, p, f32, i32, p], i32),
    })


def _check_inputs(rays, acc, counts):
    dev = rays.device
    tables = (("rays", rays), ("bounds", acc.bounds), ("tri", acc.tri), ("tab", acc.tab),
              ("nodes", acc.nodes), ("leaf_tri", acc.leaf_tri))
    for name, x in tables:
        if not isinstance(x, torch.Tensor) or x.device != dev:
            raise ValueError(f"{name} must be a tensor on the rays' device {dev}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Lp = rays.shape[1] if rays.dim() == 2 else 0
    if rays.shape[0] != 8 or Lp % R_TILE or Lp == 0:
        raise ValueError(f"rays must be (8, k*{R_TILE}), got {tuple(rays.shape)}")
    tri, tab = acc.tri, acc.tab
    if tri.dim() != 3 or tri.shape[2] != 10 or tri.shape[1] > CLUSTER_FACES:
        raise ValueError(f"tri must be (C, B<={CLUSTER_FACES}, 10), got {tuple(tri.shape)}")
    C, B, _ = tri.shape
    if tab.dim() != 3 or tab.shape[0] != C or tab.shape[2] != B:
        raise ValueError(f"tab must be ({C}, T, {B}), got {tuple(tab.shape)}")
    if acc.bounds.dim() != 2 or acc.bounds.shape[0] != 8 or acc.bounds.shape[1] < C:
        raise ValueError(f"bounds must be (8, Cpad>={C}), got {tuple(acc.bounds.shape)}")
    if acc.nodes.dim() != 2 or acc.nodes.shape[1] != 16 or acc.nodes.shape[0] < 1:
        raise ValueError(f"nodes must be (N>=1, 16), got {tuple(acc.nodes.shape)}")
    if acc.leaf_tri.dim() != 2 or acc.leaf_tri.shape[1] != 12:
        raise ValueError(f"leaf_tri must be (F, 12), got {tuple(acc.leaf_tri.shape)}")
    if counts is not None:
        if dev.type != "cuda":
            raise ValueError("per-ray counts come from the CUDA kernels only")
        if counts.device != dev or counts.dtype != torch.int32 or counts.shape != (2, Lp) \
                or not counts.is_contiguous():
            raise ValueError(f"counts must be a contiguous int32 (2, {Lp}) tensor on {dev}")


def _launch_args(rays, acc, counts):
    if rays.device.type != "cuda":
        raise ValueError(f"no cluster kernel for device {rays.device}")
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    return (rays.data_ptr(), rays.shape[1], acc.nodes.data_ptr(), acc.leaf_tri.data_ptr(),
            None if counts is None else counts.data_ptr(), PAD, STACK_DEPTH, stream)


def closest_hit(rays, acc, counts=None):
    """Closest hit of packed rays (8, Lp) over the accel. CPU tensors take
    the plain twin; CUDA tensors launch the kernel. `counts`, an optional
    int32 (2, Lp) CUDA tensor, receives each ray's nodes visited and faces
    tested. Returns (out (4, Lp), fd (T, Lp))."""
    global closest_launches
    _check_inputs(rays, acc, counts)
    if rays.device.type == "cpu":
        return closest_hit_plain(rays, acc)
    rays_p, Lp, nodes_p, leaf_p, counts_p, pad, stack, stream = _launch_args(rays, acc, counts)
    lib = build()
    _, T, B = acc.tab.shape
    out = torch.empty((4, Lp), dtype=torch.float32, device=rays.device)
    fd = torch.empty((T, Lp), dtype=torch.float32, device=rays.device)
    cuda_build.check_launch(lib.closest_hit_launch(
        rays_p, Lp, nodes_p, leaf_p, acc.tab.data_ptr(), T, B, out.data_ptr(), fd.data_ptr(),
        counts_p, pad, stack, stream), "closest-hit kernel")
    closest_launches += 1
    return out, fd


def any_hit(rays, acc, counts=None):
    """Occlusion of packed rays (any hit in [mint, maxt]); (Lp,) float32,
    1 = occluded. CPU tensors take the plain twin; CUDA tensors launch the
    kernel. `counts` as for `closest_hit`."""
    global anyhit_launches
    _check_inputs(rays, acc, counts)
    if rays.device.type == "cpu":
        return any_hit_plain(rays, acc)
    rays_p, Lp, nodes_p, leaf_p, counts_p, pad, stack, stream = _launch_args(rays, acc, counts)
    lib = build()
    out = torch.empty(Lp, dtype=torch.float32, device=rays.device)
    cuda_build.check_launch(lib.any_hit_launch(
        rays_p, Lp, nodes_p, leaf_p, out.data_ptr(), counts_p, pad, stack, stream),
        "any-hit kernel")
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
    out, fd = closest_hit(pack_rays(o, d, mint, maxt), acc)
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
    return any_hit(pack_rays(o, d, mint, maxt), acc)[:L] > 0.5

"""The BVH2 the CUDA cluster kernels traverse (misaki_tpu_torch.accel.cluster
build_bvh), on the CPU.

  * build invariants on the soup, cbox and the bunny stand-in: every face in
    exactly one leaf, each node's boxes containing its children's and its
    faces, the depth within the kernels' stack, and the cluster tables still
    equal to misaki_tpu's;
  * conservative pruning: the kernel's slab test, restated in the same
    float32 operations, passes at every ancestor of every face that
    Moller-Trumbore accepts at t <= the ray's closest t (and, for shadow
    rays, at t <= maxt);
  * the kernel's traversal restated ray by ray (nearer child first, pruning
    only entries beyond the best t, the lexicographic tie rule) against the
    plain twin: the same face, t and face row on every ray;
  * the tie rule on faces duplicated into other clusters.
"""

import numpy as np
import pytest
import torch

from torch_helpers import CBOX_XML, n

from misaki_tpu.accel import cluster as jcl
from misaki_tpu_torch.accel import cluster as pcl
from misaki_tpu_torch.scene import procedural
from misaki_tpu_torch.scene.compiler import load_and_compile
from misaki_tpu_torch.tools.tie_case import merge_clusters

# the slab scales of csrc/cluster.cu, and the spatial pad the launchers pass it
NEAR_SCALE = np.float32(1.0 - 2.0 ** -18)
FAR_SCALE = np.float32(1.0 + 2.0 ** -18)
PAD = np.float32(pcl.PAD)
DONE = -(2 ** 31)


def _soup_faces(F=1500, seed=7):
    rs = np.random.default_rng(seed)
    return (rs.uniform(-1, 1, (F, 3)).astype(np.float32),
            rs.uniform(-0.1, 0.1, (F, 3)).astype(np.float32),
            rs.uniform(-0.1, 0.1, (F, 3)).astype(np.float32))


def _bunny_faces():
    pos = procedural.bunny_standin()["positions"].astype(np.float64)
    return (pos[:, 0].astype(np.float32), (pos[:, 1] - pos[:, 0]).astype(np.float32),
            (pos[:, 2] - pos[:, 0]).astype(np.float32))


def _cbox_faces():
    g = load_and_compile(str(CBOX_XML), spp=1, width=8, height=8, device="cpu").geometry
    return tuple(n(x)[:, :32].T.copy() for x in (g.p0, g.e1, g.e2))


FACES = {"soup": _soup_faces, "cbox": _cbox_faces, "bunny": _bunny_faces}


def _accel(name):
    p0, e1, e2 = FACES[name]()
    tab = np.random.default_rng(3).normal(size=(4, len(p0))).astype(np.float32)
    tab[0] = np.arange(len(p0))
    return (p0, e1, e2, tab), pcl.build_clusters(p0, e1, e2, face_tab=tab)


def verts_of(leaf_tri):
    """(F, 3, 3) float64 vertices of the faces in leaf order."""
    v0 = leaf_tri[:, 0:3].astype(np.float64)
    return np.stack([v0, v0 + leaf_tri[:, 4:7], v0 + leaf_tri[:, 8:11]], axis=1)


def _refs(nodes):
    return nodes.view(np.int32)[:, 12:14]


def _child_boxes(nodes):
    """(N, 2, 3) lo and hi of each node's two children."""
    lo = np.stack([nodes[:, [0, 2, 8]], nodes[:, [4, 6, 10]]], axis=1)
    hi = np.stack([nodes[:, [1, 3, 9]], nodes[:, [5, 7, 11]]], axis=1)
    return lo, hi


def _leaf(ref):
    return (~ref) >> 3, (~ref) & 7


def _paths(nodes):
    """For each face row of leaf_tri, its ancestors as (node, child) pairs,
    and the tree's depth in inner nodes."""
    refs = _refs(nodes)
    paths, depth = {}, 0
    stack = [(0, [])]
    while stack:
        i, path = stack.pop()
        depth = max(depth, len(path) + 1)
        for k in range(2):
            p = path + [(i, k)]
            r = int(refs[i, k])
            if r >= 0:
                stack.append((r, p))
            else:
                start, count = _leaf(r)
                for f in range(start, start + count):
                    assert f not in paths, "a face in two leaves"
                    paths[f] = p
    return paths, depth


@pytest.mark.parametrize("name", ["soup", "cbox", "bunny"])
def test_bvh_build_invariants(name):
    (p0, e1, e2, tab), acc = _accel(name)
    nodes, leaf_tri = acc.nodes, acc.leaf_tri
    F = len(p0)
    # misaki_tpu's tables are unchanged
    want = jcl.build_clusters(p0, e1, e2, face_tab=tab)
    for field in ("bounds", "tri", "tab"):
        np.testing.assert_array_equal(getattr(acc, field), np.asarray(getattr(want, field)))
    # every face in exactly one leaf, carrying its (cluster, slot)
    paths, depth = _paths(nodes)
    assert sorted(paths) == list(range(F)) and leaf_tri.shape == (F, 12)
    assert sorted(leaf_tri[:, 3].astype(np.int64).tolist()) == list(range(F))
    c, s = leaf_tri.view(np.int32)[:, 7], leaf_tri.view(np.int32)[:, 11]
    row = acc.tri[c, s]
    np.testing.assert_array_equal(row[:, 0:3], leaf_tri[:, 0:3])
    np.testing.assert_array_equal(row[:, 3:6], leaf_tri[:, 4:7])
    np.testing.assert_array_equal(row[:, 6:9], leaf_tri[:, 8:11])
    np.testing.assert_array_equal(row[:, 9], leaf_tri[:, 3])
    assert depth <= pcl.STACK_DEPTH
    # node 0 carries the largest |vertex coordinate|, the scale of the pad
    assert (np.abs(verts_of(leaf_tri)) <= nodes[0, 14]).all() and (nodes[1:, 14] == 0).all()
    # and the twins' own reach, from the cluster boxes, is the same to an ulp
    reach = np.float32(pcl.scene_reach(torch.from_numpy(acc.bounds), acc.n_clusters))
    assert reach <= nodes[0, 14] <= np.nextafter(reach, np.float32(np.inf))
    # boxes contain their children's boxes and, at leaves, their faces (float64)
    lo, hi = _child_boxes(nodes)
    refs = _refs(nodes)
    verts = verts_of(leaf_tri)
    for i in range(len(nodes)):
        for k in range(2):
            r = int(refs[i, k])
            if r >= 0:
                assert (lo[i, k] <= lo[r].min(axis=0)).all()
                assert (hi[i, k] >= hi[r].max(axis=0)).all()
            else:
                start, count = _leaf(r)
                assert 1 <= count <= pcl.LEAF_FACES
                v = verts[start:start + count].reshape(-1, 3)
                assert (lo[i, k] <= v.min(axis=0)).all() and (hi[i, k] >= v.max(axis=0)).all()


def _pad(nodes, o):
    """The kernel's per-ray pad: PAD * (largest |origin component| + node
    0's largest |vertex coordinate|), in float32. o: (..., 3)."""
    return PAD * (o.abs().amax(dim=-1) + float(nodes[0, 14]))


def _slab(o, rcp, mint, lo, hi, t_hi, pad):
    """The kernel's slab test in the same float32 operations: the entry
    distance into the box grown by `pad`, or inf where the ray misses it or
    enters it past t_hi."""
    lo, hi = lo - pad[..., None], hi + pad[..., None]
    x0, x1 = (lo[..., 0] - o[..., 0]) * rcp[..., 0], (hi[..., 0] - o[..., 0]) * rcp[..., 0]
    y0, y1 = (lo[..., 1] - o[..., 1]) * rcp[..., 1], (hi[..., 1] - o[..., 1]) * rcp[..., 1]
    z0, z1 = (lo[..., 2] - o[..., 2]) * rcp[..., 2], (hi[..., 2] - o[..., 2]) * rcp[..., 2]
    near = torch.maximum(torch.maximum(torch.minimum(x0, x1), torch.minimum(y0, y1)),
                         torch.minimum(z0, z1)) * float(NEAR_SCALE)
    far = torch.minimum(torch.minimum(torch.maximum(x0, x1), torch.maximum(y0, y1)),
                        torch.maximum(z0, z1)) * float(FAR_SCALE)
    tn = torch.maximum(near, mint)
    return torch.where(tn <= torch.minimum(far, t_hi), tn, torch.inf)


def _rays(acc, L, seed):
    """Rays from around the faces' box: half aimed at a random face's
    centroid (jittered), half in random directions."""
    rs = np.random.default_rng(seed)
    lt = acc.leaf_tri
    lo, hi = lt[:, 0:3].min(axis=0), lt[:, 0:3].max(axis=0)
    ext = hi - lo
    o = rs.uniform(lo - 0.5 * ext, hi + 0.5 * ext, (L, 3))
    f = rs.integers(0, len(lt), L)
    tgt = lt[f, 0:3] + (lt[f, 4:7] + lt[f, 8:11]) / 3 + rs.normal(0, 0.01, (L, 3)) * ext
    d = np.where(np.arange(L)[:, None] % 2 == 0, tgt - o, rs.normal(size=(L, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o.T.astype(np.float32)), torch.from_numpy(d.T.astype(np.float32))


@pytest.mark.parametrize("name", ["soup", "bunny"])
def test_slab_test_is_conservative(name):
    _, acc = _accel(name)
    acc_t = acc.to("cpu")
    L = 512
    o, d = _rays(acc, L, 11)
    mint = torch.full((L,), 1e-4)
    rays = pcl.pack_rays(tuple(o), tuple(d), mint, torch.full((L,), np.inf))
    t_best = pcl.closest_hit(rays, acc_t)[0][0]
    reach = 2.0 * float((o.amax(dim=1) - o.amin(dim=1)).max())
    maxt_occ = torch.from_numpy(np.random.default_rng(5).uniform(0, reach, L).astype(np.float32))
    blk = torch.from_numpy(np.concatenate([acc.leaf_tri[:, 0:3], acc.leaf_tri[:, 4:7],
                                           acc.leaf_tri[:, 8:11], acc.leaf_tri[:, 3:4]], 1))
    paths, _ = _paths(acc.nodes)
    lo, hi = (torch.from_numpy(x) for x in _child_boxes(acc.nodes))
    rcp = pcl._safe_rcp(d)
    checked = 0
    for t_cap, what in ((t_best, "closest"), (maxt_occ, "shadow")):
        r = pcl.pack_rays(tuple(o), tuple(d), mint, t_cap)[:, None, :L]
        t, _, _, hit = pcl._mt(r, blk[None], t_cap[None])
        ray_i, face_i = (x.tolist() for x in hit[0].T.nonzero(as_tuple=True))
        anc = [paths[f] for f in face_i]
        rr = torch.tensor([i for i, p in zip(ray_i, anc) for _ in p])
        nk = torch.tensor([nk for p in anc for nk in p]).reshape(-1, 2)
        got = _slab(o.T[rr], rcp.T[rr], mint[rr], lo[nk[:, 0], nk[:, 1]], hi[nk[:, 0], nk[:, 1]],
                    t_cap[rr], _pad(acc.nodes, o.T[rr]))
        assert torch.isfinite(got).all(), f"{what}: a face that Moller-Trumbore accepts was pruned"
        checked += len(ray_i)
    assert checked > 100


def _traverse(acc, ray, any_hit):
    """csrc/cluster.cu's traverse() for one ray, in float32 scalars."""
    f32 = np.float32
    nodes, refs, lt = acc.nodes, _refs(acc.nodes), acc.leaf_tri
    ox, oy, oz, dx, dy, dz, mint, maxt = (f32(x) for x in ray)

    def rcp(c):
        return f32(1.0) / (c if abs(c) >= f32(1e-20) else f32(-1e-20) if c < 0 else f32(1e-20))

    rx, ry, rz = rcp(dx), rcp(dy), rcp(dz)
    pad = PAD * (max(max(abs(ox), abs(oy)), abs(oz)) + nodes[0, 14])

    def slab(lx, hx, ly, hy, lz, hz, t_hi):
        x0, x1 = (lx - pad - ox) * rx, (hx + pad - ox) * rx
        y0, y1 = (ly - pad - oy) * ry, (hy + pad - oy) * ry
        z0, z1 = (lz - pad - oz) * rz, (hz + pad - oz) * rz
        near = max(max(min(x0, x1), min(y0, y1)), min(z0, z1)) * NEAR_SCALE
        far = min(min(max(x0, x1), max(y0, y1)), max(z0, z1)) * FAR_SCALE
        tn = max(near, mint)
        return tn if tn <= min(far, t_hi) else f32(np.inf)

    def mt(i, t_cap):
        p0x, p0y, p0z = lt[i, 0:3]
        e1x, e1y, e1z = lt[i, 4:7]
        e2x, e2y, e2z = lt[i, 8:11]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv_det = f32(1.0) / (f32(1e-12) if abs(det) < f32(1e-12) else det)
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        ok = (abs(det) > f32(1e-12) and u >= 0 and v >= 0 and u + v <= 1 and t >= mint
              and t <= t_cap)
        return ok, t, u, v

    best_t = maxt if any_hit else min(maxt, f32(3e38))
    t_hi = min(best_t, f32(3e38))
    fid, face, u_b, v_b = f32(-1), -1, f32(0), f32(0)
    stack = []

    def pop():
        while stack:
            r, t = stack.pop()
            if t <= best_t:
                return r
        return DONE

    ref = 0
    while ref != DONE:
        while ref >= 0:
            nd = nodes[ref]
            lim = t_hi if any_hit else best_t
            t0 = slab(nd[0], nd[1], nd[2], nd[3], nd[8], nd[9], lim)
            t1 = slab(nd[4], nd[5], nd[6], nd[7], nd[10], nd[11], lim)
            l0, l1 = int(refs[ref, 0]), int(refs[ref, 1])
            if t0 <= lim and t1 <= lim:
                stack.append((l1, t1) if t0 <= t1 else (l0, t0))
                ref = l0 if t0 <= t1 else l1
            elif t0 <= lim or t1 <= lim:
                ref = l0 if t0 <= lim else l1
            else:
                ref = pop()
        while ref < 0 and ref != DONE:
            start, count = _leaf(ref)
            for i in range(start, start + count):
                ok, t, u, v = mt(i, maxt if any_hit else best_t)
                if not ok:
                    continue
                if any_hit:
                    return 1.0
                if t < best_t or (t == best_t and lt[i, 3] > fid):
                    best_t, u_b, v_b, fid, face = t, u, v, lt[i, 3], i
            ref = pop()
    if any_hit:
        return 0.0
    return (best_t if face >= 0 else f32(3e38)), u_b, v_b, fid, face


def _plane_rays(acc, L):
    """Camera-like rays from 3 extents in front of the faces' box, fanned
    across its width in the plane through its centre with d_y = 0 exactly.
    On the bunny stand-in that plane holds a ring of vertices, so the rays
    run along shared edges, where Moller-Trumbore accepts faces whose exact
    boxes the rays miss."""
    lt = acc.leaf_tri
    v0 = lt[:, 0:3]
    verts = np.concatenate([v0, v0 + lt[:, 4:7], v0 + lt[:, 8:11]])
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    c, ext = (0.5 * (lo + hi)).astype(np.float32), np.float32((hi - lo).max())
    u = np.arange(L, dtype=np.float32) / np.float32(L) - np.float32(0.5)
    eye = c + np.float32(-3.0) * ext * np.array([0, 0, 1], np.float32)
    d = np.stack([c[0] + u * np.float32(1.2) * ext, np.full(L, c[1]), np.full(L, c[2])]) - eye[:, None]
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (torch.from_numpy(np.repeat(eye[:, None], L, axis=1)),
            torch.from_numpy(d.astype(np.float32)))


@pytest.mark.parametrize("name", ["soup", "bunny", "bunny_dup", "bunny_plane"])
def test_traversal_restated_matches_twin(name):
    """Closest hit and occlusion, ray by ray. Shadow rays end at 0.3 of the
    origins' spread; on the plane fan (one origin) every other one ends at
    the ray's closest hit, the rest halfway to it."""
    _, acc = _accel(name.split("_")[0])
    if name.endswith("_dup"):
        acc = merge_clusters(acc, acc)
    plane = name.endswith("_plane")
    o, d = _plane_rays(acc, 1024) if plane else _rays(acc, 96, 3)
    L = o.shape[1]
    mint = torch.full((L,), 1e-4)
    rays = pcl.pack_rays(tuple(o), tuple(d), mint, torch.full((L,), np.inf))
    out, fd = pcl.closest_hit(rays, acc.to("cpu"))
    if plane:
        t_hit = out[0, :L].clamp(max=10.0)
        smaxt = torch.where(torch.arange(L) % 2 == 0, t_hit, 0.5 * t_hit)
    else:
        smaxt = torch.full((L,), 0.3 * float((o.amax(dim=1) - o.amin(dim=1)).max()))
    srays = pcl.pack_rays(tuple(o), tuple(d), mint, smaxt)
    occ = pcl.any_hit(srays, acc.to("cpu"))
    hits = 0
    for i in range(L):
        t, u, v, fid, face = _traverse(acc, n(rays[:, i]), False)
        assert (t, u, v, fid) == tuple(n(out[:, i]).tolist()), i
        if face >= 0:
            hits += 1
            c, s = acc.leaf_tri.view(np.int32)[face, [7, 11]]
            np.testing.assert_array_equal(acc.tab[c, :, s], n(fd[:, i]))
        assert _traverse(acc, n(srays[:, i]), True) == float(occ[i])
    assert hits > 10 and 0 < occ.sum() < L


@pytest.mark.parametrize("name", ["bunny", "cbox", "soup"])
def test_twin_is_the_exact_closest_hit(name):
    """On the plane fan, whose rays graze shared edges, the twin (its cull on
    the grown boxes) equals the lexicographic closest hit over every face by
    brute force: smallest t, then largest face id."""
    _, acc = _accel(name)
    o, d = _plane_rays(acc, 1024)
    L = o.shape[1]
    rays = pcl.pack_rays(tuple(o), tuple(d), torch.full((L,), 1e-4), torch.full((L,), np.inf))
    out, _ = pcl.closest_hit(rays, acc.to("cpu"))
    blk = torch.from_numpy(acc.tri).reshape(1, -1, 10)
    t, _, _, hit = pcl._mt(rays[:, None, :L], blk, torch.full((1, L), 3e38))
    live = hit & (blk[:, :, 9:10] >= 0)
    tm = torch.where(live, t, 3e38)
    t_min = tm.amin(dim=1)[0]
    f_max = torch.where(live & (tm <= t_min), blk[:, :, 9:10], -1.0).amax(dim=1)[0]
    assert (f_max >= 0).sum() > 50
    assert torch.equal(out[3, :L], f_max)
    assert torch.equal(out[0, :L], torch.where(f_max >= 0, t_min, 3e38))


@pytest.mark.parametrize("name", ["soup", "cbox"])
def test_tie_rule_larger_face_id_wins(name):
    """Every face duplicated into a second set of clusters: each hit is an
    exact tie across clusters, and the copy (the larger id) must win."""
    (p0, _, _, _), acc = _accel(name)
    F = len(p0)
    dup = merge_clusters(acc, acc)
    L = 600
    o, d = _rays(acc, L, 5)
    mint = torch.full((L,), 1e-4)
    rays = pcl.pack_rays(tuple(o), tuple(d), mint, torch.full((L,), np.inf))
    once, fd_once = pcl.closest_hit(rays, acc.to("cpu"))
    twice, fd = pcl.closest_hit(rays, dup.to("cpu"))
    hit = once[3] >= 0
    assert hit.sum() > 30
    assert torch.equal(twice[3][hit], once[3][hit] + F)
    assert torch.equal(twice[0], once[0]) and torch.equal(twice[3][~hit], once[3][~hit])
    assert torch.equal(fd, fd_once)


def test_empty_accel_misses():
    z = np.zeros((0, 3), np.float32)
    acc = pcl.build_clusters(z, z, z, face_tab=np.zeros((4, 0), np.float32))
    assert acc.n_clusters == 1 and acc.leaf_tri.shape == (0, 12) and len(acc.nodes) == 1
    assert np.isinf(acc.nodes[0, :12]).all()
    o, d = _rays(_accel("soup")[1], 300, 1)
    rays = pcl.pack_rays(tuple(o), tuple(d), torch.zeros(300), torch.full((300,), np.inf))
    out, fd = pcl.closest_hit(rays, acc.to("cpu"))
    assert (out[3] == -1).all() and (out[0] == 3e38).all() and (fd == 0).all()
    assert (out[1:3] == 0).all() and (pcl.any_hit(rays, acc.to("cpu")) == 0).all()
    for i in range(0, 300, 50):
        assert _traverse(acc, n(rays[:, i]), False)[3] == -1

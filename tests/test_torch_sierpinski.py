"""The `sierpinski` shape (scene/procedural.py, scene/compiler.py) and the
closest-hit kernel's traversal counters (`cast.closest.nodes`,
`cast.closest.faces`).

On the CPU: the generator's face count, area and winding at every level;
the shape's compile against the same triangles written to an OBJ and loaded
through the `obj` route, in the port and in misaki_tpu; the plain twins'
casts over the benchmark's cbox-sierpinski scene, cut to level 4, against a
brute-force cast in float64. The cases marked `cuda` hold the kernel's
counters to a plain per-ray walk of the same BVH2 and skip where no card is
present; on a card:

    python -m pytest tests/test_torch_sierpinski.py -q --noconftest -m cuda

(this file imports misaki_tpu, and with it JAX, only inside the test that
needs it).
"""

import numpy as np
import pytest
import torch

from torch_helpers import REPO, n

from misaki_tpu_torch.accel import cluster as cl
from misaki_tpu_torch.scene import procedural
from misaki_tpu_torch.scene.compiler import compile_scene, load_and_compile
from misaki_tpu_torch.scene.loader import load_string
from misaki_tpu_torch.utils import tracing

SCENE_XML = REPO / "benchmark" / "configs" / "scenes" / "cbox-sierpinski" / "scene.xml"
LEVEL_9 = '<integer name="level" value="9"/>'


def scene_text(level):
    """The benchmark's cbox-sierpinski XML at `level`."""
    text = SCENE_XML.read_text()
    assert LEVEL_9 in text
    return text.replace(LEVEL_9, f'<integer name="level" value="{level}"/>')


def compiled(level, device="cpu", **kw):
    kw = {"spp": 1, "width": 8, "height": 8, "max_depth": 5, **kw}
    return compile_scene(load_string(scene_text(level), base_dir=str(SCENE_XML.parent)),
                         device=device, **kw)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", range(6))
def test_face_count_area_and_winding(level):
    """4^(n+1) faces; the total area of every level is the base's, sqrt(3)
    for edge 1 (each level halves the edges of four copies); every face's
    e1 x e2 points away from its tetrahedron's centroid."""
    tets = procedural.sierpinski_tetrahedra(level)
    tris = tets[:, procedural.TETRA_FACES].reshape(-1, 3, 3)
    assert len(tris) == 4 ** (level + 1) == len(procedural.sierpinski(level)["positions"])
    cross = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    assert 0.5 * np.linalg.norm(cross, axis=1).sum() == pytest.approx(np.sqrt(3.0), rel=1e-12)
    centroid = np.repeat(tets.mean(axis=1), 4, axis=0)
    assert ((cross * (tris[:, 0] - centroid)).sum(axis=1) > 0.0).all()


@pytest.mark.parametrize("level", [-1, 11])
def test_a_level_out_of_range_raises(level):
    with pytest.raises(ValueError, match="level"):
        procedural.sierpinski(level)


def test_a_shape_without_a_level_raises():
    text = scene_text(2).replace('<integer name="level" value="2"/>', "")
    with pytest.raises(ValueError, match="level"):
        compile_scene(load_string(text, base_dir=str(SCENE_XML.parent)), device="cpu")


def _obj_route(tmp_path, level):
    """The scene's XML with the tetrahedron as an OBJ file of the same
    vertices (before `to_world`, every digit of float64) under the same
    `to_world`."""
    tets = procedural.sierpinski_tetrahedra(level)
    tris = tets[:, procedural.TETRA_FACES].reshape(-1, 3)
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in tris.tolist()]
    lines += [f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}" for i in range(len(tris) // 3)]
    (tmp_path / "tetra.obj").write_text("\n".join(lines) + "\n")
    text = scene_text(level).replace('<shape type="sierpinski">', '<shape type="obj">').replace(
        f'<integer name="level" value="{level}"/>',
        f'<string name="filename" value="{tmp_path / "tetra.obj"}"/>')
    xml = tmp_path / "scene.xml"
    xml.write_text(text)
    return xml


TABLES = [("geometry", "p0"), ("geometry", "e1"), ("geometry", "e2"), ("geometry", "face_tab"),
          ("emitters", "face_pack"), ("emitters", "bsphere_center"),
          ("emitters", "bsphere_radius"), ("cluster", "bounds"), ("cluster", "tri"),
          ("cluster", "tab"), ("cluster", "nodes"), ("cluster", "leaf_tri")]


def test_the_shape_compiles_as_its_obj_does(tmp_path):
    """Level 3: the `sierpinski` shape and an OBJ of its vertices under the
    same transform give the same tables, the BVH2 included."""
    got = compiled(3)
    want = load_and_compile(str(_obj_route(tmp_path, 3)), device="cpu", spp=1, width=8,
                            height=8, max_depth=5)
    assert got.n_faces == want.n_faces == 12 + 4 ** 4
    for group, name in TABLES:
        np.testing.assert_array_equal(n(getattr(getattr(got, group), name)),
                                      n(getattr(getattr(want, group), name)), err_msg=name)


def test_misaki_tpu_loads_the_same_obj_to_the_same_tables(tmp_path):
    """misaki_tpu has no `sierpinski` shape; on the route it has, the OBJ,
    it compiles the geometry and emitter tables the port's shape gives."""
    import jax

    from misaki_tpu.scene.compiler import load_and_compile as jload

    js = jax.tree_util.tree_map(np.asarray, jload(str(_obj_route(tmp_path, 3)), spp=1, width=8,
                                                  height=8, max_depth=5))
    ps = compiled(3)
    for group, name in TABLES[:7]:
        np.testing.assert_array_equal(n(getattr(getattr(ps, group), name)),
                                      np.asarray(getattr(getattr(js, group), name)),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# the casts against a brute-force cast
# ---------------------------------------------------------------------------

def _brute_force(geom, F, o, d, mint, maxt):
    """Every ray against every face in float64 Moller-Trumbore: -> (t of the
    nearest hit in [mint, maxt] (inf on a miss), its face (-1 on a miss),
    the gap to the next face's t (inf on a miss), whether the ray passes
    within 1e-5 (barycentric) of any face's edge)."""
    p0, e1, e2 = (np.asarray(n(x), np.float64)[:, :F].T for x in (geom.p0, geom.e1, geom.e2))
    o, d = o.double().numpy(), d.double().numpy()
    pv = np.cross(d[:, None, :], e2[None])
    det = (e1[None] * pv).sum(-1)
    tv = o[:, None, :] - p0[None]
    u = (tv * pv).sum(-1) / det
    qv = np.cross(tv, e1[None])
    v = (d[:, None, :] * qv).sum(-1) / det
    t = (e2[None] * qv).sum(-1) / det
    inside = (u >= 0) & (v >= 0) & (u + v <= 1)
    hit = inside & (t >= mint.numpy()[:, None]) & (t <= maxt.numpy()[:, None])
    th = np.where(hit, t, np.inf)
    order = np.sort(th, axis=1)
    eps = 1e-5
    near = (u >= -eps) & (v >= -eps) & (u + v <= 1 + eps)
    edge = ((t >= mint.numpy()[:, None]) & (t <= maxt.numpy()[:, None]) & near
            & (np.minimum(np.minimum(np.abs(u), np.abs(v)), np.abs(1 - u - v)) < eps))
    with np.errstate(invalid="ignore"):
        gap = np.where(np.isfinite(order[:, 0]), order[:, 1] - order[:, 0], np.inf)
    face = np.where(np.isfinite(order[:, 0]), th.argmin(axis=1), -1)
    return order[:, 0], face, gap, edge.any(axis=1)


def test_plain_casts_agree_with_a_brute_force_cast():
    """Level 4 in the box (1,036 faces), 2,048 rays from random points of the
    box in random directions: `closest_hit_plain` finds the brute force's
    face and t on every ray no edge or near tie makes ambiguous, and
    `any_hit_plain` (maxt at half the distance) its occlusion."""
    scene = compiled(4)
    F = scene.n_faces
    g = torch.Generator().manual_seed(9)
    L = 2048
    o = torch.tensor([20.0, 1.0, 20.0]) + torch.rand((L, 3), generator=g) * torch.tensor(
        [510.0, 500.0, 520.0])
    d = torch.nn.functional.normalize(torch.randn((L, 3), generator=g), dim=1)
    mint = torch.full((L,), 1e-3)
    t_bf, f_bf, gap, edge = _brute_force(scene.geometry, F, o, d, mint, torch.full((L,), 1e30))
    rays = cl.pack_rays(tuple(o.T), tuple(d.T), mint, torch.full((L,), torch.inf))
    out, _ = cl.closest_hit_plain(rays, scene.cluster)
    t_p, f_p = out[0, :L].double().numpy(), out[3, :L].numpy().astype(np.int64)
    clear = ~edge & (gap > 1e-3 * np.minimum(t_bf, 1e3))
    assert clear.mean() > 0.95 and np.isfinite(t_bf[clear]).mean() > 0.8
    assert (f_p[clear] == f_bf[clear]).all()
    hit = clear & np.isfinite(t_bf)
    np.testing.assert_allclose(t_p[hit], t_bf[hit], rtol=1e-4)
    tetra = clear & (f_bf >= 12)
    assert tetra.sum() > 100

    half = torch.tensor(np.where(np.isfinite(t_bf), 0.5 * t_bf, 1e3), dtype=torch.float32)
    far = torch.tensor(np.where(np.isfinite(t_bf), 2.0 * t_bf, 1e3), dtype=torch.float32)
    for maxt, want in ((half, False), (far, True)):
        occ = cl.any_hit_plain(cl.pack_rays(tuple(o.T), tuple(d.T), mint, maxt), scene.cluster)
        got = occ[:L].numpy() > 0.5
        sure = clear & np.isfinite(t_bf)
        assert (got[sure] == want).all()


# ---------------------------------------------------------------------------
# on the card: the traversal counters
# ---------------------------------------------------------------------------

_F = np.float32
_NEAR = _F(1.0 - 1.0 / 262144.0)
_FAR = _F(1.0 + 1.0 / 262144.0)
_BIG = _F(3.0e38)
_DONE = -(2 ** 31)


def _rcp(c):
    tiny = _F(1e-20)
    return _F(1.0) / ((-tiny if c < 0 else tiny) if abs(c) < tiny else c)


def _mt(r, fa, fb, fc, t_cap):
    """csrc/cluster.cu mt() in float32, operation for operation."""
    ox, oy, oz, dx, dy, dz, mint = r[:7]
    p0x, p0y, p0z = fa[:3]
    e1x, e1y, e1z = fb[:3]
    e2x, e2y, e2z = fc[:3]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = _F(1.0) / (_F(1e-12) if abs(det) < _F(1e-12) else det)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    ok = abs(det) > _F(1e-12) and u >= 0 and v >= 0 and u + v <= 1 and mint <= t <= t_cap
    return ok, t


def plain_walk(nodes, leaf_tri, ray):
    """(inner nodes, faces) one closest-hit ray visits in csrc/cluster.cu's
    walk, taken in float32 in Python: both children slab-tested against
    the box grown by the ray's pad, the nearer first, the other pushed with
    its entry; a child or a popped entry pruned only beyond the best t; the
    lexicographic closest hit."""
    r = [_F(x) for x in ray]
    ox, oy, oz, dx, dy, dz, mint, maxt = r
    rx, ry, rz = _rcp(dx), _rcp(dy), _rcp(dz)
    pad = _F(cl.PAD) * (max(max(abs(ox), abs(oy)), abs(oz)) + nodes[0, 14])
    refs = nodes.view(np.int32)

    def slab(lox, hix, loy, hiy, loz, hiz, t_hi):
        x0, x1 = (lox - pad - ox) * rx, (hix + pad - ox) * rx
        y0, y1 = (loy - pad - oy) * ry, (hiy + pad - oy) * ry
        z0, z1 = (loz - pad - oz) * rz, (hiz + pad - oz) * rz
        near = max(max(min(x0, x1), min(y0, y1)), min(z0, z1)) * _NEAR
        far = min(min(max(x0, x1), max(y0, y1)), max(z0, z1)) * _FAR
        tn = max(near, mint)
        return tn if tn <= min(far, t_hi) else _F(np.inf)

    best_t, best_f = min(maxt, _BIG), _F(-1.0)
    stack, ref, n_nodes, n_faces = [], 0, 0, 0

    def pop():
        while stack:
            nxt, t = stack.pop()
            if t <= best_t:
                return nxt
        return _DONE

    while ref != _DONE:
        while ref >= 0:
            nd = nodes[ref]
            n_nodes += 1
            t0 = slab(nd[0], nd[1], nd[2], nd[3], nd[8], nd[9], best_t)
            t1 = slab(nd[4], nd[5], nd[6], nd[7], nd[10], nd[11], best_t)
            h0, h1 = t0 <= best_t, t1 <= best_t
            c0, c1 = int(refs[ref, 12]), int(refs[ref, 13])
            if h0 and h1:
                first0 = t0 <= t1
                stack.append((c1, t1) if first0 else (c0, t0))
                ref = c0 if first0 else c1
            elif h0 or h1:
                ref = c0 if h0 else c1
            else:
                ref = pop()
        while ref < 0 and ref != _DONE:
            start, count = (~ref) >> 3, (~ref) & 7
            for i in range(start, start + count):
                fa, fb, fc = leaf_tri[i, 0:4], leaf_tri[i, 4:8], leaf_tri[i, 8:12]
                n_faces += 1
                ok, t = _mt(r, fa, fb, fc, best_t)
                if ok and (t < best_t or (t == best_t and fa[3] > best_f)):
                    best_t, best_f = t, fa[3]
            ref = pop()
    return n_nodes, n_faces


def _card_rays(L=1024):
    """Rays from random points of the box in random directions, a quarter of
    them dead (maxt -1 < mint 0), packed on the card."""
    g = torch.Generator().manual_seed(3)
    o = torch.tensor([20.0, 1.0, 20.0]) + torch.rand((L, 3), generator=g) * torch.tensor(
        [510.0, 500.0, 520.0])
    d = torch.nn.functional.normalize(torch.randn((L, 3), generator=g), dim=1)
    dead = torch.rand(L, generator=g) < 0.25
    mint = torch.where(dead, 0.0, 1e-3)
    maxt = torch.where(dead, -1.0, torch.inf)
    return cl.pack_rays(tuple(o.T.cuda()), tuple(d.T.cuda()), mint.cuda(), maxt.cuda())


@pytest.mark.cuda
def test_the_walk_counters_equal_a_plain_walk():
    """Level 2 in the box (76 faces): each ray's nodes and faces (the
    kernel's `counts` output) equal the plain walk's, and a traced launch
    adds those of the live rays to `cast.closest.nodes` and
    `cast.closest.faces`, and those rays to `cast.closest.live`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    scene = compiled(2, device="cuda")
    acc = scene.cluster
    rays = _card_rays()
    Lp = rays.shape[1]
    counts = torch.full((2, Lp), -1, dtype=torch.int32, device="cuda")
    tracing.read()          # a look with no profiler running: the next session counts anew
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        cl.closest_hit(rays, acc, counts)
        c = tracing.read()
    host = rays.cpu().numpy().T
    nodes, leaf_tri = acc.nodes.cpu().numpy(), acc.leaf_tri.cpu().numpy()
    want = np.array([plain_walk(nodes, leaf_tri, ray) for ray in host]).T
    np.testing.assert_array_equal(counts.cpu().numpy(), want)
    live = host[:, 7] >= host[:, 6]
    assert c[tracing.CAST_LIVE] == int(live.sum()) > 0
    assert c[tracing.CAST_NODES] == int(want[0][live].sum()) > c[tracing.CAST_LIVE]
    assert c[tracing.CAST_FACES] == int(want[1][live].sum()) > 0


@pytest.mark.cuda
def test_the_walk_counters_count_only_when_asked():
    """Untraced, the counters stay as the last session left them and the
    launch count moves by one; under a recording the graph's own slots take
    the same counts as a traced launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    acc = compiled(2, device="cuda").cluster
    rays = _card_rays()
    tracing.read()          # a look with no profiler running: the next session counts anew
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        cl.closest_hit(rays, acc)
    traced = tracing.read()
    launched = tracing.launches["closest"]
    out, _ = cl.closest_hit(rays, acc)
    torch.cuda.synchronize()
    assert tracing.read() == traced and tracing.launches["closest"] == launched + 1
    slots = torch.zeros(len(tracing.DEVICE_COUNTERS), dtype=torch.int64, device="cuda")
    with tracing.recording(slots):
        again, _ = cl.closest_hit(rays, acc)
    got = dict(zip(tracing.DEVICE_COUNTERS, slots.cpu().tolist()))
    for name in (tracing.CAST_LIVE, tracing.CAST_NODES, tracing.CAST_FACES):
        assert got[name] == traced[name] > 0, name
    assert torch.equal(out, again)

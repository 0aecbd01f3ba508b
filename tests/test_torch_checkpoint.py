"""The port's render snapshots (`render/checkpoint.py`) on the CPU, for both
kinds a render writes: the path film (`driver.render`: `film_flat`,
`next_chunk`) and the photon-mapping state (`ppm.render_ppm`: the
per-pixel state and `next_it`). Each kind's snapshot is taken from a real
render stopped by its progress callback."""

import logging
import os

import numpy as np
import pytest

from torch_helpers import CBOX_XML, SCENES

from misaki_tpu_torch.render import checkpoint, driver
from misaki_tpu_torch.scene.compiler import load_and_compile

KINDS = ("path", "ppm")
CHUNK = 32 * 4 * 6   # 6 pixel rows of the 32x24 x 4 spp frame: 4 chunks


class Stop(RuntimeError):
    pass


def _stop_at(n):
    def progress(done, total):
        if done == n:
            raise Stop()
    return progress


@pytest.fixture(scope="module")
def kinds(tmp_path_factory):
    """{kind: (render(checkpoint_path, progress) -> output, the
    uninterrupted output, the stopped render's snapshot as {name: array}
    with its fingerprint)}."""
    path = load_and_compile(str(CBOX_XML), spp=4, width=32, height=24, device="cpu")
    ppm = load_and_compile(str(SCENES / "cbox" / "sppm.xml"), width=32, height=24,
                           device="cpu").replace(ppm_photons=2048, ppm_iterations=3)
    renders = {
        "path": lambda ck=None, progress=None: driver.render(
            path, seed=3, chunk_size=CHUNK, depth_cap=3, checkpoint_path=ck,
            checkpoint_every=1, progress=progress),
        "ppm": lambda ck=None, progress=None: driver.render(
            ppm, seed=4, depth_cap=4, checkpoint_path=ck, checkpoint_every=1,
            progress=progress),
    }
    out = {}
    for kind, render in renders.items():
        ck = str(tmp_path_factory.mktemp(kind) / "snapshot.npz")
        with pytest.raises(Stop):
            render(ck, _stop_at(2))
        with np.load(ck, allow_pickle=False) as data:
            snap = {k: data[k] for k in data.files}
        out[kind] = (render, render(), snap)
    return out


def _arrays(snap):
    return {k: v for k, v in snap.items() if k != "fingerprint"}


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_is_bit_exact(kinds, kind, tmp_path):
    """What `save` writes, `load` gives back: the same names, and each
    array the same dtype, shape and bits."""
    _, _, snap = kinds[kind]
    want = _arrays(snap)
    assert set(want) == ({"film_flat", "next_chunk"} if kind == "path" else
                         {"value", "tau", "n", "radius", "alpha", "iters", "next_it"})
    ck = str(tmp_path / "snapshot.npz")
    checkpoint.save(ck, want, str(snap["fingerprint"]))
    got = checkpoint.load(ck, str(snap["fingerprint"]))
    assert got is not None and set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("kind", KINDS)
def test_mismatched_fingerprint_is_refused(kinds, kind, tmp_path, caplog):
    """A snapshot of another render loads as None, with a warning that
    names both fingerprints."""
    _, _, snap = kinds[kind]
    ck = str(tmp_path / "snapshot.npz")
    have = str(snap["fingerprint"])
    want = have.replace("seed=", "seed=9")
    assert want != have
    checkpoint.save(ck, _arrays(snap), have)
    with caplog.at_level(logging.WARNING, logger="misaki_tpu_torch"):
        assert checkpoint.load(ck, want) is None
    assert "does not match this render" in caplog.text
    assert repr(have) in caplog.text and repr(want) in caplog.text


@pytest.mark.parametrize("kind", KINDS)
def test_no_temporary_file_is_left(kinds, kind, tmp_path):
    """Saving twice over one path leaves only the snapshot, and `discard`
    leaves nothing (and is a no-op where there is no snapshot)."""
    _, _, snap = kinds[kind]
    ck = str(tmp_path / "snapshot.npz")
    for _ in range(2):
        checkpoint.save(ck, _arrays(snap), str(snap["fingerprint"]))
        assert os.listdir(tmp_path) == ["snapshot.npz"]
    checkpoint.discard(ck)
    checkpoint.discard(ck)
    assert os.listdir(tmp_path) == []
    assert checkpoint.load(ck, str(snap["fingerprint"])) is None


@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_in_its_file_layout_resumes(kinds, kind, tmp_path):
    """A snapshot written straight by `np.savez` under the names a render's
    snapshot holds (the layout of files written before `checkpoint.save`)
    resumes the render at its next chunk or iteration, to the uninterrupted
    output to the bit, and the finished render deletes it."""
    render, ref, snap = kinds[kind]
    ck = str(tmp_path / "snapshot.npz")
    np.savez(ck, **snap)
    seen = []
    out = render(ck, lambda done, total: seen.append(done))
    start = int(snap["next_chunk" if kind == "path" else "next_it"])
    assert seen[0] == start + 1 and seen[-1] == (4 if kind == "path" else 3)
    for k in ("rgb", "alpha"):
        assert out[k].numpy().tobytes() == ref[k].numpy().tobytes(), k
    assert not os.path.exists(ck)

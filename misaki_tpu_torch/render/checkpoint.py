"""Snapshots of a render in progress, for checkpoint/resume: one `.npz` file
of named arrays beside the fingerprint of the render that wrote it
(`driver.render`'s film and next chunk, `ppm.render_ppm`'s per-pixel state
and next iteration). A snapshot is resumed only by a render with the same
fingerprint."""

import os

import numpy as np

from misaki_tpu_torch.utils.logging import get_logger


def save(path, arrays, fingerprint):
    """Write `arrays` ({name: numpy array}) and `fingerprint` beside `path`,
    then rename the file over it, so a crash leaves the last whole snapshot."""
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, fingerprint=np.array(fingerprint), **arrays)
    os.replace(tmp, path)


def load(path, fingerprint):
    """-> {name: numpy array} of the snapshot at `path`, or None where there
    is none or it belongs to another render (logged)."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as data:
        have = str(data["fingerprint"])
        if have != fingerprint:
            get_logger().warning(
                "checkpoint %s does not match this render (have %r, want %r): "
                "starting fresh", path, have, fingerprint)
            return None
        return {k: data[k] for k in data.files if k != "fingerprint"}


def discard(path):
    """Delete the snapshot at `path`, if any: a completed render's is stale."""
    if os.path.exists(path):
        os.remove(path)

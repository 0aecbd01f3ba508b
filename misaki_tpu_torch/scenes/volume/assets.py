"""The grid-volume scene's density grid, made from a formula and a seed
with numpy, so no grid is shipped:

  * grid.npy, (D, H, W) = 64^3 float32 at full size: a blob centred in the
    unit cube, 1 at its core falling to 0 at radius 0.45, times a ramp
    rising from 0.4 to 1 along +x, with seeded noise; rounded to steps of
    1/128, which bfloat16 holds exactly (so misaki_tpu's bfloat16 fetch of
    the grid is exact on it).

    python -m misaki_tpu_torch.scenes.volume.assets DIR [--small]

writes it next to copies of scene.xml and cube.obj in DIR and prints
scene.xml's path.
"""

import argparse
import hashlib
import shutil
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SCENE_XML = HERE / "scene.xml"
CUBE_OBJ = HERE / "cube.obj"
GRID_RES = 64
STEPS = 128  # density quantum 1/STEPS


def density_grid(res=GRID_RES, seed=0):
    """(res, res, res) float32 density, index order (z, y, x), values k /
    STEPS in [0, 1]."""
    rng = np.random.default_rng(seed)
    c = (np.arange(res) + 0.5) / res
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    blob = np.clip(1.0 - r / 0.45, 0.0, 1.0) ** 0.7
    ramp = 0.4 + 0.6 * x
    noise = 1.0 + 0.25 * rng.standard_normal((res, res, res))
    dens = np.clip(blob * ramp * noise, 0.0, 1.0)
    return (np.round(dens * STEPS) / STEPS).astype(np.float32)


def write_assets(out_dir, res=GRID_RES):
    """Write grid.npy and copies of cube.obj and scene.xml into `out_dir`;
    returns scene.xml's path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "grid.npy", density_grid(res))
    shutil.copyfile(CUBE_OBJ, out / "cube.obj")
    shutil.copyfile(SCENE_XML, out / "scene.xml")   # last: marks the set complete
    return out / "scene.xml"


def prepared(root, res=GRID_RES):
    """The scene's XML under `root`/<hash>/, its grid written at first use:
    the hash covers this module, the XML, the mesh and the size, so an edit
    writes a fresh set. Returns scene.xml's path."""
    h = hashlib.sha256(Path(__file__).read_bytes() + SCENE_XML.read_bytes()
                       + CUBE_OBJ.read_bytes() + repr(res).encode())
    xml = Path(root) / h.hexdigest()[:16] / "scene.xml"
    if not xml.exists():
        write_assets(xml.parent, res)
    return xml


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--small", action="store_true",
                    help="a 16^3 grid, for quick CPU renders")
    args = ap.parse_args()
    print(write_assets(args.out_dir, res=16 if args.small else GRID_RES))


if __name__ == "__main__":
    main()

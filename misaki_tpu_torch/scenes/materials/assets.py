"""The material gallery's one image, made from a seed with numpy and written
as a flat Radiance RGBE file, so no image is shipped:

  * roughness.hdr (256 x 256 at full size): a grey roughness map for the
    gold ball's GGX alpha (the bitmap's luminance), bands across v from 0.03
    to 0.45 with per-texel noise, so one sphere shows mirror-like and
    blurred reflections side by side.

    python -m misaki_tpu_torch.scenes.materials.assets DIR [--small]

writes it next to a copy of scene.xml in DIR and prints the XML's path.
"""

import argparse
import hashlib
import shutil
from pathlib import Path

import numpy as np

from misaki_tpu_torch.scenes.envlit.assets import write_rgbe

SCENE_XML = Path(__file__).resolve().parent / "scene.xml"
ROUGHNESS_RES = 256
BANDS = 6
ALPHA_RANGE = (0.03, 0.45)


def roughness_rgb(res=ROUGHNESS_RES, seed=2):
    """(res, res, 3) float32 grey map: BANDS bands across the rows, their
    alphas spread over ALPHA_RANGE, with 5% per-texel noise."""
    rng = np.random.default_rng(seed)
    band = np.arange(res) * BANDS // res
    lo, hi = ALPHA_RANGE
    alpha = lo + (hi - lo) * (band % 2 * 0.7 + band / (BANDS - 1) * 0.3)
    a = alpha[:, None] * (1.0 + 0.05 * rng.standard_normal((res, res)))
    a = np.clip(a, lo, hi).astype(np.float32)
    return np.repeat(a[..., None], 3, axis=-1)


def write_assets(out_dir, res=ROUGHNESS_RES):
    """Write roughness.hdr and a copy of scene.xml into `out_dir`; returns
    the XML's path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_rgbe(out / "roughness.hdr", roughness_rgb(res))
    shutil.copyfile(SCENE_XML, out / "scene.xml")   # last: marks the set complete
    return out / "scene.xml"


def prepared(root, res=ROUGHNESS_RES):
    """The scene's XML under `root`/<hash>/, its image written at first use:
    the hash covers this module, the XML and the size, so an edit writes a
    fresh set. Returns the XML's path."""
    h = hashlib.sha256(Path(__file__).read_bytes() + SCENE_XML.read_bytes()
                       + repr(res).encode())
    xml = Path(root) / h.hexdigest()[:16] / "scene.xml"
    if not xml.exists():
        write_assets(xml.parent, res)
    return xml


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--small", action="store_true",
                    help="a 32x32 roughness map, for quick CPU renders")
    args = ap.parse_args()
    print(write_assets(args.out_dir, **({"res": 32} if args.small else {})))


if __name__ == "__main__":
    main()

"""The envlit scene's images, made from a seed with numpy and written as flat
(uncompressed) Radiance RGBE files, so no image is shipped:

  * sky.hdr (lat-long, 2048 x 4096 at full size): a sky gradient from a pale
    horizon to a blue zenith, a small bright sun disc, and a darker ground
    half below the horizon;
  * floor.hdr (1024 x 1024 at full size): an 8 x 8 checker of light and
    dark tiles with per-texel noise.

    python -m misaki_tpu_torch.scenes.envlit.assets DIR [--small]

writes both next to a copy of scene.xml in DIR and prints the XML's path.
"""

import argparse
import hashlib
import shutil
from pathlib import Path

import numpy as np

SCENE_XML = Path(__file__).resolve().parent / "scene.xml"
SKY_SHAPE = (2048, 4096)
FLOOR_RES = 1024
CHECKER_TILES = 8
# sun direction in the map's own frame (y up): elevation and azimuth in
# degrees, angular radius in degrees
SUN = (40.0, 30.0, 1.5)


def write_rgbe(path, rgb):
    """Flat Radiance RGBE writer: per texel, the mantissas c / 2^(e-136) of
    a shared exponent e (the reader of scene/compiler.py inverts it)."""
    rgb = np.asarray(rgb, np.float32)
    H, W, _ = rgb.shape
    m = rgb.max(axis=-1)
    lit = m > 1e-32
    exp = np.where(lit, np.floor(np.log2(np.maximum(m, 1e-32))) + 1, 0)
    scale = np.where(lit, np.exp2(8.0 - exp), 0.0)
    mant = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    e8 = np.where(lit, exp + 128, 0).astype(np.uint8)
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {H} +X {W}\n".encode()
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.concatenate([mant, e8[..., None]], axis=-1).tobytes())


def sky_rgb(shape=SKY_SHAPE, seed=0):
    """(H, W, 3) float32 lat-long sky: row v = theta / pi from the zenith,
    column u = phi / 2pi, direction (sin phi sin theta, cos theta,
    -cos phi sin theta) as the envmap emitter maps it."""
    H, W = shape
    rng = np.random.default_rng(seed)
    theta = (np.arange(H, dtype=np.float32) + 0.5) / H * np.float32(np.pi)
    phi = (np.arange(W, dtype=np.float32) + 0.5) / W * np.float32(2 * np.pi)
    elev = np.float32(np.pi / 2) - theta                         # (H,)
    t = np.clip(np.sin(elev), 0.0, 1.0)[:, None, None]
    horizon = np.array([0.6, 0.75, 1.0], np.float32)
    zenith = np.array([0.1, 0.25, 1.0], np.float32)
    sky = (1.0 - t) * horizon + t * zenith                       # (H, 1, 3)
    ground = np.array([0.12, 0.1, 0.08], np.float32)
    rgb = np.where((elev >= 0.0)[:, None, None], sky, ground)
    rgb = np.broadcast_to(rgb, (H, W, 3)).copy()
    rgb *= 1.0 + 0.03 * rng.standard_normal((H, W, 1), dtype=np.float32)

    s_el, s_az, s_rad = (np.deg2rad(x) for x in SUN)
    # at least 1.5 rows across on a small map, at the same irradiance
    r = max(s_rad, 1.5 * np.pi / H)
    sun_rgb = np.array([3000.0, 2800.0, 2500.0], np.float32) * np.float32((s_rad / r) ** 2)
    sun = np.array([np.sin(s_az) * np.cos(s_el), np.sin(s_el), -np.cos(s_az) * np.cos(s_el)])
    st = np.sin(theta)[:, None]
    cos_ang = (np.sin(phi)[None, :] * st * sun[0] + np.cos(theta)[:, None] * sun[1]
               - np.cos(phi)[None, :] * st * sun[2])
    rgb[cos_ang >= np.cos(r)] = sun_rgb
    return np.maximum(rgb, 0.0).astype(np.float32)


def floor_rgb(res=FLOOR_RES, seed=1):
    """(res, res, 3) float32 checker of CHECKER_TILES x CHECKER_TILES tiles,
    light (warm) and dark (cool), with per-texel noise."""
    rng = np.random.default_rng(seed)
    ij = np.arange(res) * CHECKER_TILES // res
    light = ((ij[:, None] + ij[None, :]) % 2 == 0)[..., None]
    rgb = np.where(light, np.array([0.8, 0.75, 0.65], np.float32),
                   np.array([0.12, 0.12, 0.14], np.float32))
    rgb = rgb * (1.0 + 0.08 * rng.standard_normal((res, res, 1), dtype=np.float32))
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)


def write_assets(out_dir, sky_shape=SKY_SHAPE, floor_res=FLOOR_RES):
    """Write sky.hdr, floor.hdr and a copy of scene.xml into `out_dir`;
    returns the XML's path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_rgbe(out / "sky.hdr", sky_rgb(sky_shape))
    write_rgbe(out / "floor.hdr", floor_rgb(floor_res))
    shutil.copyfile(SCENE_XML, out / "scene.xml")   # last: marks the set complete
    return out / "scene.xml"


def prepared(root, sky_shape=SKY_SHAPE, floor_res=FLOOR_RES):
    """The scene's XML under `root`/<hash>/, its assets written at first use:
    the hash covers this module, the XML and the sizes, so an edit writes a
    fresh set. Returns the XML's path."""
    h = hashlib.sha256(Path(__file__).read_bytes() + SCENE_XML.read_bytes()
                       + repr((sky_shape, floor_res)).encode())
    xml = Path(root) / h.hexdigest()[:16] / "scene.xml"
    if not xml.exists():
        write_assets(xml.parent, sky_shape, floor_res)
    return xml


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--small", action="store_true",
                    help="a 64x128 sky and a 64x64 floor, for quick CPU renders")
    args = ap.parse_args()
    kw = dict(sky_shape=(64, 128), floor_res=64) if args.small else {}
    print(write_assets(args.out_dir, **kw))


if __name__ == "__main__":
    main()

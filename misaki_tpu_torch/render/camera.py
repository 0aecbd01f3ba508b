"""Perspective camera ray generation
(reference: src/librender/sensors/perspective.cpp:23-42 + sensor.cpp:43).

Pixel positions -> world rays + hero wavelengths. Positions are (px, py)
tuples; rays are vec3 tuples.
"""

from misaki_tpu_torch.core import spectrum as spec
from misaki_tpu_torch.core import vec


def _raster_to_world_dir(camera, px, py):
    """Raster position -> (world direction, mint, maxt)."""
    s2c = camera.sample_to_camera
    # apply_point with z=0 and w-divide (transform.h apply_point)
    nx = s2c[0, 0] * px + s2c[0, 1] * py + s2c[0, 3]
    ny = s2c[1, 0] * px + s2c[1, 1] * py + s2c[1, 3]
    nz = s2c[2, 0] * px + s2c[2, 1] * py + s2c[2, 3]
    nw = s2c[3, 0] * px + s2c[3, 1] * py + s2c[3, 3]
    inv_w = 1.0 / nw
    near_p = (nx * inv_w, ny * inv_w, nz * inv_w)
    d = vec.normalize(near_p)
    inv_z = 1.0 / d[2]
    mint = camera.near * inv_z
    maxt = camera.far * inv_z

    c2w = camera.to_world
    dx, dy, dz = d
    d_world = (
        c2w[0, 0] * dx + c2w[0, 1] * dy + c2w[0, 2] * dz,
        c2w[1, 0] * dx + c2w[1, 1] * dy + c2w[1, 2] * dz,
        c2w[2, 0] * dx + c2w[2, 1] * dy + c2w[2, 2] * dz,
    )
    return d_world, mint, maxt


def sample_ray(camera, pos_sample, wavelength_sample):
    """pos_sample: (px, py) tuple of (L,) raster coords; wavelength_sample (L,).

    Returns dict {o, d (vec3), mint, maxt (L,), wavelengths, wav_weight (4, L)}.
    """
    wavelengths, wav_weight = spec.sample_wavelength(wavelength_sample)
    px, py = pos_sample
    d_world, mint, maxt = _raster_to_world_dir(camera, px, py)
    c2w = camera.to_world
    o = vec.splat3((c2w[0, 3], c2w[1, 3], c2w[2, 3]), px)
    return {
        "o": o,
        "d": d_world,
        "mint": mint,
        "maxt": maxt,
        "wavelengths": wavelengths,
        "wav_weight": wav_weight,
    }


def sample_ray_differential(camera, pos_sample, wavelength_sample):
    """Sensor::sample_ray_differential (sensor.cpp:50-77): the primary ray
    plus the directions of the +1-pixel-in-x and +1-pixel-in-y rays (the
    pinhole origin is shared), as "d_dx" / "d_dy"."""
    ray = sample_ray(camera, pos_sample, wavelength_sample)
    px, py = pos_sample
    d_x, _, _ = _raster_to_world_dir(camera, px + 1.0, py)
    d_y, _, _ = _raster_to_world_dir(camera, px, py + 1.0)
    ray["d_dx"] = d_x
    ray["d_dy"] = d_y
    return ray

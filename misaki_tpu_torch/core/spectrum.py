"""Hero-wavelength spectral transport core
(reference: include/misaki/core/spectrum.h, src/librender/spectrum.cpp).

Layout: spectral quantities are wavelength-major (4, L) tensors; colours at
the lane level are (r, g, b) component tuples; whole images are (H, W, 3).
"""

import numpy as np
import torch

from misaki_tpu_torch.core.cie_data import (
    CIE1931_X,
    CIE1931_Y,
    CIE1931_Z,
    CIE_MAX,
    CIE_MIN,
    CIE_SAMPLES,
    D65_DATA,
    D65_TABLE_NORMALIZATION,
)
from misaki_tpu_torch.core.table import const, hat_eval, hat_eval_multi

N_WAVELENGTHS = 4
WAVELENGTH_MIN = 360.0
WAVELENGTH_MAX = 830.0


def cie1931_xyz(wavelengths):
    """Clamped linear interpolation into the 95-sample CIE table
    (spectrum.h:82-107). wavelengths: (4, L). Returns (X, Y, Z), each (4, L)."""
    t = (wavelengths - CIE_MIN) * ((CIE_SAMPLES - 1) / (CIE_MAX - CIE_MIN))
    return tuple(hat_eval_multi([CIE1931_X, CIE1931_Y, CIE1931_Z], t))


def spectrum_to_xyz(value, wavelengths):
    """Mean-reduce over hero wavelengths (spectrum.h:109-115).

    value, wavelengths: (4, L). Returns (X, Y, Z) tuple of (L,).
    """
    X, Y, Z = cie1931_xyz(wavelengths)
    return (
        torch.mean(X * value, dim=0),
        torch.mean(Y * value, dim=0),
        torch.mean(Z * value, dim=0),
    )


# sRGB <-> XYZ (ITU-R BT.709 primaries, spectrum.h:131-143)
SRGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
XYZ_TO_SRGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=np.float32,
)


def _apply3(M, c):
    a, b, d = c
    M = M.tolist()  # Python floats: a numpy scalar on the left would grab the tensor
    return (
        M[0][0] * a + M[0][1] * b + M[0][2] * d,
        M[1][0] * a + M[1][1] * b + M[1][2] * d,
        M[2][0] * a + M[2][1] * b + M[2][2] * d,
    )


def srgb_to_xyz(rgb):
    """Tuple (r, g, b) of (L,) -> tuple (X, Y, Z)."""
    return _apply3(SRGB_TO_XYZ, rgb)


def xyz_to_srgb(xyz):
    return _apply3(XYZ_TO_SRGB, xyz)


def xyz_to_srgb_image(img):
    """(H, W, 3) image variant (film develop)."""
    return img @ const(XYZ_TO_SRGB, img.device).T


def sample_shifted(sample):
    """Stratified hero-wavelength shift (mathutils.h:167-182).

    sample: (L,) in [0,1) -> (4, L) shifted copies mod 1.
    """
    shift = torch.arange(N_WAVELENGTHS, dtype=torch.float32,
                         device=sample.device)[:, None] / N_WAVELENGTHS
    value = sample[None, :] + shift
    return torch.where(value <= 1.0, value, value - 1.0)


def sample_rgb_spectrum(sample):
    """Importance-sampled visible-range wavelengths (spectrum.h:152-173).

    pdf proportional to sech^2(0.0072 (lambda - 538)); weight = 1/pdf.
    sample: (4, L) -> (wavelengths, weight), both (4, L).
    """
    wavelengths = (
        538.0
        - torch.arctanh(0.8569106254698279 - 1.8275019724092267 * sample)
        * 138.88888888888889
    )
    tmp = torch.cosh(0.0072 * (wavelengths - 538.0))
    weight = 253.82 * tmp * tmp
    return wavelengths, weight


def pdf_rgb_spectrum(wavelengths):
    """Reciprocal of the sample_rgb_spectrum weight, zero outside range."""
    tmp = 1.0 / torch.cosh(0.0072 * (wavelengths - 538.0))
    inside = (wavelengths >= WAVELENGTH_MIN) & (wavelengths <= WAVELENGTH_MAX)
    return torch.where(inside, tmp * tmp / 253.82, 0.0)


def sample_wavelength(sample):
    """Stratified-shift + rgb importance sampling (spectrum.h:175-181).

    sample: (L,) -> ((4, L) wavelengths, (4, L) weights).
    """
    return sample_rgb_spectrum(sample_shifted(sample))


def eval_regular(values, lambda_min, lambda_max, wavelengths):
    """Regularly-sampled spectrum lerp (spectra/regular.cpp eval_pdf),
    clamped to edge bins. values: (N,); wavelengths: (4, L)."""
    size = values.shape[-1]
    x = (wavelengths - lambda_min) * ((size - 1) / (lambda_max - lambda_min))
    return hat_eval(values, x)


def eval_d65(wavelengths, scale=1.0):
    """D65 radiance on the 95-bin grid with the reference's 1/10568
    normalization (spectra/d65.cpp:22)."""
    return eval_regular(D65_DATA, CIE_MIN, CIE_MAX, wavelengths) * (
        scale * D65_TABLE_NORMALIZATION
    )

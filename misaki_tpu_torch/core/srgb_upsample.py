"""Jakob-Hanika sRGB -> smooth-spectrum upsampling.

The three coefficients of the sigmoid model are fitted per distinct scene
colour at scene-compile time, with a damped Gauss-Newton solve (NumPy,
float64) against the rgb2spec objective: the sigmoid spectrum, lit by D65 and
integrated against the CIE 1931 observer, must reproduce the requested sRGB
colour. The fit is the same host code as `misaki_tpu.core.srgb_upsample`; the
in-render evaluation is the same closed form, on tensors
(include/misaki/render/srgb.h:8-19).
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
)

# Fitting operates on normalized wavelength x = (lambda - CIE_MIN) / SPAN.
_SPAN = CIE_MAX - CIE_MIN

_SRGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)
_XYZ_TO_SRGB = np.linalg.inv(_SRGB_TO_XYZ)

_LAMBDA = np.linspace(CIE_MIN, CIE_MAX, CIE_SAMPLES)
_X_NORM = (_LAMBDA - CIE_MIN) / _SPAN
# Integration weights: D65-weighted CIE matching functions, normalized so a
# unit (flat 1.0) reflectance maps to the D65 white point with Y = 1.
_CMF = np.stack([CIE1931_X, CIE1931_Y, CIE1931_Z], axis=0).astype(np.float64)
_D65W = D65_DATA.astype(np.float64)
_K = 1.0 / np.sum(_D65W * _CMF[1])
_W = _K * _D65W[None, :] * _CMF  # (3, 95): spectrum -> XYZ quadrature


def _sigmoid(v):
    return 0.5 * v / np.sqrt(v * v + 1.0) + 0.5


def _model_rgb(p):
    """sRGB color produced by sigmoid poly p (in normalized-x domain)."""
    v = (p[0] * _X_NORM + p[1]) * _X_NORM + p[2]
    s = _sigmoid(v)
    xyz = _W @ s
    return _XYZ_TO_SRGB @ xyz


def fit_srgb_coeffs(rgb):
    """Fit (c0, c2, c2) of the nm-domain sigmoid polynomial for linear sRGB.

    Returns np.float64 (3,) coefficients in the *nanometer* domain, directly
    usable by `srgb_model_eval` (matching srgb.h:8-19 conventions).
    """
    rgb = np.asarray(rgb, dtype=np.float64)
    rgb = np.clip(rgb, 0.0, None)
    # Degenerate black/white: saturate the sigmoid hard.
    if np.max(rgb) < 1e-6:
        return np.array([0.0, 0.0, -1e4])

    # Start from a flat spectrum matching the luminance.
    y = float(np.clip(_SRGB_TO_XYZ[1] @ rgb, 1e-4, 1.0 - 1e-4))
    v0 = (y - 0.5) / np.sqrt(y * (1.0 - y))
    p = np.array([0.0, 0.0, v0])

    lam = 1e-4
    err = np.inf
    for _ in range(100):
        r = _model_rgb(p) - rgb
        new_err = float(r @ r)
        # Jacobian by forward differences (3x3, cheap and robust).
        J = np.empty((3, 3))
        for j in range(3):
            dp = np.zeros(3)
            dp[j] = 1e-5
            J[:, j] = (_model_rgb(p + dp) - _model_rgb(p - dp)) / 2e-5
        if new_err < err:
            err = new_err
            lam = max(lam * 0.5, 1e-8)
        else:
            lam = min(lam * 4.0, 1e4)
        if err < 1e-14:
            break
        A = J.T @ J + lam * np.eye(3)
        g = J.T @ r
        try:
            step = np.linalg.solve(A, g)
        except np.linalg.LinAlgError:
            break
        p = p - step
        if float(step @ step) < 1e-16:
            break

    # Convert from normalized-x domain to the nm domain:
    # v = p0*x^2 + p1*x + p2 with x = (lambda - L0)/S
    L0, S = CIE_MIN, _SPAN
    c0 = p[0] / (S * S)
    c1 = p[1] / S - 2.0 * L0 * p[0] / (S * S)
    c2 = p[0] * (L0 / S) ** 2 - p[1] * (L0 / S) + p[2]
    return np.array([c0, c1, c2])


def srgb_model_eval(coeff, wavelengths):
    """The reference's sigmoid eval (srgb.h:8-19).

    coeff: (c0, c1, c2) tuple of (L,) per-lane nm-domain coefficients;
    wavelengths: (4, L) wavelength-major. Returns (4, L) reflectance in [0, 1].
    """
    c0, c1, c2 = coeff
    v = (c0[None, :] * wavelengths + c1[None, :]) * wavelengths + c2[None, :]
    rsqrt = 1.0 / torch.sqrt(v * v + 1.0)
    return torch.clamp(0.5 * v * rsqrt + 0.5, min=0.0)


def srgb_model_mean(coeff):
    """Mean reflectance of the sigmoid model over 16 equally spaced
    wavelengths on 360..830 nm, in float32. coeff: (..., 3) -> (...).

    The reference's srgb_model_mean (srgb.h:21-36) spaces its wavelengths
    from WAVELENGTH_MIN to WAVELENGTH_MIN, so it evaluates at 360 nm only;
    this is the evident intent, as in misaki_tpu. Only roughplastic's lobe
    sampling weight reads it."""
    lam = torch.linspace(360.0, 830.0, 16, dtype=torch.float32)
    c = torch.as_tensor(np.asarray(coeff), dtype=torch.float32)
    v = (c[..., 0:1] * lam + c[..., 1:2]) * lam + c[..., 2:3]
    s = torch.clamp(0.5 * v / torch.sqrt(v * v + 1.0) + 0.5, min=0.0)
    return torch.mean(s, dim=-1)

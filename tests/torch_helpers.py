"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Importing this module caps PyTorch's intra-op threads: the suite runs in
several worker processes at once, and each would otherwise take every core.
"""

from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SCENES = REPO / "misaki_tpu_torch" / "scenes"
CBOX_XML = SCENES / "cbox" / "scene.xml"
FURNACE_XML = SCENES / "furnace.xml"


def t(x):
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def n(x):
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def lanes_off(want, got, rtol, atol):
    """Per lane (last axis): does got differ from want beyond rtol / atol."""
    w, g = np.asarray(want, np.float64), np.asarray(got, np.float64)
    bad = ~np.isclose(g, w, rtol=rtol, atol=atol)
    return bad.reshape(-1, bad.shape[-1]).any(axis=0)


def nearer_float64(want, got, ref):
    """Per lane (last axis): is the port's value `got` nearer to `ref`, the
    same formulas taken in float64 on the same float32 inputs, than
    misaki_tpu's float32 value `want` is."""
    ref = np.asarray(ref, np.float64)
    err_want = np.abs(np.asarray(want, np.float64) - ref)
    err_got = np.abs(np.asarray(got, np.float64) - ref)
    return (err_want.reshape(-1, ref.shape[-1]).max(axis=0)
            > err_got.reshape(-1, ref.shape[-1]).max(axis=0))


def golden_criteria(got, want):
    """The golden-image criteria of tests/test_golden_images.py: each
    texel's error as a share of the image's maximum; fewer than 2% of texels
    above 1e-3 and a mean below 1e-3. Returns (frac_off, mean_err)."""
    scale = max(float(np.abs(want).max()), 1e-3)
    err = np.abs(np.asarray(got) - np.asarray(want)) / scale
    return float((err > 1e-3).mean()), float(err.mean())


def luminance_y(rgb):
    rgb = np.asarray(rgb)
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]


# A 2-face rectangle light beside a 5,120-face sphere light, so the
# rectangle's row of the emitters' face CDF is padded with 1.0 to 5,120
# entries; a diffuse rectangle behind them.
TWO_LIGHTS = """<scene version="0.6.0">
    <integrator type="path"><integer name="max_depth" value="3"/></integrator>
    <sensor type="perspective">
        <transform name="to_world">
            <lookat origin="0, 0, 6" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="8"/><integer name="height" value="8"/>
        </film>
    </sensor>
    <shape type="rectangle">
        <transform name="to_world"><translate x="2" y="0" z="0"/></transform>
        <emitter type="area"><rgb name="radiance" value="3, 3, 3"/></emitter>
    </shape>
    <shape type="sphere">
        <point name="center" x="-1" y="0" z="0"/><float name="radius" value="0.5"/>
        <emitter type="area"><rgb name="radiance" value="2, 1, 1"/></emitter>
    </shape>
    <shape type="rectangle">
        <transform name="to_world"><scale x="5" y="5" z="1"/><translate z="-1"/></transform>
    </shape>
</scene>"""


def samples_at_entries(cdf, g, L):
    """uy values: uniform, each CDF entry exactly, the entry's float
    neighbours, 0 and 1."""
    u = torch.rand(L, generator=g)
    entries = cdf[torch.randint(0, cdf.shape[0], (L,), generator=g)]
    up = torch.nextafter(entries, torch.tensor(2.0))
    down = torch.nextafter(entries, torch.tensor(-1.0))
    return torch.cat([u, entries, up, down, torch.tensor([0.0, 1.0])])

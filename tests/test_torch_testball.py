"""Figure 2 and Figure 3, the rough-conductor and rough-dielectric test
balls (misaki_tpu_torch/scenes/testball/), rendered by the port on the CPU
against misaki_tpu on the same XML, seed and depth, under the golden
criteria of tests/test_torch_path.py.

Each ball is two coincident 20,480-face spheres (341 clusters in all), and
the port's CPU casts are its plain tile walk, which scans every cluster on a
tile of incoherent bounce rays; so the frames are 48x27 at 2 spp. Kept apart
from the gallery's file, so that `pytest -n N --dist loadfile` can run the
two files in parallel.
"""

import numpy as np
import pytest

from torch_helpers import SCENES, golden_criteria, n

from misaki_tpu.render import driver as jdriver
from misaki_tpu.scene import compiler as jcomp
from misaki_tpu_torch.render import driver as pdriver
from misaki_tpu_torch.scene import compiler as pcomp

RENDER = dict(spp=2, width=48, height=27)


@pytest.mark.parametrize("name,max_depth", [("roughconductor", 5), ("roughdielectric", 7)])
def test_testball_render_matches_misaki_tpu(name, max_depth):
    path = str(SCENES / "testball" / f"{name}.xml")
    js = jcomp.load_and_compile(path, **RENDER)
    ps = pcomp.load_and_compile(path, device="cpu", **RENDER)
    assert ps.max_depth == js.max_depth == max_depth
    want = np.asarray(jdriver.render(js, seed=7)["rgb"])
    got = n(pdriver.render(ps, seed=7)["rgb"])
    assert got.shape == want.shape == (RENDER["height"], RENDER["width"], 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.mean() > 0.05
    frac_off, mean_err = golden_criteria(got, want)
    assert frac_off < 0.02, frac_off
    assert mean_err < 1e-3, mean_err

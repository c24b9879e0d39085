"""Golden-image regression tests.

Small fixed-seed CPU renders committed as .npy; any semantic change to the
integrator/sampler/intersection shows up as a pixel diff. (Counter-based
threefry makes the RNG platform-stable; a small tolerance absorbs XLA
fusion-order drift across versions.)
"""

import os

import numpy as np
import pytest

import path_tracer as pt
from path_tracer.utils.config import RenderConfig, Resolution

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("sid", ["two-spheres", "cornell", "mesh"])
def test_golden(all_scenes, sid):
    golden = np.load(os.path.join(GOLDEN_DIR, f"{sid}_24x36_spp8_seed1234.npy"))
    done = pt.render(
        all_scenes[sid],
        RenderConfig(samples_per_pixel=8, resolution=Resolution(24, 36), seed=1234),
        out_dir=None,
        verbose=False,
    )
    np.testing.assert_allclose(done.image.pixels, golden, atol=2e-5, rtol=1e-4)


def test_mock_random_is_seed_independent(all_scenes):
    cfg = RenderConfig(
        samples_per_pixel=4, resolution=Resolution(16, 24), mock_random=True
    )
    a = pt.render(all_scenes["two-spheres"], cfg, out_dir=None, verbose=False)
    b = pt.render(
        all_scenes["two-spheres"], cfg.with_(seed=99), out_dir=None, verbose=False
    )
    np.testing.assert_array_equal(a.image.pixels, b.image.pixels)
    c = pt.render(
        all_scenes["two-spheres"], cfg.with_(mock_random=False), out_dir=None,
        verbose=False,
    )
    assert not np.array_equal(a.image.pixels, c.image.pixels)

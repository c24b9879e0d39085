"""CLI argument handling, distributed helpers, pipeline edge cases."""

import os

import numpy as np
import pytest

import path_tracer as pt
from path_tracer.cli import build_parser, resolve_scene
from path_tracer.utils.config import RenderConfig, Resolution
from path_tracer.utils.profiling import RenderStats, format_eta


def test_cli_defaults_and_positionals():
    p = build_parser()
    a = p.parse_args([])
    assert (a.spp, a.res_y, a.scene) == (100, 300, "cornell")
    a = p.parse_args(["500", "300", "mesh"])  # the reference debug profile
    assert (a.spp, a.res_y, a.scene) == (500, 300, "mesh")


def test_cli_scene_by_index(repo_root):
    old = os.getcwd()
    os.chdir(repo_root)
    try:
        scene = resolve_scene("1", "scenes", "meshes")
        ids = pt.load_scene_ids("scenes")
        assert scene.id == ids[1]
        with pytest.raises(SystemExit):
            resolve_scene("99", "scenes", "meshes")
        with pytest.raises(SystemExit):
            resolve_scene("nope", "scenes", "meshes")
    finally:
        os.chdir(old)


def test_format_eta():
    assert format_eta(0) == "0:00:00"
    assert format_eta(59) == "0:00:59"
    assert format_eta(3600 + 62) == "1:01:02"


def test_render_stats_merge():
    a = RenderStats(wall_seconds=1.0, num_samples=10, num_rays=50, num_dispatches=1)
    b = RenderStats(wall_seconds=2.0, num_samples=20, num_rays=100, num_dispatches=2)
    a.merge(b)
    assert a.num_rays == 150 and a.num_dispatches == 3
    assert a.mrays_per_sec == 150 / 3.0 / 1e6


def test_remainder_pass(all_scenes):
    """spp not divisible by samples_per_pass: the remainder pass must run
    and the average must cover exactly spp samples."""
    cfg = RenderConfig(
        samples_per_pixel=7, resolution=Resolution(16, 24), samples_per_pass=3
    )
    done = pt.render(all_scenes["two-spheres"], cfg, out_dir=None, verbose=False)
    assert done.stats.num_samples == 7 * 16 * 24
    # full passes fuse into one dispatch (render_passes_fused) + remainder
    assert done.stats.num_dispatches == 2  # fused(3 + 3) + 1


def test_distributed_single_host_helpers(all_scenes):
    from path_tracer.parallel import distributed

    scene = all_scenes["cornell"]
    d1 = distributed.scene_digest(scene)
    d2 = distributed.scene_digest(scene)
    assert d1 == d2 and len(d1) == 64
    assert distributed.check_scene_consistency(scene)
    arr = np.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(distributed.assemble_image(arr), arr)


def test_checkpoint_path_suffix(all_scenes, tmp_path):
    """Non-.npz checkpoint paths are normalized (np.savez appends .npz)."""
    ck = str(tmp_path / "render.ck")  # no .npz
    cfg = RenderConfig(
        samples_per_pixel=8, resolution=Resolution(16, 24), samples_per_pass=2
    )
    calls = {"n": 0}
    pt.render(
        all_scenes["two-spheres"], cfg, out_dir=None, verbose=False,
        checkpoint_path=ck, checkpoint_every=1,
        cancel=lambda: calls.__setitem__("n", calls["n"] + 1) or calls["n"] > 2,
    )
    assert os.path.exists(ck + ".npz")
    full = pt.render(all_scenes["two-spheres"], cfg, out_dir=None, verbose=False)
    resumed = pt.render(
        all_scenes["two-spheres"], cfg, out_dir=None, verbose=False,
        checkpoint_path=ck,
    )
    np.testing.assert_array_equal(resumed.image.pixels, full.image.pixels)

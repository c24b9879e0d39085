"""End-to-end pipeline tests on the CPU backend."""

import os

import numpy as np
import pytest

import path_tracer as pt
from path_tracer.render.image import Image, read_ppm, write_ppm
from path_tracer.utils.config import RenderConfig, Resolution


def _cfg(res=24, spp=8, **kw):
    return RenderConfig(
        samples_per_pixel=spp, resolution=Resolution(res, res * 3 // 2), **kw
    )


def test_render_two_spheres(all_scenes, tmp_path):
    done = pt.render(all_scenes["two-spheres"], _cfg(), out_dir=str(tmp_path),
                     verbose=False)
    assert not done.cancelled
    img = done.image.pixels
    assert img.shape == (24 * 36, 3)
    assert img.max() <= 1.0 and img.min() >= 0.0
    assert img.max() > 0.5  # emissive sphere visible
    assert done.stats.num_rays > 0
    assert os.path.exists(done.ppm_path)


def test_plain_render_takes_packed_fetch_path(all_scenes, monkeypatch):
    """A plain (non-sharded) render must finalize via the packed ONE
    round-trip fetch, never the sharded assemble_image gather. Regression
    for the r5 find: the packed path was keyed on `accum.sharding is
    None`, which no jax array satisfies (plain arrays carry a
    SingleDeviceSharding) — so it had been dead since r3, costing two
    serialized device fetches (~105 vs ~40 ms) on every small render."""
    from path_tracer.parallel import distributed

    def boom(a):
        raise AssertionError("plain render fell into the sharded "
                             "assemble_image finalize path")

    monkeypatch.setattr(distributed, "assemble_image", boom)
    done = pt.render(all_scenes["two-spheres"], _cfg(), out_dir=None,
                     verbose=False)
    assert done.stats.num_rays > 0  # rendered fine without assemble_image


def test_render_deterministic_same_seed(all_scenes):
    r1 = pt.render(all_scenes["cornell"], _cfg(16, 4, seed=3), out_dir=None,
                   verbose=False)
    r2 = pt.render(all_scenes["cornell"], _cfg(16, 4, seed=3), out_dir=None,
                   verbose=False)
    np.testing.assert_array_equal(r1.image.pixels, r2.image.pixels)
    assert r1.image.hash == r2.image.hash
    r3 = pt.render(all_scenes["cornell"], _cfg(16, 4, seed=4), out_dir=None,
                   verbose=False)
    assert not np.array_equal(r1.image.pixels, r3.image.pixels)


def _backend_ctx(backend):
    """The kernel backend runs here only in the Pallas interpreter."""
    import contextlib

    from path_tracer.ops.pallas import megakernel

    if backend == "pallas":
        return megakernel.interpret_mode()
    return contextlib.nullcontext()


def test_progress_and_cancel(all_scenes):
    """Progress updates and cooperative cancel at pass boundaries."""
    _progress_and_cancel(all_scenes, "auto")


def test_progress_and_cancel_kernel(all_scenes):
    """The same on the kernel backend."""
    with _backend_ctx("pallas"):
        _progress_and_cancel(all_scenes, "pallas")


def _progress_and_cancel(all_scenes, backend):
    updates = []
    done = pt.render(
        all_scenes["two-spheres"],
        _cfg(16, 16, backend=backend).with_(samples_per_pass=4),
        out_dir=None,
        progress=lambda u: updates.append(u),
        progress_interval=0.0,
        verbose=False,
    )
    assert len(updates) >= 4
    assert updates[-1].progress == 1.0
    assert updates[-1].image is not None

    # cancel after the first pass: partial image still returned (parity §3.3)
    calls = {"n": 0}

    def cancel():
        calls["n"] += 1
        return calls["n"] > 1

    done = pt.render(
        all_scenes["two-spheres"],
        _cfg(16, 16, backend=backend).with_(samples_per_pass=4),
        out_dir=None,
        cancel=cancel,
        verbose=False,
    )
    assert done.cancelled
    assert done.image.pixels.max() > 0  # partial content present


def test_checkpoint_resume_bit_exact(all_scenes, tmp_path):
    """A render interrupted after two passes and resumed from its
    pass-boundary checkpoint equals the uninterrupted render bit for bit."""
    _checkpoint_resume(all_scenes, tmp_path, "auto")


def test_checkpoint_resume_bit_exact_kernel(all_scenes, tmp_path):
    """The same on the kernel backend."""
    with _backend_ctx("pallas"):
        _checkpoint_resume(all_scenes, tmp_path, "pallas")


def _checkpoint_resume(all_scenes, tmp_path, backend):
    ck = str(tmp_path / "ck.npz")
    cfg = _cfg(16, 16, seed=11, backend=backend).with_(samples_per_pass=4)

    full = pt.render(all_scenes["two-spheres"], cfg, out_dir=None, verbose=False)

    # interrupt after 2 passes, then resume from checkpoint
    calls = {"n": 0}
    pt.render(
        all_scenes["two-spheres"], cfg, out_dir=None, verbose=False,
        checkpoint_path=ck, checkpoint_every=1,
        cancel=lambda: calls.__setitem__("n", calls["n"] + 1) or calls["n"] > 2,
    )
    assert os.path.exists(ck)
    resumed = pt.render(
        all_scenes["two-spheres"], cfg, out_dir=None, verbose=False,
        checkpoint_path=ck,
    )
    np.testing.assert_array_equal(resumed.image.pixels, full.image.pixels)
    assert not os.path.exists(ck)  # cleared after completion


def test_checkpoint_config_mismatch_warns(all_scenes, tmp_path, capsys):
    """A checkpoint that no longer matches the run config is IGNORED with a
    loud warning (a silent restart-from-zero would be a trap)."""
    ck = str(tmp_path / "ck.npz")
    cfg = _cfg(16, 16, seed=11).with_(samples_per_pass=4)
    pt.render(
        all_scenes["two-spheres"], cfg, out_dir=None, verbose=False,
        checkpoint_path=ck, checkpoint_every=1,
        cancel=lambda: True,  # cancel immediately after checkpointing setup
    )
    # force at least one checkpoint by running 2 passes
    calls = {"n": 0}
    pt.render(
        all_scenes["two-spheres"], cfg, out_dir=None, verbose=False,
        checkpoint_path=ck, checkpoint_every=1,
        cancel=lambda: calls.__setitem__("n", calls["n"] + 1) or calls["n"] > 1,
    )
    assert os.path.exists(ck)
    capsys.readouterr()
    done = pt.render(
        all_scenes["two-spheres"], cfg.with_(seed=99), out_dir=None,
        verbose=False, checkpoint_path=ck,
    )
    err = capsys.readouterr().err
    assert "ignoring checkpoint" in err and "seed" in err
    assert not done.cancelled


def test_ppm_roundtrip(tmp_path):
    g = np.random.default_rng(0)
    pixels = g.uniform(0, 1, (12 * 18, 3)).astype(np.float32)
    img = Image.new(pixels, Resolution(12, 18))
    path = write_ppm(img, "t", 5, 1.25, out_dir=str(tmp_path), make_symlink=False)
    vals, w, h = read_ppm(path)
    assert (w, h) == (18, 12)
    from path_tracer.ops.tonemap import quantize_np

    np.testing.assert_array_equal(vals, quantize_np(pixels)[::-1])


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (96, 144)])
def test_png_roundtrip(tmp_path, shape):
    """The standard-library PNG writer round-trips bit-exactly, through our
    own decoder and, where installed, through PIL."""
    from path_tracer.render.image import decode_png, encode_png, write_png

    g = np.random.default_rng(shape[0])
    rgb = g.integers(0, 256, shape + (3,), dtype=np.uint8)
    data = encode_png(rgb)
    np.testing.assert_array_equal(decode_png(data), rgb)
    try:
        import io

        from PIL import Image as PILImage
    except ImportError:
        pass
    else:
        np.testing.assert_array_equal(
            np.asarray(PILImage.open(io.BytesIO(data))), rgb)
    # write_png: display orientation + gamma, as the viewer serves it
    h, w = shape
    img = Image.new(g.uniform(size=(h * w, 3)), Resolution(h, w))
    path = write_png(img, str(tmp_path / "x.png"))
    with open(path, "rb") as f:
        back = decode_png(f.read())
    want = (np.power(img.to_grid(), np.float32(1 / 2.2)) * 255 + 0.5)
    np.testing.assert_array_equal(back, want.astype(np.uint8))


def test_ppm_body_digit_boundaries():
    """The vectorized ASCII encoder is byte-identical to a naive %d join
    across digit-count boundaries (1/2/3-digit values) and empty input."""
    from path_tracer.ops.tonemap import quantize_np
    from path_tracer.render.image import ppm_body

    g = np.random.default_rng(7)
    cases = [
        np.zeros((0, 3), np.float32),
        np.array([[0.0, 1.0, 0.5]], np.float32),
        # quantize maps these across 0, single-, double-, triple-digit
        np.array([[0.0, 1e-5, 0.0016], [0.02, 0.23, 1.0]], np.float32),
        g.uniform(-0.2, 1.2, (999, 3)).astype(np.float32),
    ]
    for px in cases:
        for reverse in (False, True):
            q = quantize_np(px.reshape(-1, 3))
            if reverse:
                q = q[::-1]
            expected = b"".join(
                b"%d %d %d " % (int(r), int(g_), int(b)) for r, g_, b in q
            )
            assert ppm_body(px, reverse=reverse) == expected


def test_ppm_header_format(tmp_path):
    img = Image.new(np.zeros((6, 3), np.float32), Resolution(2, 3))
    path = write_ppm(img, "sc", 7, 3.9, out_dir=str(tmp_path), make_symlink=False)
    lines = open(path, "rb").read().split(b"\n")
    assert lines[0] == b"P3"
    assert lines[1] == b"# samplesPerPixel: 7, resolution_y: 2, scene_id: sc"
    assert lines[2] == b"# rendering time: 3 s"
    assert lines[3] == b"3 2"
    assert lines[4] == b"255"
    assert os.path.basename(path).endswith("-scene-sc-spp7-res2-.ppm")


def test_image_hash_stability():
    px = np.arange(30, dtype=np.float32).reshape(10, 3) / 30.0
    h1 = Image.new(px, Resolution(2, 5)).hash
    h2 = Image.new(px.copy(), Resolution(2, 5)).hash
    assert h1 == h2
    px2 = px.copy()
    px2[0, 0] += 1e-6
    assert Image.new(px2, Resolution(2, 5)).hash != h1


def test_pixel_chunked_render(all_scenes):
    """pixel_chunk splits the pixel axis across dispatches (the OOM guard
    for full-res triangle scenes in the XLA modes): deterministic, same
    image statistics as unchunked, correct padding crop."""
    scene = all_scenes["cornell"]
    cfg = _cfg(spp=32, backend="fast", pixel_chunk=256)  # 864 px -> 4 chunks
    a = pt.render(scene, cfg, out_dir=None, verbose=False)
    b = pt.render(scene, cfg.with_(pixel_chunk=0), out_dir=None, verbose=False)
    c = pt.render(scene, cfg, out_dir=None, verbose=False)
    np.testing.assert_array_equal(a.image.pixels, c.image.pixels)
    assert a.image.pixels.shape == b.image.pixels.shape == (24 * 36, 3)
    assert a.image.pixels.max() <= 1.0 and a.image.pixels.max() > 0.5
    # chunk RNG folds in the offset: different streams, same statistics
    assert abs(a.image.pixels.mean() - b.image.pixels.mean()) < 0.02
    assert a.stats.num_dispatches == 4 * b.stats.num_dispatches


def test_fused_passes_match_unfused(all_scenes):
    """The hookless fast path (render_passes_fused: all full passes in one
    fori_loop dispatch) must produce the same image as the ordinary
    per-pass loop — a no-op progress callback forces the unfused loop
    while leaving every other knob identical. Same per-pass RNG streams
    (chunk_key(base_key, i)), so the estimator is identical; assert
    bitwise first, which holds because the pass body is the same traced
    computation."""
    scene = all_scenes["two-spheres"]
    # spp > samples_per_pass so full_passes > 1 engages the fused path
    cfg = _cfg(spp=12, backend="fast", samples_per_pass=4)
    fused = pt.render(scene, cfg, out_dir=None, verbose=False)
    assert fused.stats.num_dispatches == 1
    unfused = pt.render(scene, cfg, out_dir=None, verbose=False,
                        progress=lambda u: None, progress_snapshots=False)
    assert unfused.stats.num_dispatches == 3
    assert fused.stats.num_samples == unfused.stats.num_samples
    assert fused.stats.num_rays == unfused.stats.num_rays
    np.testing.assert_array_equal(fused.image.pixels, unfused.image.pixels)


def test_fused_passes_with_remainder(all_scenes):
    """Ragged spp: full passes run fused, the remainder pass runs through
    the ordinary loop; sample accounting stays exact."""
    scene = all_scenes["two-spheres"]
    cfg = _cfg(spp=11, backend="fast", samples_per_pass=4)
    done = pt.render(scene, cfg, out_dir=None, verbose=False)
    assert done.stats.num_samples == 11 * 24 * 36
    assert done.stats.num_dispatches == 2  # fused(2 full) + remainder(3)
    assert done.image.pixels.max() > 0.1

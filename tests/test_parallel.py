"""Multi-device rendering on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

import path_tracer as pt
from path_tracer.parallel.mesh import make_mesh, render_sharded
from path_tracer.utils.config import RenderConfig, Resolution


needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _cfg(**kw):
    return RenderConfig(
        samples_per_pixel=8, resolution=Resolution(24, 36), samples_per_pass=4, **kw
    )


@needs_8
def test_mesh_shapes():
    mesh = make_mesh(8, sample_parallel=2)
    assert mesh.shape == {"dp": 4, "sp": 2}
    assert make_mesh(8).shape == {"dp": 8, "sp": 1}
    with pytest.raises(ValueError):
        make_mesh(8, sample_parallel=3)


@needs_8
def test_sharded_device_fns_are_cached():
    """jit identity is a cache key: building a sharded pass twice must
    return the SAME jitted callable, or every render re-traces and re-loads
    every compiled program. Guards the lru_cache on
    parallel.mesh.make_sharded_pass, for the XLA and the kernel modes."""
    from path_tracer.parallel.mesh import make_sharded_pass

    mesh = make_mesh(2, sample_parallel=1)
    for mode in ("fast", "pallas"):
        p1 = make_sharded_pass(mesh, width=24, height=16, k_full=4, mode=mode)
        p2 = make_sharded_pass(mesh, width=24, height=16, k_full=4, mode=mode)
        assert p1 is p2
        assert make_sharded_pass(mesh, width=24, height=16, k_full=8,
                                 mode=mode) is not p1
    # a different mesh topology must NOT share programs
    assert make_sharded_pass(make_mesh(2, sample_parallel=2), width=24,
                             height=16, k_full=4, mode="fast") is not p1


@needs_8
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_sharded_render_runs(all_scenes, sp):
    done = render_sharded(
        all_scenes["cornell"], _cfg(seed=2), num_devices=8, sample_parallel=sp,
        out_dir=None, verbose=False,
    )
    px = done.image.pixels
    assert px.shape == (24 * 36, 3)
    assert np.isfinite(px).all()
    assert 0.0 <= px.min() and px.max() <= 1.0
    assert px.max() > 0.1
    assert done.stats.num_rays > 0


@needs_8
def test_sharded_deterministic():
    scene = pt.builtin_scenes("meshes")[2]  # two-spheres
    a = render_sharded(scene, _cfg(seed=7), num_devices=8, sample_parallel=2,
                       out_dir=None, verbose=False)
    b = render_sharded(scene, _cfg(seed=7), num_devices=8, sample_parallel=2,
                       out_dir=None, verbose=False)
    np.testing.assert_array_equal(a.image.pixels, b.image.pixels)


@needs_8
def test_sharded_statistically_matches_single_device(all_scenes):
    """Same scene, high spp: sharded and single-device means must agree
    (different RNG streams — statistical, not bitwise)."""
    scene = all_scenes["two-spheres"]
    cfg = RenderConfig(
        samples_per_pixel=64, resolution=Resolution(16, 24), samples_per_pass=16
    )
    a = render_sharded(scene, cfg, num_devices=8, sample_parallel=2,
                       out_dir=None, verbose=False)
    b = pt.render(scene, cfg, out_dir=None, verbose=False)
    # the emissive sphere region is high-signal; compare mean brightness
    assert abs(a.image.pixels.mean() - b.image.pixels.mean()) < 0.02


@needs_8
def test_sharded_exact_spp_ragged(all_scenes):
    """Any spp is honored EXACTLY under sharding (parity: main.rs:157-170)
    — no rounding to whole passes. spp=30 with k=8 across sp=2 runs passes
    (8,8,8,6): the ragged tail rides the same compiled program as a runtime
    limit, masked per-shard. A masking bug (dropped or double-counted tail
    samples) shifts brightness by >=2/30 = 6.7%, well above the 2%
    statistical threshold vs the single-device render."""
    scene = all_scenes["two-spheres"]
    cfg = RenderConfig(
        samples_per_pixel=30, resolution=Resolution(16, 24),
        samples_per_pass=8,
    )
    a = render_sharded(scene, cfg, num_devices=8, sample_parallel=2,
                       out_dir=None, verbose=False)
    assert a.stats.num_samples == 30 * 16 * 24  # exact accounting
    b = pt.render(scene, cfg, out_dir=None, verbose=False)
    assert abs(a.image.pixels.mean() - b.image.pixels.mean()) < 0.02
    # deterministic under the ragged schedule too
    c = render_sharded(scene, cfg, num_devices=8, sample_parallel=2,
                       out_dir=None, verbose=False)
    np.testing.assert_array_equal(a.image.pixels, c.image.pixels)


@needs_8
@pytest.mark.parametrize("dp,sp,spp", [(2, 1, 5), (1, 2, 7)])
def test_sharded_kernel(all_scenes, dp, sp, spp):
    """backend='pallas' under render_sharded on a 2-device mesh: dp shards
    hand the kernel their pixel tiles, sp shards split each pass's RUNTIME
    sample count into per-shard quotas (spp=7 over sp=2: 4 + 3). Sample
    accounting is exact, the image is deterministic, and at max_depth=1
    every sample traces exactly one segment, so the ray count proves no
    sample was lost or repeated across devices (padding lanes trace
    nothing)."""
    from path_tracer.ops.pallas import megakernel

    scene = all_scenes["cornell"]
    res = Resolution(8, 12)
    cfg = RenderConfig(samples_per_pixel=spp, resolution=res,
                       backend="pallas", max_depth=1)
    with megakernel.interpret_mode():
        a = render_sharded(scene, cfg, num_devices=dp * sp,
                           sample_parallel=sp, out_dir=None, verbose=False)
        b = render_sharded(scene, cfg, num_devices=dp * sp,
                           sample_parallel=sp, out_dir=None, verbose=False)
    px = a.image.pixels
    assert px.shape == (res.num_pixels, 3)
    assert np.isfinite(px).all() and px.max() > 0.1
    assert a.stats.num_samples == spp * res.num_pixels
    assert a.stats.num_rays == spp * res.num_pixels
    np.testing.assert_array_equal(px, b.image.pixels)


@needs_8
def test_sharded_kernel_matches_single_device(all_scenes):
    """The sharded kernel keys its random numbers by (pixel, global sample),
    so with dp pixel tiles and the single-device Morton order undone the
    sharded image equals the single-device one."""
    from path_tracer.ops.pallas import megakernel

    scene = all_scenes["cornell"]
    cfg = RenderConfig(samples_per_pixel=3, resolution=Resolution(8, 12),
                       backend="pallas", max_depth=3)
    with megakernel.interpret_mode():
        a = render_sharded(scene, cfg, num_devices=2, sample_parallel=1,
                           out_dir=None, verbose=False)
        b = pt.render(scene, cfg, out_dir=None, verbose=False)
    np.testing.assert_allclose(a.image.pixels, b.image.pixels, atol=1e-6)
    assert a.stats.num_rays == b.stats.num_rays


@needs_8
def test_sharded_pass_rejects_unknown_mode():
    """An unrecognized mode must FAIL LOUDLY instead of silently dispatching
    the exact-arithmetic oracle path (a ~100x slowdown or an out-of-memory
    at scale)."""
    from path_tracer.parallel.mesh import make_sharded_pass

    mesh = make_mesh(8, sample_parallel=2)
    with pytest.raises(ValueError, match="cannot shard"):
        make_sharded_pass(
            mesh, width=24, height=16, k_full=4, mode="pallas3:deadbeef",
        )

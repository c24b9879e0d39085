"""The GPU megakernel against the XLA integrator, in the Pallas interpreter.

Lanewise tests inject the integrator's own threefry uniforms into the
kernel (``megakernel.trace_rays``), so each lane follows the same path in
both implementations. The regenerative entry point (``render_pixels``)
draws from the kernel's hash generator instead, so its tests check sample
accounting, independence from the lane layout, and the compile cache. The
same checks at real widths on the card are ``chip_smoke.py`` phase 2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import path_tracer as pt
from path_tracer.ops import rng as prng
from path_tracer.ops.pallas import megakernel as mk
from path_tracer.render import pipeline
from path_tracer.render.integrator import trace
from path_tracer.render.pipeline import prepare_scene
from path_tracer.render.raygen import camera_arrays, generate_rays

SCENES = ["cornell", "mesh", "two-spheres", "three-spheres", "single-sphere",
          "cartesian"]


def camera_rays(scene, n, seed=0, width=48, height=32):
    """n camera rays through random pixels of a width x height frame."""
    g = np.random.default_rng(seed)
    pix = jnp.asarray(g.integers(0, width * height, n), jnp.int32)
    smp = jnp.asarray(g.integers(0, 4, n), jnp.int32)
    u = jnp.asarray(g.uniform(size=(n, 2)), jnp.float32)
    cam = {k: jnp.asarray(v) for k, v in camera_arrays(scene.camera).items()}
    return generate_rays(pix, smp, u, cam, width, height)


def run_both(scene, o, d, seed=7, max_depth=12):
    """(kernel radiance, kernel rays, XLA radiance, XLA rays) for the same
    rays and the same uniforms; the reference is the XLA ``exact`` mode,
    whose sphere and Möller–Trumbore arithmetic the kernel follows."""
    n = o.shape[0]
    key = jax.random.PRNGKey(seed)
    U = jnp.stack([prng.bounce_uniforms(key, s, (n,), 4)
                   for s in range(max_depth)])
    uk = U.transpose(0, 2, 1).reshape(max_depth * 4, n)
    tables = mk.scene_tables(pt.pack_scene(scene))
    with mk.interpret_mode():
        rad, rays = mk.trace_rays(tables, o, d, uk, max_depth=max_depth)
    res = trace(jnp.asarray(o), jnp.asarray(d), prepare_scene(scene), key,
                max_depth=max_depth, mode="exact")
    return (np.asarray(rad), float(rays), np.asarray(res.radiance),
            float(res.rays_traced))


def assert_lanes_agree(pr, prays, xr, xrays):
    assert prays == xrays
    frac = (np.abs(pr - xr).sum(axis=1) < 1e-3).mean()
    assert frac > 0.995, frac
    np.testing.assert_allclose(pr.mean(0), xr.mean(0), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("sid,max_depth", [
    pytest.param(sid, depth, id=sid if depth == 12 else f"{sid}-depth{depth}")
    for depth in (12, 4) for sid in SCENES
])
def test_kernel_matches_integrator_lanewise(all_scenes, sid, max_depth):
    scene = all_scenes[sid]
    o, d = camera_rays(scene, 512)
    assert_lanes_agree(*run_both(scene, o, d, max_depth=max_depth))


def test_kernel_max_depth(all_scenes):
    """Short depth caps: every sample ends within max_depth segments, and
    kernel and integrator agree lane by lane at each cap."""
    scene = all_scenes["cornell"]
    o, d = camera_rays(scene, 256, seed=5)
    for max_depth in (1, 2, 3):
        pr, prays, xr, xrays = run_both(scene, o, d, max_depth=max_depth)
        assert prays <= 256 * max_depth
        assert_lanes_agree(pr, prays, xr, xrays)


def test_kernel_rays_from_inside_the_scene(all_scenes):
    """Rays in every direction from a point inside the cornell box hit every
    wall, the lights and the glass from all sides."""
    g = np.random.default_rng(0)
    n = 512
    o = np.tile(np.array([0.0, -0.2, 7.0], np.float32), (n, 1))
    d = g.normal(0, 1, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    assert_lanes_agree(*run_both(all_scenes["cornell"], o, d))


@pytest.mark.parametrize("sid", ["mesh", "cornell"])
def test_bounding_sphere_skip_changes_nothing(all_scenes, sid, monkeypatch):
    """The block-level bounding-sphere skip is an optimization only: with
    it on and off the kernel's lanes are bitwise identical. The switch is
    read at trace time, so the launch cache is dropped around it."""
    scene = all_scenes[sid]
    o, d = camera_rays(scene, 384, seed=3)
    on = run_both(scene, o, d, max_depth=6)
    monkeypatch.setattr(mk, "MESH_SKIP", False)
    mk._launch.clear_cache()
    try:
        off = run_both(scene, o, d, max_depth=6)
    finally:
        mk._launch.clear_cache()
    np.testing.assert_array_equal(on[0], off[0])
    assert on[1] == off[1]


def test_kernel_scene_buffers_shapes(all_scenes):
    """Tables have power-of-two rows; quads halve the wall triangles; each
    mesh's [start, end) rows are contiguous, in order, and cover every
    kernel triangle exactly once."""
    packed = pt.pack_scene(all_scenes["mesh"])
    t = {k: np.asarray(v) for k, v in mk.scene_tables(packed).items()}
    for k in ("sph", "tri", "mesh"):
        rows = t[k].shape[0]
        assert rows >= 8 and rows & (rows - 1) == 0
    n_sph, n_mesh = t["counts"]
    assert (n_sph, n_mesh) == (packed.num_spheres, packed.num_meshes)
    quads, covered = mk.detect_quad_pairs(packed)
    n_rows = packed.num_triangles - len(covered) + len(quads)
    ranges = t["mesh"][:n_mesh, [mk.M_START, mk.M_END]].astype(int)
    assert ranges[0, 0] == 0 and ranges[-1, 1] == n_rows
    assert (ranges[1:, 0] == ranges[:-1, 1]).all()
    assert t["tri"][:n_rows, mk.T_QUAD].sum() == len(quads)
    # prev-exclusion ids are the packed triangle indices
    pid = t["tri"][:n_rows, mk.T_PID].astype(int)
    assert (np.diff(pid) > 0).all() and pid[-1] < packed.num_triangles


def test_pretest_kept_when_sphere_does_not_contain_mesh():
    """A mesh whose (buggy-centered, reference) bounding sphere misses part
    of it: rays at the uncovered corner must miss in the kernel exactly as
    in the XLA reference, rays at the covered part must hit."""
    from path_tracer.models.geometry import Mesh
    from path_tracer.models.material import Material, ReflectType
    from path_tracer.models.scene import SceneDescriptor, SceneObject

    # bounds min=(4,-10,0), max=(10,2,0): buggy center = min + max*0.5 =
    # (9,-9,0), radius = 11.05, but the corner (4, 2, 0) is 12.08 away
    tris = np.array(
        [
            [[4, -10, 0], [10, -10, 0], [4, 2, 0]],
            [[10, -10, 0], [10, 2, 0], [4, 2, 0]],
        ],
        np.float32,
    )
    mesh = Mesh.from_triangles(tris)
    corner = np.array([4, 2, 0], np.float32)
    assert np.linalg.norm(corner - mesh.bounding_sphere_center) > \
        mesh.bounding_sphere_radius
    scene = SceneDescriptor(id="t", objects=[SceneObject.from_mesh(
        np.zeros(3, np.float32), mesh,
        Material(np.ones(3), np.full(3, 2.0), ReflectType.DIFFUSE))])
    o = np.asarray([[4.2, 1.5, 5.0], [7.0, -4.0, 5.0]], np.float32)
    d = np.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32)
    pr, prays, xr, xrays = run_both(scene, o, d, max_depth=1)
    assert prays == xrays == 2.0
    np.testing.assert_allclose(pr, xr, atol=1e-6)
    assert pr[0].max() == 0.0  # culled by the pre-test
    assert pr[1].min() > 1.0  # the emissive face seen through the sphere


def test_quad_detector_rejects_non_parallelograms():
    """Coplanar same-material pairs that do NOT form an exact parallelogram
    (trapezoids) must stay triangles; a translated parallelogram must
    collapse — and either way the kernel agrees lane by lane with the XLA
    integrator, which never merges triangles."""
    from path_tracer.models.geometry import Mesh
    from path_tracer.models.material import Material, ReflectType
    from path_tracer.models.scene import SceneDescriptor, SceneObject

    def scene_of(tris, pos=(0.0, 0.0, 0.0)):
        mesh = Mesh.from_triangles(np.asarray(tris, np.float32))
        return SceneDescriptor(id="t", objects=[SceneObject.from_mesh(
            np.asarray(pos, np.float32), mesh,
            Material(np.full(3, 0.8, np.float32), np.full(3, 0.5, np.float32),
                     ReflectType.DIFFUSE))])

    trap = [
        [[-1, -1, 0], [-1, 1, 0], [1, -1, 0]],
        [[1, -1, 0], [-1, 1, 0], [0.5, 1, 0]],
    ]
    q, cov = mk.detect_quad_pairs(pt.pack_scene(scene_of(trap)))
    assert not q and not cov

    a = np.array([0.3, -0.2, 0.1])
    e1 = np.array([1.0, 0.25, 0.0])
    e2 = np.array([-0.125, 1.0, 0.5])
    par = [[a, a + e1, a + e2], [a + e1, a + e1 + e2, a + e2]]
    scene = scene_of(par, pos=(0.5, 0.25, -3.0))
    q, cov = mk.detect_quad_pairs(pt.pack_scene(scene))
    assert len(q) == 1 and len(cov) == 2

    g = np.random.default_rng(1)
    n = 512
    target = (np.asarray([0.5, 0.25, -3.0]) + a + g.uniform(size=(n, 1)) * e1
              + g.uniform(size=(n, 1)) * e2)
    o = np.tile(np.array([0.0, 0.0, 2.0]), (n, 1))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    assert_lanes_agree(*run_both(scene, o.astype(np.float32),
                                 d.astype(np.float32), max_depth=4))


# ---- the regenerative entry point ----


def _regen(scene, pixels, base, quota, *, width=12, height=8, max_depth=12,
           seed=(5, 9)):
    tables = mk.scene_tables(pt.pack_scene(scene))
    cam = {k: jnp.asarray(v) for k, v in camera_arrays(scene.camera).items()}
    with mk.interpret_mode():
        rad, rays = mk.render_pixels(
            tables, cam, jnp.asarray(pixels, jnp.int32),
            jnp.asarray(seed, jnp.uint32), base, quota, width=width,
            height=height, max_depth=max_depth)
    return np.asarray(rad), float(rays)


@pytest.mark.parametrize("spp", [1, 7, 16])
def test_regen_sample_accounting(all_scenes, spp):
    """Each lane traces exactly its quota of samples: at max_depth=1 every
    sample is one segment, so rays == pixels * spp; and since random
    numbers are keyed by (pixel, global sample), a quota split into two
    passes (base 0 and base q) sums to the single pass."""
    scene = all_scenes["cornell"]
    pix = np.arange(96)
    rad, rays = _regen(scene, pix, 0, spp, max_depth=1)
    assert rays == 96 * spp
    assert np.isfinite(rad).all() and rad.max() > 0.0
    full, _ = _regen(scene, pix, 0, spp)
    q = spp // 2
    a, _ = _regen(scene, pix, 0, q)
    b, _ = _regen(scene, pix, q, spp - q)
    np.testing.assert_allclose(a + b, full, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 77, 130])
def test_regen_lane_count_not_a_block_multiple(all_scenes, n):
    """Padding lanes trace nothing, and a pixel's result does not depend on
    which lane or block carries it: a ragged pixel list equals the same
    pixels taken from a shuffled full-block list."""
    scene = all_scenes["two-spheres"]
    g = np.random.default_rng(n)
    full = g.permutation(256)
    kw = dict(width=32, height=8, max_depth=2)
    rad_full, rays_full = _regen(scene, full, 0, 3, **kw)
    sub = full[:n][::-1]
    rad_sub, rays_sub = _regen(scene, sub, 0, 3, **kw)
    np.testing.assert_array_equal(rad_sub, rad_full[:n][::-1])
    assert 3 * n <= rays_sub <= 2 * 3 * n


def test_regen_uniforms_are_uniform():
    """The in-kernel hash generator: uniforms lie in [0, 1) with the right
    mean and variance, and slots, bounces and samples are uncorrelated."""
    skey = mk._mix(jnp.arange(1 << 14, dtype=jnp.uint32) + jnp.uint32(77))
    depth = jnp.zeros(skey.shape, jnp.int32)
    u = np.stack([np.asarray(mk._uniform(skey, depth + b, s))
                  for b in range(3) for s in range(6)])
    assert u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_allclose(u.mean(axis=1), 0.5, atol=0.02)
    np.testing.assert_allclose(u.var(axis=1), 1 / 12, atol=0.01)
    c = np.corrcoef(u)
    assert np.abs(c - np.eye(len(u))).max() < 0.05


def test_regen_matches_xla_statistically(all_scenes):
    """Kernel and XLA fast render the same image up to Monte-Carlo noise
    (different random streams): the frame means agree within 5 standard
    errors."""
    scene = all_scenes["two-spheres"]
    cfg = pt.RenderConfig(samples_per_pixel=64,
                          resolution=pt.Resolution(8, 12), seed=3)
    fast = pt.render(scene, cfg.with_(backend="fast"), out_dir=None,
                     verbose=False).image.pixels
    with mk.interpret_mode():
        kern = pt.render(scene, cfg.with_(backend="pallas"), out_dir=None,
                         verbose=False).image.pixels
    diff = kern.mean() - fast.mean()
    sem = np.sqrt((kern.var() + fast.var()) / kern.size)
    assert abs(diff) < 5 * sem + 1e-3, (diff, sem)


@pytest.mark.parametrize("edit", ["camera", "material"])
def test_no_recompile_after_scene_edit(all_scenes, edit):
    """The scene and camera are kernel inputs: a camera move or a material
    edit renders through the already-compiled programs."""
    import copy

    from jax import monitoring

    scene = copy.deepcopy(all_scenes["cornell"])
    cfg = pt.RenderConfig(samples_per_pixel=2, resolution=pt.Resolution(8, 12),
                          backend="pallas", max_depth=3)
    compiles = []

    def listener(name, *a, **k):
        if name == "/jax/core/compile/backend_compile_duration":
            compiles.append(name)

    with mk.interpret_mode():
        first = pt.render(scene, cfg, out_dir=None, verbose=False)
        if edit == "camera":
            scene.camera.position = scene.camera.position + np.float32(0.25)
        else:
            scene.objects[0].material.color = np.asarray(
                [0.2, 0.9, 0.3], np.float32)
        monitoring.register_event_duration_secs_listener(listener)
        try:
            second = pt.render(scene, cfg, out_dir=None, verbose=False)
        finally:
            monitoring.unregister_event_duration_listener(listener)
    assert not compiles, compiles
    assert not np.array_equal(first.image.pixels, second.image.pixels)


# ---- backend selection ----


@pytest.mark.parametrize("platform,backend,want", [
    ("gpu", "auto", "pallas"),
    ("gpu", "fast", "fast"),
    ("gpu", "pallas", "pallas"),
    ("cpu", "auto", "fast"),
    ("cpu", "exact", "exact"),
])
def test_resolve_backend(monkeypatch, platform, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert pipeline.resolve_backend(backend) == want


@pytest.mark.parametrize("platform,backend", [
    ("rocm", "auto"), ("METAL", "fast"), ("cpu", "pallas"), ("gpu", "mxu"),
])
def test_resolve_backend_rejects(monkeypatch, platform, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(ValueError):
        pipeline.resolve_backend(backend)


def test_pallas_backend_on_cpu_raises(all_scenes):
    """backend='pallas' on a CPU never falls into the interpreter quietly."""
    cfg = pt.RenderConfig(samples_per_pixel=1, resolution=pt.Resolution(4, 6),
                          backend="pallas")
    with pytest.raises(ValueError, match="needs a GPU"):
        pt.render(all_scenes["cornell"], cfg, out_dir=None, verbose=False)
    with mk.interpret_mode():
        assert pipeline.resolve_backend("pallas") == "pallas"
    assert not mk.interpreting()


def test_kernel_on_the_card(gpu):
    """Phase 2 of chip_smoke.py at test width: kernel vs XLA trace on the
    card, compiled for it (no interpreter)."""
    from path_tracer.chipcheck import LANE_FRACTION, kernel_vs_reference

    for sid in ("cornell", "mesh", "two-spheres"):
        frac, k_rays, x_rays, slack = kernel_vs_reference(sid, n=1 << 16)
        assert frac >= LANE_FRACTION, (sid, frac)
        assert abs(k_rays - x_rays) <= slack, (sid, k_rays, x_rays, slack)

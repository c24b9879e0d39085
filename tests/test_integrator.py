"""Wavefront integrator: exact cases, the reference's statistical test, and
expectation parity against the literal recursive oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import path_tracer as pt
from path_tracer.models.material import Material, ReflectType
from path_tracer.models.scene import SceneDescriptor, SceneObject
from path_tracer.render.integrator import trace


def _bufs(scene):
    packed = pt.pack_scene(scene)
    return {k: jnp.asarray(v) for k, v in packed.buffers().items()}


def _trace_mean(scene, o, d, n_samples, seed=0, mode="fast"):
    bufs = _bufs(scene)
    oo = jnp.tile(jnp.asarray(o, jnp.float32)[None, :], (n_samples, 1))
    dd = jnp.tile(jnp.asarray(d, jnp.float32)[None, :], (n_samples, 1))
    res = trace(oo, dd, bufs, jax.random.PRNGKey(seed), mode=mode)
    return np.asarray(res.radiance).mean(axis=0), np.asarray(res.radiance).std(axis=0)


def test_emissive_first_hit_exact():
    """First-hit emission is added deterministically regardless of RNG."""
    scene = SceneDescriptor(
        id="t",
        objects=[
            SceneObject.sphere(
                np.array([0, 0, -3], np.float32),
                1.0,
                Material(np.zeros(3), np.array([5.0, 7.0, 9.0]), ReflectType.DIFFUSE),
            )
        ],
    )
    mean, std = _trace_mean(scene, [0, 0, 0], [0, 0, -1], 16)
    np.testing.assert_allclose(mean, [5, 7, 9], rtol=1e-6)
    np.testing.assert_allclose(std, 0, atol=1e-6)


def test_miss_is_black():
    scene = SceneDescriptor(
        id="t",
        objects=[
            SceneObject.sphere(
                np.array([0, 0, -3], np.float32), 1.0,
                Material(np.ones(3), np.ones(3), ReflectType.DIFFUSE),
            )
        ],
    )
    mean, _ = _trace_mean(scene, [0, 0, 0], [0, 1, 0], 8)
    np.testing.assert_array_equal(mean, 0)


def test_radiance_statistical():
    """The reference's test_radiance (test.rs:146-183): diffuse sphere lit
    from behind the camera by an emission-50 sphere → mean red > 0.3."""
    scene = SceneDescriptor(
        id="t",
        objects=[
            SceneObject.sphere(
                np.array([0, 0, -3], np.float32), 1.0,
                Material(np.array([1.0, 0, 0]), np.zeros(3), ReflectType.DIFFUSE),
            ),
            SceneObject.sphere(
                np.array([0, 0, 10], np.float32), 1.0,
                Material(np.zeros(3), np.full(3, 50.0), ReflectType.DIFFUSE),
            ),
        ],
    )
    # The reference asserts > 0.3 at 10k samples (sem ≈ 0.04 — flaky by
    # design); we use 100k (sem ≈ 0.013, true mean ≈ 0.34) for stability.
    mean, _ = _trace_mean(scene, [0, 0, 0], [0, 0, -1], 100_000)
    assert mean[0] > 0.3, mean
    assert mean[1] == 0.0 and mean[2] == 0.0  # red material only


def test_trace_is_deterministic():
    scene = pt.builtin_scenes("meshes")[4]  # cornell
    m1, _ = _trace_mean(scene, [0, -0.2, 7.8], [0, 0, -1], 256, seed=9)
    m2, _ = _trace_mean(scene, [0, -0.2, 7.8], [0, 0, -1], 256, seed=9)
    np.testing.assert_array_equal(m1, m2)


def test_max_depth_terminates_and_finite():
    """A mirror box (no absorption) must still terminate at MAX_DEPTH."""
    mirror = Material(np.ones(3), np.zeros(3), ReflectType.SPECULAR)
    scene = SceneDescriptor(
        id="t",
        objects=[
            SceneObject.sphere(np.array([0, 0, 0], np.float32), 10.0, mirror),
            SceneObject.sphere(
                np.array([0, 0, -3], np.float32), 1.0,
                Material(np.ones(3) * 0.999, np.ones(3), ReflectType.SPECULAR),
            ),
        ],
    )
    bufs = _bufs(scene)
    o = jnp.zeros((64, 3))
    d = jnp.tile(jnp.asarray([[0.0, 0, -1]]), (64, 1))
    res = trace(o, d, bufs, jax.random.PRNGKey(0))
    assert np.isfinite(np.asarray(res.radiance)).all()
    # 64 rays × at most 12 bounces
    assert int(res.rays_traced) <= 64 * 12


@pytest.mark.parametrize(
    "ray",
    [
        # toward the refracting sphere in cornell (exercises glass + both-branch)
        ([0.0, -0.2, 7.8], [0.138, -0.105, -1.0]),
        # toward the mirror sphere
        ([0.0, -0.2, 7.8], [-0.138, -0.105, -1.0]),
        # toward the back wall (multi-bounce diffuse)
        ([0.0, -0.2, 7.8], [0.0, 0.0, -1.0]),
    ],
)
def test_wavefront_matches_recursive_oracle(all_scenes, ray):
    """Expectation parity: the wavefront transform (incl. always-RR refract)
    must match the literal recursive integrator's mean."""
    from tests import oracle

    scene = all_scenes["cornell"]
    o = np.array(ray[0])
    d = np.array(ray[1])
    d = d / np.linalg.norm(d)

    rand = oracle.make_rand(123)
    n_oracle = 1500
    vals = np.zeros((n_oracle, 3))
    # eps_t=1e-4: the 'fair' oracle (no f32-rounding phantom self-re-hits —
    # see ops.intersect.EPS_TRI_T). The literal t>0 reference semantics are
    # rounding-dependent and not an expectation target.
    for i in range(n_oracle):
        vals[i] = oracle.radiance(scene.objects, o, d, 0, rand, eps_t=1e-4)
    ref_mean = vals.mean(axis=0)
    ref_sem = vals.std(axis=0) / np.sqrt(n_oracle)

    mean, std = _trace_mean(scene, o, d, 30_000, seed=5)
    sem = std / np.sqrt(30_000)
    tol = 4.0 * np.sqrt(ref_sem**2 + sem**2) + 0.01
    assert np.all(np.abs(mean - ref_mean) < tol), (mean, ref_mean, tol)


def test_literal_estimator_differs(all_scenes):
    """estimator='literal' reproduces the reference's t>0 acceptance
    (mod.rs:592). Its phantom self-re-hits make the estimate a function of
    f32 rounding — its sign depends on the platform's arithmetic (see
    PARITY_REPORT.md). This CPU test pins the CPU-arithmetic direction
    (brighter, ~+45% on this back-wall ray) so the literal switch is known
    to actually change the acceptance rule."""
    scene = all_scenes["cornell"]
    bufs = _bufs(scene)
    n = 20_000
    o = jnp.tile(jnp.asarray([0.0, -0.2, 7.8], jnp.float32)[None], (n, 1))
    d = jnp.tile(jnp.asarray([0.0, 0.0, -1.0], jnp.float32)[None], (n, 1))
    ship = trace(o, d, bufs, jax.random.PRNGKey(3)).radiance
    lit = trace(o, d, bufs, jax.random.PRNGKey(3), literal=True).radiance
    m_ship = float(np.asarray(ship).mean())
    m_lit = float(np.asarray(lit).mean())
    sem = float(np.asarray(lit).std()) / np.sqrt(n)
    assert m_lit > m_ship + 3 * sem, (m_ship, m_lit, sem)


def test_literal_estimator_via_render_config(all_scenes, tmp_path):
    """estimator='literal' works end-to-end through render() and rejects
    Pallas modes (which bake the shipped semantics)."""
    from path_tracer.render.pipeline import render
    from path_tracer.utils.config import RenderConfig, Resolution

    scene = all_scenes["cornell"]
    cfg = RenderConfig(
        samples_per_pixel=4, resolution=Resolution(16, 24),
        estimator="literal", seed=7,
    )
    done = render(scene, cfg, out_dir=None, verbose=False)
    grid = done.image.to_grid()
    assert np.isfinite(grid).all() and grid.max() > 0.1

    with pytest.raises(ValueError, match="literal"):
        render(
            scene, cfg, out_dir=None, verbose=False,
            device_buffers={}, device_mode="pallas",
        )
    with pytest.raises(ValueError, match="estimator"):
        RenderConfig(estimator="typo").validated()

"""BSDF sampling units: mirror, glass (Schlick/TIR), cosine diffuse."""

import numpy as np
import jax
import jax.numpy as jnp

from path_tracer.ops.bsdf import (
    reflect,
    sample_bsdf,
    sample_diffuse,
    sample_refract,
)


def _v(*rows):
    return jnp.asarray(np.array(rows, np.float32))


def test_reflect_mirror():
    d = _v([0.6, -0.8, 0.0])
    n = _v([0.0, 1.0, 0.0])
    r = np.asarray(reflect(d, n))
    np.testing.assert_allclose(r, [[0.6, 0.8, 0.0]], atol=1e-6)
    # sign-invariant in n
    r2 = np.asarray(reflect(d, -n))
    np.testing.assert_allclose(r, r2, atol=1e-6)


def test_diffuse_distribution_cosine_weighted():
    """Sampled directions lie in the nl hemisphere with E[cos] = 2/3."""
    n = 200_000
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (n, 2))
    nl = jnp.tile(_v([0.0, 0.0, 1.0]), (n, 1))
    d = np.asarray(sample_diffuse(nl, u[:, 0:1], u[:, 1:2]))
    cos = d[:, 2]
    assert cos.min() >= 0.0
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    # cosine-weighted: pdf = cos/pi → E[cos] = 2/3
    np.testing.assert_allclose(cos.mean(), 2.0 / 3.0, atol=0.005)


def test_refract_snell_and_energy():
    """45° into glass: transmitted angle per Snell; weights unbiased."""
    d = _v([np.sin(np.pi / 4), -np.cos(np.pi / 4), 0.0])
    n = _v([0.0, 1.0, 0.0])
    nl = n
    # force transmission branch (u >= p)
    dir_t, w_t = sample_refract(d, n, nl, jnp.asarray([[0.999]]))
    dir_t = np.asarray(dir_t)[0]
    sin_t = abs(dir_t[0])
    np.testing.assert_allclose(sin_t, np.sin(np.pi / 4) / 1.5, atol=1e-5)
    # force reflection branch
    dir_r, w_r = sample_refract(d, n, nl, jnp.asarray([[0.0]]))
    np.testing.assert_allclose(np.asarray(dir_r)[0], [np.sin(np.pi / 4),
                                                      np.cos(np.pi / 4), 0.0],
                               atol=1e-5)
    # expectation: p*w_r + (1-p)*w_t weights reconstruct re + tr = 1
    ddn = float(-np.cos(np.pi / 4))
    r0 = (0.5 / 2.5) ** 2
    c = 1.0 + ddn
    re = r0 + (1 - r0) * c**5
    p = 0.25 + 0.5 * re
    np.testing.assert_allclose(float(w_r[0, 0]), re / p, rtol=1e-5)
    np.testing.assert_allclose(float(w_t[0, 0]), (1 - re) / (1 - p), rtol=1e-5)


def test_refract_total_internal_reflection():
    """From inside glass beyond the critical angle: always reflect, weight 1."""
    crit = np.arcsin(1.0 / 1.5)
    ang = crit + 0.2
    d = _v([np.sin(ang), np.cos(ang), 0.0])  # leaving glass, hits from inside
    n = _v([0.0, -1.0, 0.0])  # outward normal points back down
    nl = -n  # toward the ray
    direction, weight = sample_refract(d, n, nl, jnp.asarray([[0.9]]))
    dr = np.asarray(direction)[0]
    np.testing.assert_allclose(dr, [np.sin(ang), -np.cos(ang), 0.0], atol=1e-5)
    assert float(weight[0, 0]) == 1.0


def test_sample_bsdf_selects_by_rtype():
    d = _v([0.0, -1.0, 0.0], [0.0, -1.0, 0.0], [0.0, -1.0, 0.0])
    n = _v([0.0, 1.0, 0.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0])
    u = jnp.asarray(np.full((3, 3), 0.3, np.float32))
    out = sample_bsdf(d, n, n, jnp.asarray([0, 1, 2]), u)
    dirs = np.asarray(out.direction)
    np.testing.assert_allclose(dirs[1], [0, 1, 0], atol=1e-6)  # mirror
    assert dirs[0][1] > 0  # diffuse goes up
    assert float(out.weight[0, 0]) == 1.0 and float(out.weight[1, 0]) == 1.0


def test_camera_view_projection_roundtrip():
    """Unprojecting the projection of a world point recovers it (the basis
    of viewport click-picking, viewport_tab.rs:226-249)."""
    from path_tracer.models.camera import Camera

    cam = Camera.looking([0.0, -0.2, 7.8], [0.0, -0.06, -1.0])
    vp = cam.view_projection(1.5).astype(np.float64)
    pt_world = np.array([0.3, -0.5, -2.0, 1.0])
    clip = vp @ pt_world
    ndc = clip[:3] / clip[3]
    assert -1 <= ndc[0] <= 1 and -1 <= ndc[1] <= 1 and 0 <= ndc[2] <= 1
    back = np.linalg.inv(vp) @ np.array([*ndc, 1.0])
    np.testing.assert_allclose(back[:3] / back[3], pt_world[:3], atol=1e-3)

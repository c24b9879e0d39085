"""Exact-geometry unit tests (the reference's test.rs cases + bounds parity)."""

import numpy as np
import jax.numpy as jnp
import pytest

from path_tracer.models.geometry import (
    Mesh,
    bounding_box_to_triangles,
    buggy_bounding_sphere,
    single_quad_mesh,
    sphere_to_triangles,
)
from path_tracer.ops.tonemap import to_int_with_gamma_correction, quantize_np
from tests import oracle


def test_tonemap_exact_values():
    # test.rs:29-35
    vals = jnp.asarray([0.0, 0.5, 0.75, 1.0])
    out = np.asarray(to_int_with_gamma_correction(vals))
    assert out.tolist() == [0, 186, 224, 255]
    assert quantize_np(np.array([0.0, 0.5, 0.75, 1.0])).tolist() == [0, 186, 224, 255]


def test_tonemap_clamps():
    out = np.asarray(to_int_with_gamma_correction(jnp.asarray([-1.0, 2.0])))
    assert out.tolist() == [0, 255]


def test_sphere_frontal_hit():
    # test.rs:43-69: ray at origin toward sphere at (0,0,-3) r=1
    hit = oracle.intersect_sphere(
        np.array([0.0, 0, -3]), 1.0, np.array([0.0, 0, 0]), np.array([0.0, 0, -1])
    )
    t, x, n = hit
    assert t == 2.0
    np.testing.assert_array_equal(x, [0, 0, -2])
    np.testing.assert_array_equal(n, [0, 0, 1])


def test_sphere_miss():
    # test.rs:72-87
    d = np.array([1.0, 0, -1])
    d = d / np.linalg.norm(d)
    assert (
        oracle.intersect_sphere(np.array([0.0, 0, -3]), 1.0, np.array([2.0, 0, 0]), d)
        is None
    )


def test_sphere_ray_inside():
    # test.rs:90-116: origin inside → far root, normal outward at exit
    t, x, n = oracle.intersect_sphere(
        np.array([0.0, 0, 0]), 1.0, np.array([0.0, 0, 0]), np.array([0.0, 0, -1])
    )
    assert t == 1.0
    np.testing.assert_array_equal(x, [0, 0, -1])
    np.testing.assert_array_equal(n, [0, 0, -1])


def test_sphere_tangent():
    # test.rs:119-144: graze counts as hit at distance 3
    t, x, n = oracle.intersect_sphere(
        np.array([0.0, 0, -3]), 1.0, np.array([0.0, 1, 0]), np.array([0.0, 0, -1])
    )
    assert t == 3.0
    np.testing.assert_array_equal(x, [0, 1, -3])
    np.testing.assert_array_equal(n, [0, 1, 0])


def test_buggy_bounding_sphere_parity():
    # The right Cornell wall (x-axis quad, ±2 in y, ±8.8 in z): the shipped
    # cornell.json records center (0,-1,-4.4), radius 13.536618.
    mesh = single_quad_mesh(2.0, 8.8, 0, True)
    np.testing.assert_allclose(mesh.bounding_sphere_center, [0, -1, -4.4], atol=1e-6)
    np.testing.assert_allclose(mesh.bounding_sphere_radius, 13.536618, rtol=1e-6)


def test_bounding_sphere_center_is_buggy_not_midpoint():
    c, r = buggy_bounding_sphere(np.array([1.0, 1, 1]), np.array([3.0, 3, 3]))
    # buggy: min + max*0.5 = 2.5 (true midpoint would be 2.0)
    np.testing.assert_array_equal(c, [2.5, 2.5, 2.5])


def test_bounding_box_triangulation():
    tris = bounding_box_to_triangles(np.zeros(3), np.ones(3))
    assert tris.shape == (12, 3, 3)
    # every AABB face hit from outside along -z
    hit = oracle.intersect_triangles(tris, np.zeros(3), np.array([0.5, 0.5, 2.0]),
                                     np.array([0.0, 0.0, -1.0]))
    assert hit is not None and np.isclose(hit[0], 1.0)


def test_sphere_tessellation_count():
    # 16 stacks × 32 slices: poles contribute 1 tri each, others 2
    tris = sphere_to_triangles(1.0)
    assert tris.shape[0] == 32 * 1 + 32 * 1 + 14 * 32 * 2
    radii = np.linalg.norm(tris.reshape(-1, 3), axis=1)
    np.testing.assert_allclose(radii, 1.0, atol=1e-5)


def test_quad_winding_flip():
    m1 = single_quad_mesh(1.0, 1.0, 2, True)  # z-axis quad
    m2 = single_quad_mesh(1.0, 1.0, 2, False)
    n1 = np.cross(m1.triangles[0, 1] - m1.triangles[0, 0],
                  m1.triangles[0, 2] - m1.triangles[0, 0])
    n2 = np.cross(m2.triangles[0, 1] - m2.triangles[0, 0],
                  m2.triangles[0, 2] - m2.triangles[0, 0])
    assert np.sign(n1[2]) == -np.sign(n2[2])


def test_mesh_from_triangles_bounds():
    tris = np.array([[[0, 0, 0], [1, 0, 0], [0, 2, 0]]], np.float32)
    mesh = Mesh.from_triangles(tris)
    assert mesh.num_triangles == 1
    assert mesh.bounding_box.shape == (12, 3, 3)

"""Packed-SoA intersection vs the scalar oracle, and exact-vs-fast parity."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import path_tracer as pt
from path_tracer.ops.intersect import intersect_scene


def _random_rays(scene, n, seed=0):
    """Rays from random points near the camera toward random scene points."""
    g = np.random.default_rng(seed)
    cam = scene.camera
    o = cam.position[None, :] + g.normal(0, 0.3, (n, 3)).astype(np.float32)
    target = g.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = target - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _device_scene(scene):
    packed = pt.pack_scene(scene)
    return {k: jnp.asarray(v) for k, v in packed.buffers().items()}


@pytest.mark.parametrize("sid", ["cornell", "two-spheres", "cartesian", "mesh"])
def test_intersect_matches_oracle(all_scenes, sid):
    from tests import oracle

    scene = all_scenes[sid]
    n = 100 if sid == "mesh" else 200
    o, d = _random_rays(scene, n, seed=42)
    bufs = _device_scene(scene)
    hit = intersect_scene(jnp.asarray(o), jnp.asarray(d), bufs, mode="exact")
    t = np.asarray(hit.t)
    obj = np.asarray(hit.obj)
    normal = np.asarray(hit.normal)

    mismatch_id = 0
    for i in range(n):
        ref = oracle.intersect_scene(scene.objects, o[i].astype(np.float64),
                                     d[i].astype(np.float64))
        if ref is None:
            assert not hit.found[i], f"ray {i}: oracle miss but we hit obj {obj[i]}"
            continue
        ref_id, (ref_t, _, ref_n) = ref
        assert np.isfinite(t[i]), f"ray {i}: oracle hit obj {ref_id} but we missed"
        np.testing.assert_allclose(t[i], ref_t, rtol=2e-4, atol=2e-4)
        if obj[i] != ref_id:
            mismatch_id += 1  # knife-edge f32-vs-f64 disagreements allowed, rare
        else:
            np.testing.assert_allclose(normal[i], ref_n, rtol=1e-3, atol=1e-3)
    assert mismatch_id <= max(1, n // 100)


@pytest.mark.parametrize("sid", ["cornell", "mesh"])
def test_exact_vs_fast_consistency(all_scenes, sid):
    scene = all_scenes[sid]
    o, d = _random_rays(scene, 500, seed=7)
    bufs = _device_scene(scene)
    h1 = intersect_scene(jnp.asarray(o), jnp.asarray(d), bufs, mode="exact")
    h2 = intersect_scene(jnp.asarray(o), jnp.asarray(d), bufs, mode="fast")
    both = np.asarray(h1.found) & np.asarray(h2.found)
    assert (np.asarray(h1.found) == np.asarray(h2.found)).mean() > 0.99
    t1, t2 = np.asarray(h1.t)[both], np.asarray(h2.t)[both]
    np.testing.assert_allclose(t1, t2, rtol=1e-3, atol=1e-3)
    assert (np.asarray(h1.obj)[both] == np.asarray(h2.obj)[both]).mean() > 0.99


def test_mesh_pretest_gates_triangles(all_scenes):
    """A ray that would hit mesh triangles but misses the (buggy) bounding
    sphere must report a miss — reference parity (mod.rs:265-279)."""
    from tests import oracle

    scene = all_scenes["mesh"]
    # fire many rays at the mesh object; oracle and packed must agree ray-by-ray
    obj0 = scene.objects[0]
    g = np.random.default_rng(3)
    n = 100
    o = (obj0.position + np.array([0, 0, 6], np.float32))[None, :] + g.normal(
        0, 1.5, (n, 3)
    ).astype(np.float32)
    target = obj0.position[None, :] + g.normal(0, 1.0, (n, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    bufs = _device_scene(scene)
    hit = intersect_scene(jnp.asarray(o.astype(np.float32)), jnp.asarray(d), bufs,
                          mode="exact")
    for i in range(n):
        ref = oracle.intersect_scene(scene.objects, o[i].astype(np.float64),
                                     d[i].astype(np.float64))
        if ref is None:
            assert not bool(hit.found[i])
        else:
            assert bool(hit.found[i])
            np.testing.assert_allclose(hit.t[i], ref[1][0], rtol=5e-4, atol=5e-4)


def test_reverse_order_tie_break():
    """Two coincident spheres: the higher object index must win (reference
    scans objects in reverse keeping strictly-closer hits)."""
    from path_tracer.models.material import Material, ReflectType
    from path_tracer.models.scene import SceneDescriptor, SceneObject

    mat = Material(np.ones(3), np.zeros(3), ReflectType.DIFFUSE)
    scene = SceneDescriptor(
        id="tie",
        objects=[
            SceneObject.sphere(np.array([0, 0, -3], np.float32), 1.0, mat),
            SceneObject.sphere(np.array([0, 0, -3], np.float32), 1.0, mat),
        ],
    )
    bufs = _device_scene(scene)
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    for mode in ("exact", "fast"):
        hit = intersect_scene(o, d, bufs, mode=mode)
        assert int(hit.obj[0]) == 1


def test_intersect_bounds_uses_aabb_for_meshes(all_scenes):
    """intersect_bounds parity (mod.rs:282-290): a ray that misses a mesh's
    triangles but crosses its AABB must still report the AABB hit."""
    from path_tracer.ops.host_intersect import (
        intersect_bounds_packed,
        intersect_packed,
        pack_scene_bounds,
    )

    scene = all_scenes["mesh"]
    packed = pt.pack_scene(scene)
    bbox_tris, bbox_obj = pack_scene_bounds(scene)
    obj0 = scene.objects[0]  # the mctri mesh
    # aim at an AABB corner region likely devoid of triangles
    from path_tracer.models.geometry import mesh_bounds

    mn, mx = mesh_bounds(obj0.mesh.triangles)
    corner = mx + obj0.position
    # just inside the AABB's xy footprint at its top corner (no triangles
    # fill the corner of a round-ish mesh), firing -z through the box
    o = corner + np.array([-0.01, -0.01, 3.0], np.float32)
    d = np.array([0.0, 0.0, -1.0])
    bounds_hit = intersect_bounds_packed(packed, bbox_tris, bbox_obj, o, d)
    assert bounds_hit is not None and bounds_hit[1] == 0, bounds_hit
    # jnp twin agrees
    from path_tracer.ops.intersect import intersect_bounds

    bufs = {k: jnp.asarray(v) for k, v in packed.buffers().items()}
    bb = {
        "tri_v": jnp.asarray(bbox_tris),
        "tri_order": jnp.asarray(np.arange(len(bbox_obj), dtype=np.int32)),
        "tri_obj": jnp.asarray(bbox_obj),
    }
    t, obj = intersect_bounds(
        jnp.asarray(o, jnp.float32)[None, :], jnp.asarray(d, jnp.float32)[None, :],
        bufs, bb,
    )
    assert int(obj[0]) == 0
    np.testing.assert_allclose(float(t[0]), bounds_hit[0], rtol=1e-3)

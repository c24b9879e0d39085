"""Randomized-scene lanewise agreement: the GPU kernel must agree with the
XLA integrator on arbitrary (valid) scenes, not just the six built-ins —
this sweeps packing, winner selection, quad collapsing, and bounding-sphere
gating across random geometry."""

import numpy as np
import pytest

from path_tracer.models.geometry import Mesh
from path_tracer.models.material import Material, ReflectType
from path_tracer.models.scene import SceneDescriptor, SceneObject

from tests.test_pallas import assert_lanes_agree, run_both


def _random_scene(seed: int) -> SceneDescriptor:
    g = np.random.default_rng(seed)
    objs = []
    kinds = [ReflectType.DIFFUSE, ReflectType.SPECULAR, ReflectType.REFRACT]

    def mat(emissive=False):
        color = g.uniform(0.1, 1.0, 3).astype(np.float32)
        emis = (g.uniform(1.0, 8.0, 3).astype(np.float32)
                if emissive else np.zeros(3, np.float32))
        return Material(color, emis, kinds[int(g.integers(0, 3))])

    # spheres (one emissive so paths terminate with signal)
    for i in range(int(g.integers(2, 5))):
        objs.append(SceneObject.sphere(
            g.uniform(-4, 4, 3).astype(np.float32),
            float(g.uniform(0.3, 1.5)), mat(emissive=(i == 0)),
        ))

    # a random free triangle soup
    tris = g.uniform(-4, 4, (int(g.integers(2, 6)), 3, 3)).astype(np.float32)
    objs.append(SceneObject.from_mesh(
        g.uniform(-1, 1, 3).astype(np.float32),
        Mesh.from_triangles(tris), mat(),
    ))

    # a parallelogram pair (exercises the quad collapse on random geometry)
    a = g.uniform(-3, 3, 3).astype(np.float32)
    e1 = g.uniform(-2, 2, 3).astype(np.float32)
    e2 = g.uniform(-2, 2, 3).astype(np.float32)
    par = np.stack([
        np.stack([a, a + e1, a + e2]),
        np.stack([a + e1, a + e1 + e2, a + e2]),
    ]).astype(np.float32)
    objs.append(SceneObject.from_mesh(
        np.zeros(3, np.float32), Mesh.from_triangles(par), mat(),
    ))
    return SceneDescriptor(id=f"fuzz{seed}", objects=objs)


@pytest.mark.parametrize("seed", [11, 23, 47, 5, 8, 13, 31, 64])
def test_fuzzed_scene_kernel_matches_integrator(seed):
    scene = _random_scene(seed)
    g = np.random.default_rng(seed + 1)
    n = 1024
    # rays from a sphere of radius 10 around the scene toward random points
    # inside it, so most lanes hit geometry
    o = g.normal(0, 1, (n, 3))
    o = 10.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = g.uniform(-3, 3, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pr, prays, xr, xrays = run_both(scene, o.astype(np.float32),
                                    d.astype(np.float32), max_depth=6)
    assert np.isfinite(pr).all()
    assert_lanes_agree(pr, prays, xr, xrays)

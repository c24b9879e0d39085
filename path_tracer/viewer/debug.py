"""Click-to-debug ray probe.

Parity with the render tab's ``test_scene_ray`` (``render_tab.rs:177-205``):
derives a camera ray from a relative canvas position (note the reference's
mirrored ``sx = 1 - 2*relx`` — preserved) and reports the hit object's
material and distance.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from path_tracer.models.camera import normalize_f32
from path_tracer.models.scene import SceneDescriptor, pack_scene
from path_tracer.ops.host_intersect import intersect_packed


@dataclass
class RayProbeResult:
    object_id: int
    distance: float
    material: object
    point: np.ndarray


def test_scene_ray(
    relx: float, rely: float, scene: SceneDescriptor, packed=None, verbose=True
) -> RayProbeResult | None:
    """relx, rely in [0,1] relative canvas coords (render_tab.rs:177-205)."""
    cam = scene.camera
    sx = 1.0 - relx * 2.0  # mirrored vs the sampler — reference behaviour
    sy = rely * 2.0 - 1.0
    su, sv = cam.orthogonals()
    sensor_pos = cam.position + su * np.float32(sx) + sv * np.float32(sy)
    lens_center = cam.lens_center()
    direction = normalize_f32(lens_center - sensor_pos)

    packed = packed if packed is not None else pack_scene(scene)
    hit = intersect_packed(packed, lens_center, direction)
    if hit is None:
        if verbose:
            print("No hit")
        return None
    t, obj_id, point, _ = hit
    material = scene.objects[obj_id].material
    if verbose:
        print(f"Hit {material} object at distance {t}")
    return RayProbeResult(
        object_id=obj_id, distance=t, material=material, point=point
    )

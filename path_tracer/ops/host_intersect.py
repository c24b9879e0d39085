"""Host-side (NumPy) single-ray scene intersection over packed SoA buffers.

For interactive tooling — viewport picking, orbit-point lookup, the
click-to-debug ray probe — where a device round-trip per click is silly.
Vectorized over primitives, scalar over rays. Same semantics as
ops.intersect (epsilons, pre-test, reverse-scan tie-break via packed order).
"""

from __future__ import annotations

import numpy as np

from path_tracer.models.scene import ScenePacked

EPS_SPHERE = 1e-4
EPS_TRI_DET = 1e-4
EPS_TRI_T = 1e-4


def sphere_t(center: np.ndarray, radius: np.ndarray, o, d) -> np.ndarray:
    """[S,3],[S] → t [S] (inf = miss)."""
    op = center - o[None, :]
    b = op @ d
    det = b * b - np.einsum("sk,sk->s", op, op) + radius * radius
    sq = np.sqrt(np.maximum(det, 0.0))
    t_near, t_far = b - sq, b + sq
    t = np.where(t_near >= EPS_SPHERE, t_near, np.where(t_far >= EPS_SPHERE, t_far, np.inf))
    # radius <= 0 marks padding entries (1e30 sentinel centers) — force miss
    return np.where((det < 0.0) | (radius <= 0.0), np.inf, t)


def triangle_t(tri_v: np.ndarray, o, d, eps_t: float = EPS_TRI_T) -> np.ndarray:
    """[T,3,3] → t [T] (inf = miss)."""
    a = tri_v[:, 0]
    e1 = tri_v[:, 1] - a
    e2 = tri_v[:, 2] - a
    pvec = np.cross(d[None, :], e2)
    det = np.einsum("tk,tk->t", e1, pvec)
    ok = np.abs(det) >= EPS_TRI_DET
    inv = 1.0 / np.where(ok, det, 1.0)
    tvec = o[None, :] - a
    u = np.einsum("tk,tk->t", tvec, pvec) * inv
    qvec = np.cross(tvec, e1)
    v = (qvec @ d) * inv
    t = np.einsum("tk,tk->t", e2, qvec) * inv
    ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > eps_t)
    return np.where(ok, t, np.inf)


def intersect_packed(packed: ScenePacked, o, d):
    """Closest hit → (t, object_index, point, normal) or None."""
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    t_s = sphere_t(packed.sph_center.astype(np.float64),
                   packed.sph_radius.astype(np.float64), o, d)
    t_b = sphere_t(packed.bnd_center.astype(np.float64),
                   packed.bnd_radius.astype(np.float64), o, d)
    t_t = triangle_t(packed.tri_v.astype(np.float64), o, d)
    gate = np.isfinite(t_b)[packed.tri_mesh]
    t_t = np.where(gate, t_t, np.inf)

    i_s = int(np.argmin(t_s))
    i_t = int(np.argmin(t_t))
    d_s, d_t = t_s[i_s], t_t[i_t]
    if not np.isfinite(d_s) and not np.isfinite(d_t):
        return None
    sph_wins = d_s < d_t or (
        d_s == d_t and packed.sph_order[i_s] < packed.tri_order[i_t]
    )
    t = d_s if sph_wins else d_t
    point = o + d * t
    if sph_wins:
        n = point - packed.sph_center[i_s]
        n = n / np.linalg.norm(n)
        obj = int(packed.sph_obj[i_s])
    else:
        n = packed.tri_normal[i_t].astype(np.float64)
        obj = int(packed.tri_obj[i_t])
    return float(t), obj, point.astype(np.float32), n.astype(np.float32)


def intersect_bounds_packed(packed: ScenePacked, bbox_tris, bbox_obj, o, d):
    """Parity with ``SceneObjectData::intersect_bounds`` (mod.rs:282-290):
    spheres as-is, meshes via their AABB-as-12-triangles. bbox_tris [12M,3,3]
    and bbox_obj [12M] come from pack_scene_bounds(). Returns (t, obj) or None."""
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    t_s = sphere_t(packed.sph_center.astype(np.float64),
                   packed.sph_radius.astype(np.float64), o, d)
    t_bb = triangle_t(np.asarray(bbox_tris, np.float64), o, d, eps_t=0.0)
    best = None
    for i, t in enumerate(t_s):
        if np.isfinite(t) and (best is None or t < best[0]):
            if packed.sph_obj[i] >= 0:
                best = (float(t), int(packed.sph_obj[i]))
    for i, t in enumerate(t_bb):
        if np.isfinite(t) and (best is None or t < best[0]):
            best = (float(t), int(bbox_obj[i]))
    return best


def pack_scene_bounds(scene) -> tuple[np.ndarray, np.ndarray]:
    """(bbox_tris [12M,3,3], bbox_obj [12M]) for mesh objects, translated."""
    tris, objs = [], []
    for idx, obj in enumerate(scene.objects):
        if obj.is_sphere:
            continue
        moved = obj.mesh.bounding_box + obj.position[None, None, :]
        tris.append(moved)
        objs.extend([idx] * len(moved))
    if not tris:
        return np.zeros((0, 3, 3), np.float32), np.zeros(0, np.int32)
    return np.concatenate(tris).astype(np.float32), np.asarray(objs, np.int32)

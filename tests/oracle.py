"""Pure-Python scalar oracle: a literal re-statement of the reference's
tracer semantics (``/root/reference/src/render/mod.rs:412-857``), written
fresh in numpy scalars. Deliberately UN-vectorized and recursive — it exists
to check that the wavefront transform preserves the estimator, and that
the packed-SoA intersection reproduces scan order, epsilons and tie-breaks.

The RNG is injected (a ``rand() -> float`` callable), so tests can use the
reference's MOCK_RANDOM fixture sequence or a seeded generator.
"""

from __future__ import annotations

import numpy as np

MAX_DEPTH = 12
EPS = 1e-4
F = np.float32


def _norm(v):
    return v / np.sqrt(np.dot(v, v))


def intersect_sphere(center, radius, o, d):
    """smallpt quadratic (mod.rs:412-438). Returns (t, point, normal) or None."""
    op = center - o
    b = np.dot(op, d)
    det = b * b - np.dot(op, op) + radius * radius
    if det < 0:
        return None
    det = np.sqrt(det)
    if b - det >= EPS:
        t = b - det
    elif b + det >= EPS:
        t = b + det
    else:
        return None
    x = o + d * t
    return (t, x, _norm(x - center))


def intersect_triangles(tris, offset, o, d, eps_t=0.0):
    """Möller–Trumbore closest hit over a triangle list (mod.rs:554-616).

    eps_t: minimum accepted distance. 0.0 = literal reference semantics
    (t > 0 — which phantom-re-hits the departed surface ~half the time, see
    ops.intersect.EPS_TRI_T); 1e-4 = the 'fair' unbiased variant used as the
    expectation target for wavefront parity tests."""
    best = None
    for tri in tris:
        a, b_, c = tri[0] + offset, tri[1] + offset, tri[2] + offset
        e1, e2 = b_ - a, c - a
        pvec = np.cross(d, e2)
        det = np.dot(e1, pvec)
        if abs(det) < 1e-4:  # USE_CULLING = false
            continue
        inv = 1.0 / det
        tvec = o - a
        u = np.dot(tvec, pvec) * inv
        if u < 0.0 or u > 1.0:
            continue
        qvec = np.cross(tvec, e1)
        v = np.dot(d, qvec) * inv
        if v < 0.0 or (u + v) > 1.0:
            continue
        t = np.dot(e2, qvec) * inv
        if t <= eps_t:
            continue
        if best is None or t < best[0]:
            best = (t, o + d * t, _norm(np.cross(e1, e2)))
    return best


def intersect_object(obj, o, d, eps_t=0.0):
    """SceneObjectData::intersect (mod.rs:261-280), incl. bounding pre-test."""
    if obj.is_sphere:
        return intersect_sphere(obj.position, obj.radius, o, d)
    pre = intersect_sphere(
        obj.mesh.bounding_sphere_center + obj.position,
        obj.mesh.bounding_sphere_radius,
        o,
        d,
    )
    if pre is None:
        return None
    return intersect_triangles(obj.mesh.triangles, obj.position, o, d, eps_t)


def intersect_scene(objects, o, d, eps_t=0.0):
    """Reverse-order scan keeping strictly-closer hits (mod.rs:631-659).
    Returns (object_index, (t, point, normal)) or None."""
    best = None
    for i in range(len(objects) - 1, -1, -1):
        hit = intersect_object(objects[i], o, d, eps_t)
        if hit is not None and (best is None or hit[0] < best[1][0]):
            best = (i, hit)
    return best


def radiance(objects, o, d, depth, rand, eps_t=0.0):
    """Literal recursive integrator (mod.rs:661-792), incl. the depth<=2
    BOTH-branches refraction — the behaviour the wavefront must match in
    expectation."""
    res = intersect_scene(objects, o, d, eps_t)
    if res is None:
        return np.zeros(3)
    obj_id, (t, x, n) = res
    mat = objects[obj_id].material
    color = mat.color.astype(np.float64).copy()
    emission = mat.emission.astype(np.float64)
    max_refl = color.max()
    nl = n if np.dot(n, d) < 0 else -n

    new_depth = depth + 1
    if new_depth > 5:
        if rand() < max_refl and new_depth < MAX_DEPTH:
            color = color / max_refl
        else:
            return emission

    rt = int(mat.reflect_type)
    if rt == 0:  # Diffuse
        r1 = 2.0 * np.pi * rand()
        r2 = rand()
        r2s = np.sqrt(r2)
        w = nl
        up = np.array([0.0, 1.0, 0.0]) if abs(w[0]) > 0.1 else np.array([1.0, 0.0, 0.0])
        u = _norm(np.cross(up, w))
        v = np.cross(w, u)
        nd = _norm(u * np.cos(r1) * r2s + v * np.sin(r1) * r2s + w * np.sqrt(1.0 - r2))
        return emission + color * radiance(objects, x, nd, new_depth, rand, eps_t)
    if rt == 1:  # Specular
        nd = d - n * 2.0 * np.dot(n, d)
        return emission + color * radiance(objects, x, nd, new_depth, rand, eps_t)

    # Refract
    refl = d - n * 2.0 * np.dot(n, d)
    into = np.dot(n, nl) > 0
    nc, nt = 1.0, 1.5
    nnt = nc / nt if into else nt / nc
    ddn = np.dot(d, nl)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    if cos2t < 0:  # total internal reflection
        return emission + color * radiance(objects, x, refl, new_depth, rand, eps_t)
    tdir = _norm(d * nnt - n * ((1.0 if into else -1.0) * (ddn * nnt + np.sqrt(cos2t))))
    a, b = nt - nc, nt + nc
    r0 = a * a / (b * b)
    c = 1.0 - (-ddn if into else np.dot(tdir, n))
    re = r0 + (1.0 - r0) * c**5
    tr = 1.0 - re
    p = 0.25 + 0.5 * re
    if new_depth > 2:
        if rand() < p:
            return emission + color * radiance(objects, x, refl, new_depth, rand, eps_t) * (re / p)
        return emission + color * radiance(objects, x, tdir, new_depth, rand, eps_t) * (
            tr / (1.0 - p)
        )
    return emission + color * (
        radiance(objects, x, refl, new_depth, rand, eps_t) * re
        + radiance(objects, x, tdir, new_depth, rand, eps_t) * tr
    )


def make_rand(seed: int):
    g = np.random.default_rng(seed)
    return lambda: g.random()


def make_mock_rand():
    """The reference MOCK_RANDOM fixture: fixed 9-value cycle (mod.rs:31-55)."""
    from path_tracer.ops.rng import MOCK_RANDOMS

    state = {"i": 0}

    def rand():
        v = float(MOCK_RANDOMS[state["i"] % len(MOCK_RANDOMS)])
        state["i"] += 1
        return v

    return rand

"""Ray/scene intersection — brute force over SoA buffers, in two forms.

Semantics parity (``src/render/mod.rs:412-438,554-616,631-659``):

- Sphere: smallpt quadratic, eps = 1e-4, nearer root first, outward normal.
- Triangle: Möller–Trumbore, determinant eps 1e-4, culling off, u,v in
  [0,1] inclusive, u+v <= 1, distance strictly > 0, closest hit, face normal
  ``normalize((b-a)×(c-a))``.
- Mesh objects are gated by a bounding-sphere pre-test (including the
  reference's buggy sphere center — see models.geometry).
- Scene scan order: objects in reverse index order keeping strictly-closer
  hits. The packed buffers are laid out in that order (models.scene), so a
  first-wins argmin reproduces the tie-breaking exactly.

Two computational forms with identical semantics:

- ``exact``: the literal arithmetic grouping of the reference (broadcasting
  ``[R,P,3]`` intermediates) — the correctness oracle, used by tests, the
  debug ray probe, and viewport picking.
- ``fast``: matmul regrouping. Every Möller–Trumbore quantity is affine in
  the per-ray feature vector ``[d, o×d, o, 1]``:

      det       = -d·N                        (N = e1×e2)
      u·det     = (o×d)·e2 - d·(e2×a)
      v·det     = -(o×d)·e1 - d·(a×e1)
      t·det     = o·N - a·N

  so ray×triangle intersection collapses into a handful of ``[R,3]@[3,T]``
  contractions, with only elementwise work and a min-reduction after. The sphere quadratic regroups the same way
  (b = c·d - o·d, |op|² = |c|² - 2 o·c + |o|²). No ``[R,T,3]`` intermediates.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

EPS_SPHERE = 1e-4
EPS_TRI_DET = 1e-4
# Minimum accepted triangle-hit distance. The reference accepts any t > 0
# (mod.rs:592) — but its hit points are f32-rounded onto either side of the
# surface, so ~half of all bounces phantom-re-hit the departed triangle at
# t≈0⁺, re-multiplying albedo and RE-ADDING emission (mesh lights get double
# counted). That behaviour is rounding-dependent and unreproducible by
# design; we use the sphere path's epsilon (1e-4, matching mod.rs:414) for an
# unbiased, implementation-independent estimator. See tests/test_integrator.
EPS_TRI_T = 1e-4
INF = jnp.float32(jnp.inf)

_PRECISION = lax.Precision.HIGHEST


def set_precision(name: str) -> None:
    """Set the matmul precision for the XLA intersection paths (process-
    global; wired from RenderConfig.f32_precision). "highest" = exact f32
    (default; geometry needs the mantissa); "high" and "default" trade
    accuracy for tensor-core throughput on the [R,3]@[3,T] contractions
    (on an H100, "default" is TF32: about three decimal digits)."""
    global _PRECISION
    _PRECISION = {
        "highest": lax.Precision.HIGHEST,
        "high": lax.Precision.HIGH,
        "default": lax.Precision.DEFAULT,
    }[name]


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _matmul(a, b):
    return jnp.matmul(a, b, precision=_PRECISION)


class Hit(NamedTuple):
    """Per-ray closest hit over the whole scene (misses: t = inf)."""

    t: jax.Array  # [R] distance (inf = miss)
    found: jax.Array  # [R] bool
    point: jax.Array  # [R,3] intersection
    normal: jax.Array  # [R,3] geometric outward normal (as the reference)
    color: jax.Array  # [R,3] material color
    emission: jax.Array  # [R,3]
    rtype: jax.Array  # [R] i32 ReflectType
    obj: jax.Array  # [R] i32 original object index (-1 = miss)
    tri: jax.Array  # [R] i32 packed triangle index of the hit (-1 = sphere/miss)


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------


def sphere_distances_exact(o, d, center, radius):
    """Literal reference grouping: op = c - o, b = op·d. [R,S]."""
    op = center[None, :, :] - o[:, None, :]  # [R,S,3]
    b = _dot(op, d[:, None, :])  # [R,S]
    det = b * b - _dot(op, op) + radius[None, :] ** 2
    return _select_root(b, det, radius)


def sphere_distances_fast(o, d, center, radius):
    """Regrouped (matmul) form: identical semantics, no [R,S,3] buffers."""
    cd = _matmul(d, center.T)  # [R,S]
    oc = _matmul(o, center.T)  # [R,S]
    od = _dot(o, d)[:, None]  # [R,1]
    oo = _dot(o, o)[:, None]
    cc = _dot(center, center)[None, :]
    b = cd - od
    det = b * b - (cc - 2.0 * oc + oo) + radius[None, :] ** 2
    return _select_root(b, det, radius)


def _select_root(b, det, radius):
    """Nearer-root-first with eps (mod.rs:414-428); miss → inf. radius == 0
    marks padding entries (their 1e30 centers make the quadratic degenerate
    to inf/nan) — forced miss."""
    sq = jnp.sqrt(jnp.maximum(det, 0.0))
    t_near = b - sq
    t_far = b + sq
    t = jnp.where(t_near >= EPS_SPHERE, t_near, jnp.where(t_far >= EPS_SPHERE, t_far, INF))
    return jnp.where((det < 0.0) | (radius[None, :] <= 0.0), INF, t)


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------


def triangle_distances_exact(o, d, tri_v, eps_tri_t: float = EPS_TRI_T):
    """Literal Möller–Trumbore with [R,T,3] intermediates. Returns t [R,T].

    eps_tri_t = 0.0 gives the reference's literal ``t > 0`` acceptance
    (mod.rs:592) for the literal-reference estimator mode."""
    a = tri_v[:, 0]
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])  # [R,T,3]
    det = _dot(e1[None, :, :], pvec)  # [R,T]
    valid = jnp.abs(det) >= EPS_TRI_DET
    inv_det = 1.0 / jnp.where(valid, det, 1.0)
    tvec = o[:, None, :] - a[None, :, :]  # [R,T,3]
    u = _dot(tvec, pvec) * inv_det
    valid &= (u >= 0.0) & (u <= 1.0)
    qvec = jnp.cross(tvec, e1[None, :, :])  # [R,T,3]
    v = _dot(d[:, None, :], qvec) * inv_det
    valid &= (v >= 0.0) & (u + v <= 1.0)
    t = _dot(e2[None, :, :], qvec) * inv_det
    valid &= t > eps_tri_t
    return jnp.where(valid, t, INF)


def triangle_coeffs(tri_v):
    """Precompute the per-triangle affine coefficients for the fast form.

    Returns a dict of [T,3] / [T] arrays; see module docstring for algebra.
    """
    a = tri_v[:, 0]
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    n = jnp.cross(e1, e2)
    return {
        "n": n,  # det = -d·n ; t·det = o·n - a·n
        "e1": e1,
        "e2": e2,
        "e2xa": jnp.cross(e2, a),  # u·det = m·e2 - d·(e2×a)
        "axe1": jnp.cross(a, e1),  # v·det = -m·e1 - d·(a×e1)
        "na": _dot(n, a),  # [T]
    }


def triangle_coeffs_np(tri_v):
    """NumPy twin of triangle_coeffs for host-side scene preparation (eager
    jnp ops each compile a tiny executable; scene prep stays on the host)."""
    import numpy as np

    tri_v = np.asarray(tri_v, np.float32)
    a = tri_v[:, 0]
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    n = np.cross(e1, e2)
    return {
        "n": n,
        "e1": e1,
        "e2": e2,
        "e2xa": np.cross(e2, a),
        "axe1": np.cross(a, e1),
        "na": (n * a).sum(axis=1),
    }


def triangle_distances_fast(o, d, coeffs, eps_tri_t: float = EPS_TRI_T):
    """Matmul form: 6 [R,3]@[3,T] contractions, no [R,T,3] buffers."""
    m = jnp.cross(o, d)  # [R,3]
    det = -_matmul(d, coeffs["n"].T)  # [R,T]
    udet = _matmul(m, coeffs["e2"].T) - _matmul(d, coeffs["e2xa"].T)
    vdet = -_matmul(m, coeffs["e1"].T) - _matmul(d, coeffs["axe1"].T)
    tdet = _matmul(o, coeffs["n"].T) - coeffs["na"][None, :]

    valid = jnp.abs(det) >= EPS_TRI_DET
    inv_det = 1.0 / jnp.where(valid, det, 1.0)
    u = udet * inv_det
    v = vdet * inv_det
    t = tdet * inv_det
    valid &= (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps_tri_t)
    return jnp.where(valid, t, INF)


# ---------------------------------------------------------------------------
# Scene intersection over packed buffers
# ---------------------------------------------------------------------------


def _first_min(t):
    """(min value, first argmin) along axis 1 — first-wins tie-break."""
    i = jnp.argmin(t, axis=1)
    return jnp.take_along_axis(t, i[:, None], axis=1)[:, 0], i


def _first_min_onehot(t):
    """(min value, first-wins one-hot mask [R,P] f32) along axis 1.

    A one-hot mask turns every winner-attribute read into a tiny
    [R,P]@[P,k] matmul instead of a per-lane gather. Ties resolve to the first (lowest) index, matching
    argmin and the reference's reverse-scan tie-break (see pack_scene).
    """
    tmin = jnp.min(t, axis=1)
    eq = t == tmin[:, None]
    first = jnp.cumsum(eq.astype(jnp.int32), axis=1) == 1
    onehot = (eq & first).astype(jnp.float32)
    # all-inf rows (miss): eq is all-True, onehot picks column 0 — harmless,
    # callers gate everything on found = isfinite(tmin).
    return tmin, onehot


def _read(onehot, table):
    """Winner-attribute read via one-hot matmul. table [P] or [P,k]."""
    t2 = table[:, None] if table.ndim == 1 else table
    out = jnp.matmul(onehot, t2.astype(jnp.float32), precision=_PRECISION)
    return out[:, 0] if table.ndim == 1 else out


def intersect_scene(
    o, d, scene: dict, mode: str = "fast", prev_tri=None,
    eps_tri_t: float = EPS_TRI_T,
) -> Hit:
    """Closest hit of rays (o,d) against a packed scene (ScenePacked.buffers()
    as jnp arrays, optionally with precomputed 'tri_coeffs').

    Reproduces intersect_scene + SceneObjectData::intersect semantics
    including the mesh bounding-sphere pre-test mask.

    prev_tri [R] i32 (optional): packed triangle index each ray departed from
    (-1 = none); that triangle is excluded. A ray leaving a flat triangle can
    never legitimately re-hit it, but in f32 the plane equation cancels
    catastrophically at the origin and produces phantom t≈0⁺ self-hits ~half
    the time (each one darkens the path by an extra albedo factor — a ~20%
    energy loss in the Cornell box). Exclusion is the exact fix. Spheres are
    never excluded: re-hits there are real (glass interior bounces).
    """
    sphere_fn = sphere_distances_fast if mode == "fast" else sphere_distances_exact

    # Spheres
    t_sph = sphere_fn(o, d, scene["sph_center"], scene["sph_radius"])  # [R,S]
    d_s, oh_s = _first_min_onehot(t_sph)

    # Mesh bounding-sphere pre-test: any root accepted == "is_some()"
    t_bnd = sphere_fn(o, d, scene["bnd_center"], scene["bnd_radius"])  # [R,M]
    pre_ok = jnp.isfinite(t_bnd)  # [R,M]
    tri_gate = jnp.take(pre_ok, scene["tri_mesh"], axis=1)  # static indices

    # Triangles
    if mode == "fast":
        coeffs = scene.get("tri_coeffs")
        if coeffs is None:
            coeffs = triangle_coeffs(scene["tri_v"])
        t_tri = triangle_distances_fast(o, d, coeffs, eps_tri_t)
    else:
        t_tri = triangle_distances_exact(o, d, scene["tri_v"], eps_tri_t)
    t_tri = jnp.where(tri_gate, t_tri, INF)
    if prev_tri is not None:
        T = t_tri.shape[1]
        tri_ids = jnp.arange(T, dtype=jnp.int32)[None, :]
        t_tri = jnp.where(tri_ids == prev_tri[:, None], INF, t_tri)
    d_t, oh_t = _first_min_onehot(t_tri)

    # Merge: strictly-closer wins; on exact ties, smaller reverse-scan rank
    # (the packed `order`) wins — reference reverse-object-scan semantics.
    order_s = _read(oh_s, scene["sph_order"].astype(jnp.float32))
    order_t = _read(oh_t, scene["tri_order"].astype(jnp.float32))
    sph_wins = (d_s < d_t) | ((d_s == d_t) & (order_s < order_t))

    t = jnp.where(sph_wins, d_s, d_t)
    found = jnp.isfinite(t)
    point = o + d * t[:, None]

    sph_n = point - _read(oh_s, scene["sph_center"])
    sph_n = sph_n * lax.rsqrt(jnp.maximum(_dot(sph_n, sph_n), 1e-30))[:, None]
    tri_n = _read(oh_t, scene["tri_normal"])
    normal = jnp.where(sph_wins[:, None], sph_n, tri_n)

    def pick(sph_tab, tri_tab):
        a = _read(oh_s, sph_tab)
        b = _read(oh_t, tri_tab)
        cond = sph_wins[:, None] if a.ndim == 2 else sph_wins
        return jnp.where(cond, a, b)

    color = pick(scene["sph_color"], scene["tri_color"])
    emission = pick(scene["sph_emis"], scene["tri_emis"])
    # rtype/obj/tri ride one-hot reads too (values small → f32-exact)
    rtype = pick(
        scene["sph_rtype"].astype(jnp.float32), scene["tri_rtype"].astype(jnp.float32)
    ).astype(jnp.int32)
    obj = jnp.where(
        found,
        pick(
            scene["sph_obj"].astype(jnp.float32), scene["tri_obj"].astype(jnp.float32)
        ).astype(jnp.int32),
        -1,
    )
    i_t = _read(
        oh_t, jnp.arange(t_tri.shape[1], dtype=jnp.float32)
    ).astype(jnp.int32)
    tri = jnp.where(found & ~sph_wins, i_t, -1)

    # Sanitize miss lanes (t=inf would poison point/normal with nan/inf).
    point = jnp.where(found[:, None], point, 0.0)
    normal = jnp.where(found[:, None], normal, 0.0)
    return Hit(
        t=t,
        found=found,
        point=point,
        normal=normal,
        color=color,
        emission=emission,
        rtype=rtype,
        obj=obj,
        tri=tri,
    )


def intersect_bounds(o, d, scene: dict, bbox_tris: dict, mode: str = "exact"):
    """Parity with ``SceneObjectData::intersect_bounds`` (mod.rs:282-290):
    spheres intersect normally, meshes intersect their AABB-as-12-triangles.
    Used only by viewport orbit picking; bbox_tris holds the packed AABB
    triangles ('tri_v','tri_order','tri_obj' style arrays)."""
    t_sph = sphere_distances_exact(o, d, scene["sph_center"], scene["sph_radius"])
    d_s, i_s = _first_min(t_sph)
    t_tri = triangle_distances_exact(o, d, bbox_tris["tri_v"])
    d_t, i_t = _first_min(t_tri)
    order_s = jnp.take(scene["sph_order"], i_s)
    order_t = jnp.take(bbox_tris["tri_order"], i_t)
    sph_wins = (d_s < d_t) | ((d_s == d_t) & (order_s < order_t))
    t = jnp.where(sph_wins, d_s, d_t)
    obj = jnp.where(
        jnp.isfinite(t),
        jnp.where(
            sph_wins,
            jnp.take(scene["sph_obj"], i_s),
            jnp.take(bbox_tris["tri_obj"], i_t),
        ),
        -1,
    )
    return t, obj

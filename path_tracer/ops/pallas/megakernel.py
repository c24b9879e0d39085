"""Regenerative path-tracing megakernel for NVIDIA GPUs (Pallas, Triton route).

One program owns a power-of-two block of lanes and each lane owns one
pixel. The bounce loop is a ``lax.while_loop`` inside the program: a lane
whose path ends starts its pixel's next sample at once, until its runtime
quota is spent, and the program exits when every lane of the block is done.
Blocks share no state, so they run in any order on any SM. Ray state never
leaves registers; device memory sees pixel ids in and radiance sums out.

The scene and the camera are kernel *inputs*: a few KB of SoA f32 tables
(spheres, triangles with parallelogram pairs merged into quads, per-mesh
bounding spheres) served from L1/L2. A camera move or an edit that keeps
the table sizes reuses the compiled kernel.

Semantics are those of the XLA reference (``ops.intersect``,
``ops.bsdf``, ``render.integrator``): spheres and triangles each keep the
first strictly-closer hit in packed (reversed-object) order, and the two
winners merge by distance, then by reverse-scan rank (``mod.rs:631-659``).
Each mesh's triangles are gated per lane by its bounding sphere, the
reference's pre-test (``mod.rs:265-279``); when no live lane of the block
hits a mesh's bounding sphere, one scalar branch skips the mesh. The shipped estimator applies: ``t > EPS_TRI_T`` and exclusion of
the departed triangle.

Random numbers come from a counter-based hash keyed by (seed, pixel,
sample, bounce, slot), written out in uint32 arithmetic because the Triton
route has no lowering for threefry. ``trace_rays`` instead takes rays and
injected uniforms, one sample per lane, so that lanes can be compared with
``render.integrator.trace`` drawing the same uniforms.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from path_tracer.models.scene import ScenePacked
from path_tracer.ops.intersect import EPS_SPHERE, EPS_TRI_DET, EPS_TRI_T

# Lanes per program and warps per program, swept on an H100 (PERF.md).
BLOCK = 128
NUM_WARPS = 2
# Skip a mesh with one block-wide branch when no live lane of the block
# hits its bounding sphere (PERF.md: it neither slows cornell's one-quad
# meshes nor fails to pay on the 810-row mesh). Read when the kernel is
# traced; tests turn it off to show that it changes no result.
MESH_SKIP = True

BIG = 3.0e38  # miss sentinel: keeps the arithmetic free of inf

# Table columns. Spheres [S, 16]: center, radius², color, emission,
# reflect type, reverse-scan rank.
SPH_W, S_C, S_R2, S_COL, S_EMI, S_RT, S_ORD = 16, 0, 3, 4, 7, 10, 11
# Triangles [T, 32]: vertex a and edges e1 = b-a, e2 = c-a (the
# Möller–Trumbore inputs of ops.intersect.triangle_distances_exact), the
# unit face normal, color, emission, reflect type, rank, packed triangle
# id (prev-exclusion key) and the quad flag.
TRI_W = 32
T_A, T_E1, T_E2, T_NRM, T_COL, T_EMI = 0, 3, 6, 9, 12, 15
T_RT, T_ORD, T_PID, T_QUAD = 18, 19, 20, 21
# Meshes [M, 8]: bounding-sphere center, radius², radius, first and
# one-past-last triangle row.
MESH_W, M_C, M_R2, M_R, M_START, M_END = 8, 0, 3, 4, 5, 6
# int32 run parameters (_params builds them; two padding slots make 8).
P_SEED0, P_SEED1, P_BASE, P_QUOTA, P_NSPH, P_NMESH = range(6)

_GOLDEN = 0x9E3779B9
_PI = np.float32(np.pi)
_R0 = np.float32((1.5 - 1.0) ** 2 / (1.5 + 1.0) ** 2)


# ---------------------------------------------------------------------------
# Host side: scene tables
# ---------------------------------------------------------------------------


def detect_quad_pairs(packed: ScenePacked):
    """Find consecutive triangle pairs (in packed order) that form a
    parallelogram with identical material — collapsible into ONE quad
    primitive whose Möller–Trumbore acceptance is u,v ∈ [0,1]² instead of
    u+v ≤ 1. Exact-parity argument: the pair shares a plane, so the quad's
    t/normal equal the triangles' (bitwise for the axis-aligned wall quads
    of scenes.rs:321-367); the parallelogram is exactly the union of the
    two triangles; and excluding the departed QUAD is equivalent to
    excluding the departed triangle because the coplanar partner is always
    rejected by the t > EPS_TRI_T test. The first triangle is rotated so
    the parallelogram corner (its vertex not shared with the partner)
    comes first; the partner's unique vertex must equal p1 + p2 - p0 in
    exact f32 (conservative: approximate quads stay as triangles).

    Returns (quads, covered): quads maps first-triangle packed index →
    rotated [3,3] vertices; covered is the set of consumed indices."""
    nt = packed.num_triangles
    tv = np.asarray(packed.tri_v[:nt], np.float32)
    color = np.asarray(packed.tri_color[:nt])
    emis = np.asarray(packed.tri_emis[:nt])
    rtype = np.asarray(packed.tri_rtype[:nt])
    mesh = np.asarray(packed.tri_mesh[:nt])
    quads: dict[int, np.ndarray] = {}
    covered: set[int] = set()
    i = 0
    while i + 1 < nt:
        j = i + 1
        if (
            mesh[i] == mesh[j]
            and np.array_equal(color[i], color[j])
            and np.array_equal(emis[i], emis[j])
            and rtype[i] == rtype[j]
        ):
            A, B = tv[i], tv[j]
            bset = {tuple(v) for v in B}
            uniq = [k for k in range(3) if tuple(A[k]) not in bset]
            if len(uniq) == 1:
                k = uniq[0]
                p0, p1, p2 = A[k], A[(k + 1) % 3], A[(k + 2) % 3]
                shared = {tuple(p1), tuple(p2)}
                uniq_b = [tuple(v) for v in B if tuple(v) not in shared]
                q = p1 + p2 - p0  # f32 arithmetic, exact-match required
                if len(uniq_b) == 1 and np.array_equal(
                    np.asarray(uniq_b[0], np.float32), q
                ):
                    quads[i] = np.stack([p0, p1, p2])
                    covered.update((i, j))
                    i += 2
                    continue
        i += 1
    return quads, covered


def _pow2_rows(n: int) -> int:
    """Table rows: a power of two (Triton blocks), at least 8, so that
    small edits keep the shape and with it the compiled kernel."""
    return max(8, 1 << max(n - 1, 0).bit_length())


def scene_tables(packed: ScenePacked) -> dict:
    """ScenePacked → the kernel's device tables:
    {"sph": [S,16], "tri": [T,32], "mesh": [M,8] f32, "counts": [2] i32}
    with counts = (spheres, meshes) actually in use."""
    S, NT, M = packed.num_spheres, packed.num_triangles, packed.num_meshes
    sph = np.zeros((_pow2_rows(S), SPH_W), np.float32)
    sph[:S, S_C:S_C + 3] = packed.sph_center[:S]
    sph[:S, S_R2] = np.asarray(packed.sph_radius[:S], np.float32) ** 2
    sph[:S, S_COL:S_COL + 3] = packed.sph_color[:S]
    sph[:S, S_EMI:S_EMI + 3] = packed.sph_emis[:S]
    sph[:S, S_RT] = packed.sph_rtype[:S]
    sph[:S, S_ORD] = packed.sph_order[:S]

    quads, covered = detect_quad_pairs(packed)
    keep = [i for i in range(NT) if i not in covered or i in quads]
    tri = np.zeros((_pow2_rows(len(keep)), TRI_W), np.float32)
    mesh = np.zeros((_pow2_rows(M), MESH_W), np.float32)
    mesh[:M, M_C:M_C + 3] = packed.bnd_center[:M]
    mesh[:M, M_R2] = np.asarray(packed.bnd_radius[:M], np.float32) ** 2
    mesh[:M, M_R] = packed.bnd_radius[:M]
    if keep:
        verts = np.stack(
            [quads[i] if i in quads else packed.tri_v[i] for i in keep]
        ).astype(np.float32)
        rows = np.asarray(keep)
        cols = {
            T_A: verts[:, 0], T_E1: verts[:, 1] - verts[:, 0],
            T_E2: verts[:, 2] - verts[:, 0], T_NRM: packed.tri_normal[rows],
            T_COL: packed.tri_color[rows], T_EMI: packed.tri_emis[rows],
        }
        for c, v in cols.items():
            tri[: len(keep), c:c + 3] = v
        tri[: len(keep), T_RT] = packed.tri_rtype[rows]
        tri[: len(keep), T_ORD] = packed.tri_order[rows]
        tri[: len(keep), T_PID] = rows
        tri[: len(keep), T_QUAD] = [i in quads for i in keep]
        # packing keeps each mesh's triangles contiguous and in mesh order
        tri_mesh = np.asarray(packed.tri_mesh)[rows]
        for m in range(M):
            idx = np.nonzero(tri_mesh == m)[0]
            if len(idx):
                mesh[m, M_START], mesh[m, M_END] = idx[0], idx[-1] + 1
    return {
        "sph": jnp.asarray(sph),
        "tri": jnp.asarray(tri),
        "mesh": jnp.asarray(mesh),
        "counts": jnp.asarray([S, M], jnp.int32),
    }


def camera_vector(cam: dict) -> jax.Array:
    """render.raygen.camera_arrays (host or device) → the kernel's [16] f32
    camera input: sensor origin, su, sv, lens center."""
    return jnp.concatenate(
        [jnp.asarray(cam[k], jnp.float32).reshape(3)
         for k in ("sensor_origin", "su", "sv", "lens_center")]
        + [jnp.zeros(4, jnp.float32)]
    )


# ---------------------------------------------------------------------------
# In-kernel pieces (shape-agnostic jnp on per-lane vectors)
# ---------------------------------------------------------------------------


def _mix(h):
    """32-bit integer hash (lowbias32): a bijection with full avalanche."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x846CA68B)
    return h ^ (h >> 16)


def _unit(h):
    """uint32 → uniform f32 in [0, 1) from the top 23 bits."""
    one = lax.bitcast_convert_type((h >> 9) | jnp.uint32(0x3F800000), jnp.float32)
    return one - 1.0


def _uniform(skey, depth, slot: int):
    """Uniform for (sample key, bounce, slot): slots 0-3 drive the bounce
    (roulette, two BSDF draws, refraction branch), 4-5 the camera ray."""
    ctr = (depth * 8 + slot).astype(jnp.uint32) * jnp.uint32(_GOLDEN)
    return _unit(_mix(skey + ctr))


def shade(d, nrm, color, emis, rtype, found, thr, acc, u4, new_depth,
          max_depth, rr_start_depth):
    """Russian roulette + emission + BSDF sample + throughput update on
    component lists (mod.rs:676-788, with the always-RR refraction branch of
    ops.bsdf). Returns (acc', thr', d_new, alive_new)."""
    u_rr, u1, u2, u_br = u4

    nd = nrm[0] * d[0] + nrm[1] * d[1] + nrm[2] * d[2]
    to_ray = nd < 0.0
    nl = [jnp.where(to_ray, nrm[k], -nrm[k]) for k in range(3)]

    # Russian roulette (mod.rs:676-683)
    max_refl = jnp.maximum(color[0], jnp.maximum(color[1], color[2]))
    rr_on = new_depth > rr_start_depth
    survive = (u_rr < max_refl) & (new_depth < max_depth)
    die_rr = rr_on & ~survive
    scale = jnp.where(rr_on & survive, 1.0 / jnp.maximum(max_refl, 1e-30), 1.0)

    fm = found.astype(jnp.float32)
    acc = [acc[k] + thr[k] * emis[k] * fm for k in range(3)]

    # diffuse: cosine-weighted around nl (mod.rs:687-715)
    r1 = 2.0 * _PI * u1
    r2s = jnp.sqrt(u2)
    w = nl
    use_y = jnp.abs(w[0]) > 0.1
    upx = jnp.where(use_y, 0.0, 1.0)
    upy = jnp.where(use_y, 1.0, 0.0)
    ux = upy * w[2]
    uy = -upx * w[2]
    uz = upx * w[1] - upy * w[0]
    ul = lax.rsqrt(jnp.maximum(ux * ux + uy * uy + uz * uz, 1e-30))
    ux, uy, uz = ux * ul, uy * ul, uz * ul
    vx = w[1] * uz - w[2] * uy
    vy = w[2] * ux - w[0] * uz
    vz = w[0] * uy - w[1] * ux
    cr1 = jnp.cos(r1) * r2s
    sr1 = jnp.sin(r1) * r2s
    wz = jnp.sqrt(jnp.maximum(1.0 - u2, 0.0))
    dd0 = ux * cr1 + vx * sr1 + w[0] * wz
    dd1 = uy * cr1 + vy * sr1 + w[1] * wz
    dd2 = uz * cr1 + vz * sr1 + w[2] * wz
    dl = lax.rsqrt(jnp.maximum(dd0 * dd0 + dd1 * dd1 + dd2 * dd2, 1e-30))
    d_diff = [dd0 * dl, dd1 * dl, dd2 * dl]

    # mirror about the geometric normal; the specular lobe renormalizes it
    # and the refraction lobe does not, as ops.bsdf does
    d_refl = [d[k] - nrm[k] * (2.0 * nd) for k in range(3)]
    rl = lax.rsqrt(jnp.maximum(
        d_refl[0] ** 2 + d_refl[1] ** 2 + d_refl[2] ** 2, 1e-30))
    d_spec = [x * rl for x in d_refl]

    # refraction (mod.rs:729-788; always-RR branch, weights Re/P, Tr/(1-P))
    into = to_ray
    nnt = jnp.where(into, np.float32(1.0 / 1.5), np.float32(1.5))
    ddn = nl[0] * d[0] + nl[1] * d[1] + nl[2] * d[2]
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    tsc = ddn * nnt + jnp.sqrt(jnp.maximum(cos2t, 0.0))
    td = [d[k] * nnt - nl[k] * tsc for k in range(3)]
    tl = lax.rsqrt(jnp.maximum(td[0] ** 2 + td[1] ** 2 + td[2] ** 2, 1e-30))
    td = [x * tl for x in td]
    tdn = td[0] * nrm[0] + td[1] * nrm[1] + td[2] * nrm[2]
    c_ = 1.0 - jnp.where(into, -ddn, tdn)
    re = _R0 + (1.0 - _R0) * c_**5
    p_ = 0.25 + 0.5 * re
    pick_refl = (u_br < p_) | tir
    d_refr = [jnp.where(pick_refl, d_refl[k], td[k]) for k in range(3)]
    w_num = jnp.where(u_br < p_, re, 1.0 - re)
    w_den = jnp.where(u_br < p_, p_, 1.0 - p_)
    w_refr = jnp.where(tir, 1.0, w_num / w_den)

    is_diff = rtype < 0.5
    is_spec = (rtype >= 0.5) & (rtype < 1.5)
    d_new = [
        jnp.where(is_diff, d_diff[k], jnp.where(is_spec, d_spec[k], d_refr[k]))
        for k in range(3)
    ]
    wgt = jnp.where(is_diff | is_spec, 1.0, w_refr)

    thr_new = [thr[k] * (color[k] * scale) * wgt for k in range(3)]
    thr_max = jnp.maximum(thr_new[0], jnp.maximum(thr_new[1], thr_new[2]))
    # unconditional depth cut: bit-identical to the roulette cut when
    # max_depth > rr_start_depth, equal to the XLA scan bound otherwise,
    # and it bounds every sample to max_depth steps
    die_depth = new_depth >= max_depth
    alive_new = found & ~die_rr & ~die_depth & (thr_max > 0.0)
    return acc, thr_new, d_new, alive_new


def _intersect(o, d, prev, live, sph_ref, tri_ref, mesh_ref, n_sph, n_mesh):
    """Closest hit of per-lane rays against the scene tables. Returns
    (found, point3, normal3, color3, emission3, rtype, packed tri id)."""
    dot = lambda a, b: a[0] * b[0] + a[1] * b[1] + a[2] * b[2]  # noqa: E731
    f32 = jnp.float32

    def vec(ref, i, c):
        return [ref[i, c + k] for k in range(3)]

    def sphere_roots(c, r2):
        op = [c[k] - o[k] for k in range(3)]
        b = dot(op, d)
        det = b * b - dot(op, op) + r2
        sq = jnp.sqrt(jnp.maximum(det, 0.0))
        return b, det, sq

    def sph_body(i, carry):
        t_best, i_best = carry
        r2 = sph_ref[i, S_R2]
        b, det, sq = sphere_roots(vec(sph_ref, i, S_C), r2)
        t_near, t_far = b - sq, b + sq
        t = jnp.where(t_near >= EPS_SPHERE, t_near,
                      jnp.where(t_far >= EPS_SPHERE, t_far, BIG))
        t = jnp.where((det < 0.0) | (r2 <= 0.0), BIG, t)
        better = t < t_best
        return jnp.where(better, t, t_best), jnp.where(better, i, i_best)

    zero_i = jnp.zeros_like(prev)
    t_s, i_s = lax.fori_loop(
        0, n_sph, sph_body, (jnp.full(prev.shape, BIG, f32), zero_i))

    def cross(a, b):
        return [a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0]]

    def tri_body(gate):
        def body(i, carry):
            t_best, i_best = carry
            e1 = vec(tri_ref, i, T_E1)
            e2 = vec(tri_ref, i, T_E2)
            pvec = cross(d, e2)
            det = dot(e1, pvec)
            dvalid = jnp.abs(det) >= EPS_TRI_DET
            inv = 1.0 / jnp.where(dvalid, det, 1.0)
            tvec = [o[k] - tri_ref[i, T_A + k] for k in range(3)]
            u = dot(tvec, pvec) * inv
            qvec = cross(tvec, e1)
            v = dot(d, qvec) * inv
            t = dot(e2, qvec) * inv
            # quads accept the parallelogram u,v ∈ [0,1]², triangles u+v ≤ 1
            hi = jnp.where(tri_ref[i, T_QUAD] > 0.5, v, u + v)
            pid = tri_ref[i, T_PID].astype(jnp.int32)
            valid = (dvalid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                     & (hi <= 1.0) & (t > EPS_TRI_T) & (prev != pid) & gate)
            t = jnp.where(valid, t, BIG)
            better = t < t_best
            return jnp.where(better, t, t_best), jnp.where(better, i, i_best)

        return body

    def mesh_body(j, carry):
        r = mesh_ref[j, M_R]
        b, det, sq = sphere_roots(vec(mesh_ref, j, M_C), mesh_ref[j, M_R2])
        # any accepted root (the reference's `is_some()`)
        gate = ((det >= 0.0) & (r > 0.0)
                & ((b - sq >= EPS_SPHERE) | (b + sq >= EPS_SPHERE)))
        start = mesh_ref[j, M_START].astype(jnp.int32)
        end = mesh_ref[j, M_END].astype(jnp.int32)

        def run(c):
            return lax.fori_loop(start, end, tri_body(gate), c)

        if not MESH_SKIP:
            return run(carry)
        any_hit = jnp.max(jnp.where(gate & live, 1, 0)) > 0
        return lax.cond(any_hit, run, lambda c: c, carry)

    t_t, i_t = lax.fori_loop(
        0, n_mesh, mesh_body, (jnp.full(prev.shape, BIG, f32), zero_i))

    # merge: strictly closer wins; on exact ties the smaller reverse-scan
    # rank wins (reference reverse-object-scan semantics)
    sph_wins = (t_s < t_t) | ((t_s == t_t) & (sph_ref[i_s, S_ORD]
                                              < tri_ref[i_t, T_ORD]))
    t = jnp.where(sph_wins, t_s, t_t)
    found = (t < BIG) & live
    point = [o[k] + d[k] * t for k in range(3)]
    sn = [point[k] - sph_ref[i_s, S_C + k] for k in range(3)]
    sl = lax.rsqrt(jnp.maximum(dot(sn, sn), 1e-30))

    def pick(sc, tc):
        return jnp.where(sph_wins, sph_ref[i_s, sc], tri_ref[i_t, tc])

    nrm = [jnp.where(sph_wins, sn[k] * sl, tri_ref[i_t, T_NRM + k])
           for k in range(3)]
    color = [pick(S_COL + k, T_COL + k) for k in range(3)]
    emis = [pick(S_EMI + k, T_EMI + k) for k in range(3)]
    rtype = pick(S_RT, T_RT)
    pid = jnp.where(sph_wins, -1, tri_ref[i_t, T_PID].astype(jnp.int32))
    return found, point, nrm, color, emis, rtype, pid


def _kernel(par_ref, cam_ref, sph_ref, tri_ref, mesh_ref, pix_ref, *rest,
            width, height, max_depth, rr_start_depth, rays_in):
    if rays_in:
        ray_ref, u_ref, out_ref = rest
    else:
        (out_ref,) = rest
    pix = pix_ref[...]  # [B] i32; -1 marks a padding lane
    quota = jnp.where(pix >= 0, par_ref[P_QUOTA], 0)
    base = par_ref[P_BASE]
    n_sph, n_mesh = par_ref[P_NSPH], par_ref[P_NMESH]
    seed = _mix(par_ref[P_SEED0].astype(jnp.uint32)
                ^ _mix(par_ref[P_SEED1].astype(jnp.uint32)))
    pkey = _mix(seed ^ _mix(pix.astype(jnp.uint32)))
    cam = [cam_ref[k] for k in range(12)]
    lens = cam[9:12]

    f32 = jnp.float32
    zf = jnp.zeros(pix.shape, f32)
    zi = jnp.zeros(pix.shape, jnp.int32)
    if rays_in:
        o = [ray_ref[k, :] for k in range(3)]
        d = [ray_ref[3 + k, :] for k in range(3)]
        alive = quota > 0
    else:
        o = [zf + lens[k] for k in range(3)]
        d = [zf, zf, zf + 1.0]
        alive = zi > 0
    # pixel → (x, y) with the reference's y flip (mod.rs:794-843)
    xf = (pix % width).astype(f32)
    yf = (height - 1 - pix // width).astype(f32)

    def raygen(s, u1, u2):
        half = s // 2
        ysub = (half % 2).astype(f32)
        xsub = (s % 2).astype(f32)
        r1, r2 = 2.0 * u1, 2.0 * u2
        tx = jnp.where(r1 < 1.0, jnp.sqrt(r1) - 1.0,
                       1.0 - jnp.sqrt(jnp.maximum(2.0 - r1, 0.0)))
        ty = jnp.where(r2 < 1.0, jnp.sqrt(r2) - 1.0,
                       1.0 - jnp.sqrt(jnp.maximum(2.0 - r2, 0.0)))
        sx = (xf + 0.5 * (0.5 + xsub + tx)) / width - 0.5
        sy = (yf + 0.5 * (0.5 + ysub + ty)) / height - 0.5
        dv = [lens[k] - (cam[k] + cam[3 + k] * sx + cam[6 + k] * sy)
              for k in range(3)]
        dl = lax.rsqrt(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2])
        return [x * dl for x in dv]

    def step(carry):
        it, (o, d, thr, acc, alive, prev, depth, done, cnt, skey) = carry
        if not rays_in:
            need = ~alive & (done < quota)
            s = base + done
            k_new = _mix(pkey ^ _mix(s.astype(jnp.uint32) + jnp.uint32(_GOLDEN)))
            d_new = raygen(s, _uniform(k_new, zi, 4), _uniform(k_new, zi, 5))
            o = [jnp.where(need, lens[k], o[k]) for k in range(3)]
            d = [jnp.where(need, d_new[k], d[k]) for k in range(3)]
            thr = [jnp.where(need, 1.0, thr[k]) for k in range(3)]
            prev = jnp.where(need, -1, prev)
            depth = jnp.where(need, 0, depth)
            skey = jnp.where(need, k_new, skey)
            alive = alive | need
        cnt = cnt + alive.astype(jnp.int32)
        found, point, nrm, color, emis, rtype, hit_pid = _intersect(
            o, d, prev, alive, sph_ref, tri_ref, mesh_ref, n_sph, n_mesh)
        if rays_in:
            u4 = [u_ref[it * 4 + k, :] for k in range(4)]
        else:
            u4 = [_uniform(skey, depth, k) for k in range(4)]
        depth = depth + 1
        acc, thr_new, d2, alive_new = shade(
            d, nrm, color, emis, rtype, found, thr, acc, u4, depth,
            max_depth, rr_start_depth)
        done = done + (alive & ~alive_new).astype(jnp.int32)
        am = alive_new.astype(f32)
        o = [jnp.where(alive_new, point[k], o[k]) for k in range(3)]
        d = [jnp.where(alive_new, d2[k], d[k]) for k in range(3)]
        thr = [thr_new[k] * am for k in range(3)]
        prev = jnp.where(alive_new, hit_pid, -1)
        return it + 1, (o, d, thr, acc, alive_new, prev, depth, done, cnt,
                        skey)

    # every sample ends within max_depth steps, so quota*max_depth bounds
    # the loop; the bound only guards against a lane that never finishes
    limit = jnp.max(quota) * max_depth

    def running(carry):
        it, st = carry
        done = st[7]
        return (it < limit) & (jnp.max(jnp.where(done < quota, 1, 0)) > 0)

    state = ([*o], [*d], [zf + 1.0] * 3, [zf] * 3, alive, zi - 1, zi, zi, zi,
             pkey)
    _, st = lax.while_loop(running, step, (jnp.int32(0), state))
    acc, cnt = st[3], st[8]
    for k in range(3):
        out_ref[k, :] = acc[k]
    out_ref[3, :] = cnt.astype(f32)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "max_depth", "rr_start_depth",
                     "rays_in", "interpret", "block", "num_warps"),
)
def _launch(params, cam, tables, pix, rays, uniforms, *, width, height,
            max_depth, rr_start_depth, rays_in, interpret, block, num_warps):
    n = pix.shape[0]
    n_pad = -(-n // block) * block
    pix = jnp.pad(pix.astype(jnp.int32), (0, n_pad - n), constant_values=-1)
    lane = pl.BlockSpec((block,), lambda i: (i,))

    def whole(x):
        return pl.BlockSpec(x.shape, lambda i: (0,) * x.ndim)

    def rows(x):
        return pl.BlockSpec((x.shape[0], block), lambda i: (0, i))

    args = [params, cam, tables["sph"], tables["tri"], tables["mesh"], pix]
    specs = [whole(a) for a in args[:5]] + [lane]
    if rays_in:
        extra = [jnp.pad(rays, ((0, 2), (0, n_pad - n))),
                 jnp.pad(uniforms, ((0, _pow2_rows(uniforms.shape[0])
                                     - uniforms.shape[0]), (0, n_pad - n)))]
        args += extra
        specs += [rows(x) for x in extra]
    out = pl.pallas_call(
        functools.partial(
            _kernel, width=width, height=height, max_depth=max_depth,
            rr_start_depth=rr_start_depth, rays_in=rays_in),
        out_shape=jax.ShapeDtypeStruct((4, n_pad), jnp.float32),
        grid=(n_pad // block,),
        in_specs=specs,
        out_specs=pl.BlockSpec((4, block), lambda i: (0, i)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="path_trace",
    )(*args)
    # per-lane counts are small exact integers: sum them in int32 within a
    # block and in f32 across blocks (a frame can pass 2^31 segments)
    cnt = out[3].astype(jnp.int32).reshape(-1, block)
    rays = jnp.sum(jnp.sum(cnt, axis=1).astype(jnp.float32))
    return out[:3, :n].T, rays


def _params(tables, seed, sample_base, quota):
    seed = jnp.asarray(seed, jnp.uint32).reshape(-1)
    seed = jnp.concatenate([seed, jnp.zeros(2, jnp.uint32)])[:2]
    return jnp.concatenate([
        lax.bitcast_convert_type(seed, jnp.int32),
        jnp.stack([jnp.asarray(sample_base, jnp.int32),
                   jnp.asarray(quota, jnp.int32)]),
        tables["counts"].astype(jnp.int32),
        jnp.zeros(2, jnp.int32),
    ])


_INTERPRET = False


@contextlib.contextmanager
def interpret_mode():
    """Run the kernel in the Pallas interpreter (CPU tests). The renderer
    itself never falls back to the interpreter: outside this context the
    kernel backend needs a GPU."""
    global _INTERPRET
    prev, _INTERPRET = _INTERPRET, True
    try:
        yield
    finally:
        _INTERPRET = prev


def interpreting() -> bool:
    return _INTERPRET


def render_pixels(tables: dict, cam: dict, pixels, seed, sample_base, quota,
                  *, width: int, height: int, max_depth: int = 12,
                  rr_start_depth: int = 5,
                  block: int = BLOCK, num_warps: int = NUM_WARPS):
    """Regenerative trace: each lane of ``pixels`` [N] i32 traces global
    samples [sample_base, sample_base + quota) of its pixel with in-kernel
    camera rays. ``seed``: uint32 key words (e.g. ``jax.random.key_data`` of
    the render's root key). ``quota`` is a runtime value. Returns (radiance
    SUM over the quota [N,3], segments traced f32). ``block`` and
    ``num_warps`` default to the tuned constants."""
    params = _params(tables, seed, sample_base, quota)
    return _launch(params, camera_vector(cam), tables, pixels, None, None,
                   width=width, height=height, max_depth=max_depth,
                   rr_start_depth=rr_start_depth, rays_in=False,
                   interpret=_INTERPRET, block=block, num_warps=num_warps)


def trace_rays(tables: dict, o, d, uniforms, *, max_depth: int = 12,
               rr_start_depth: int = 5,
               block: int = BLOCK, num_warps: int = NUM_WARPS):
    """One sample per lane from given rays o, d [N,3], drawing bounce
    uniforms from ``uniforms`` [max_depth*4, N] (row 4*s + k is slot k of
    bounce s, the layout of ``rng.bounce_uniforms`` stacked over bounces)
    instead of the hash. Returns (radiance [N,3], segments traced f32)."""
    n = o.shape[0]
    params = _params(tables, 0, 0, 1)
    rays = jnp.concatenate([jnp.asarray(o, jnp.float32).T,
                            jnp.asarray(d, jnp.float32).T])
    cam = jnp.zeros(16, jnp.float32)
    return _launch(params, cam, tables, jnp.arange(n, dtype=jnp.int32),
                   rays, jnp.asarray(uniforms, jnp.float32), width=1,
                   height=1, max_depth=max_depth,
                   rr_start_depth=rr_start_depth, rays_in=True,
                   interpret=_INTERPRET,
                   block=block, num_warps=num_warps)

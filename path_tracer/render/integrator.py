"""Wavefront path-tracing integrator.

The reference's recursive ``radiance`` (``mod.rs:661-792``) becomes a
``lax.scan`` over bounce depth carrying per-ray state
``(origin, direction, throughput, accum, alive)``. Branches are masked
``jnp.where`` lanes; Russian roulette is masked termination. The transform is
expectation-preserving (verified against a literal recursive oracle in
tests/test_integrator.py (test_wavefront_matches_recursive_oracle)):

recursive form                         wavefront form
--------------                         --------------
return emission (+ color * L(next))    accum += throughput * emission
color scaling / RR rescale 1/p         throughput *= color_eff * brdf_weight
recursion                              next scan step with new (o, d)
miss → black                           lane dies, accum unchanged
hard cut MAX_DEPTH=12                  scan length 12 (new_depth<12 in the
                                       RR survive condition kills step 12)

Extra (math-neutral) optimization: a lane whose throughput becomes exactly
zero (e.g. after hitting a color-(0,0,0) emissive sphere) can never add
radiance again, so it dies immediately instead of tracing on.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from path_tracer.ops import rng
from path_tracer.ops.bsdf import sample_bsdf
from path_tracer.ops.intersect import EPS_TRI_T, intersect_scene
from path_tracer.ops.pallas import megakernel


class TraceResult(NamedTuple):
    radiance: jax.Array  # [N,3] per-sample radiance estimate
    rays_traced: jax.Array  # [] i64-ish: total alive lanes over all bounces


def trace(
    o,
    d,
    scene: dict,
    key,
    *,
    max_depth: int = 12,
    rr_start_depth: int = 5,
    mode: str = "fast",
    unroll: int = 1,
    mock_random: bool = False,
    literal: bool = False,
) -> TraceResult:
    """Trace a batch of rays to completion. o, d: [N,3] f32.

    mock_random: replace threefry with the reference's fixed 9-value cycle
    (MOCK_RANDOM fixture, mod.rs:31-55) — draws are a pure function of
    (lane, bounce, slot), giving bit-deterministic renders for debugging.
    literal: use the reference's LITERAL triangle acceptance (``t > 0``,
    mod.rs:592, no departed-triangle exclusion) instead of the shipped
    ``t > EPS_TRI_T`` + prev-exclusion estimator. This reproduces the
    reference's phantom self-re-hits (the ray re-hits the surface it just
    left whenever roundoff puts the new origin behind the plane) — kept so
    the shipped-vs-reference estimator difference can be *quantified*
    (PARITY_REPORT.md) rather than argued.
    """
    n = o.shape[0]
    thr = jnp.ones((n, 3), jnp.float32)
    acc = jnp.zeros((n, 3), jnp.float32)
    alive = jnp.ones((n,), bool)
    prev_tri = jnp.full((n,), -1, jnp.int32)

    def step(carry, s):
        o, d, thr, acc, alive, prev_tri = carry
        n_alive = jnp.sum(alive.astype(jnp.int32))

        hit = intersect_scene(
            o, d, scene, mode=mode,
            prev_tri=None if literal else prev_tri,
            eps_tri_t=0.0 if literal else EPS_TRI_T,
        )
        found = hit.found & alive

        nd = jnp.sum(hit.normal * d, axis=-1)
        nl = jnp.where((nd < 0.0)[:, None], hit.normal, -hit.normal)

        if mock_random:
            u = rng.mock_uniforms_traced(s, (n,), 4)
        else:
            u = rng.bounce_uniforms(key, s, (n,), 4)  # rr, u1, u2, branch
        new_depth = s + 1

        # Russian roulette (mod.rs:676-683): when new_depth > 5, survive with
        # p = max(color) only if new_depth < MAX_DEPTH; survivor color /= p.
        max_refl = jnp.max(hit.color, axis=-1)
        rr_applies = new_depth > rr_start_depth
        survive = (u[:, 0] < max_refl) & (new_depth < max_depth)
        die_rr = rr_applies & ~survive
        scale = jnp.where(
            rr_applies & survive, 1.0 / jnp.maximum(max_refl, 1e-30), 1.0
        )
        color_eff = hit.color * scale[:, None]

        # Both the terminate and continue paths add emission.
        acc = acc + jnp.where(found[:, None], thr * hit.emission, 0.0)

        bs = sample_bsdf(d, hit.normal, nl, hit.rtype, u[:, 1:4])
        thr_new = thr * color_eff * bs.weight

        alive_new = found & ~die_rr & (jnp.max(thr_new, axis=-1) > 0.0)

        # Keep dead lanes numerically inert.
        o_new = jnp.where(alive_new[:, None], hit.point, o)
        d_new = jnp.where(alive_new[:, None], bs.direction, d)
        thr_new = jnp.where(alive_new[:, None], thr_new, 0.0)
        # Exclude the departed triangle next step — but NOT for refraction
        # lanes passing through the surface (they must be able to hit the
        # triangle's plane again from the other side... they can't: a flat
        # triangle is crossed once; keep exclusion unconditionally).
        prev_tri_new = hit.tri

        return (o_new, d_new, thr_new, acc, alive_new, prev_tri_new), n_alive

    (_, _, _, acc, _, _), alive_counts = lax.scan(
        step,
        (o, d, thr, acc, alive, prev_tri),
        jnp.arange(max_depth, dtype=jnp.int32),
        unroll=unroll,
    )
    return TraceResult(radiance=acc, rays_traced=jnp.sum(alive_counts))


def render_samples(
    scene: dict,
    cam: dict,
    pixel_idx,
    sample_idx,
    key,
    *,
    width: int,
    height: int,
    max_depth: int = 12,
    rr_start_depth: int = 5,
    mode: str = "fast",
    mock_random: bool = False,
    literal: bool = False,
) -> TraceResult:
    """Generate camera rays for (pixel, sample) pairs and trace them."""
    from path_tracer.render.raygen import generate_rays

    if mock_random:
        # the fixture covers the tent-filter draws too (slot 15 = raygen)
        u = rng.mock_uniforms_traced(jnp.int32(15), (pixel_idx.shape[0],), 2)
    else:
        u = rng.raygen_uniforms(key, (pixel_idx.shape[0],), 2)
    o, d = generate_rays(pixel_idx, sample_idx, u, cam, width, height)
    return trace(
        o,
        d,
        scene,
        key,
        max_depth=max_depth,
        rr_start_depth=rr_start_depth,
        mode=mode,
        mock_random=mock_random,
        literal=literal,
    )


@partial(
    jax.jit,
    static_argnames=(
        "width",
        "height",
        "samples_in_pass",
        "max_depth",
        "rr_start_depth",
        "mode",
        "mock_random",
        "pixel_chunk",
        "literal",
    ),
    donate_argnames=("accum",),
)
def render_pass(
    scene: dict,
    cam: dict,
    accum,
    pass_idx,
    base_key,
    *,
    sample_base,
    width: int,
    height: int,
    samples_in_pass: int,
    max_depth: int = 12,
    rr_start_depth: int = 5,
    mode: str = "fast",
    pixel_perm=None,
    mock_random: bool = False,
    pixel_chunk: int = 0,
    chunk_start=None,
    quota_rt=None,
    literal: bool = False,
):
    """One device dispatch: all pixels × samples_in_pass samples.

    accum: [W*H, 3] running radiance sum (donated). pass_idx selects which
    global sample indices this pass covers and seeds the RNG stream.
    pixel_perm [W*H] i32 (optional): pixel visit order — a Morton (Z-order)
    permutation makes each kernel block a compact screen tile, whose rays
    are coherent enough for the block-level bounding-sphere skip. accum
    stays in permuted order (callers unpermute once at finalize).
    sample_base: global index of this pass's first sample (drives the 2x2
    subpixel grid). KEYWORD-REQUIRED: the natural-looking default
    (pass_idx*k) is wrong for a remainder pass whose k is smaller than the
    earlier passes' — every scheduler must state the base it means.
    quota_rt (kernel mode only): RUNTIME samples per pixel for this pass;
    samples_in_pass is then unused, so every pass size (ragged remainders
    included) reuses one compiled program.
    Returns (accum', rays_traced).
    """
    npix = width * height
    k = samples_in_pass
    base = jnp.arange(npix, dtype=jnp.int32) if pixel_perm is None else pixel_perm
    key = rng.chunk_key(base_key, pass_idx)

    if mode == "pallas":
        # regenerative kernel: one lane per pixel, the pass's samples traced
        # in-kernel with camera rays generated there
        if literal or mock_random:
            raise ValueError(
                "literal and mock_random are XLA-only (backend exact/fast): "
                "the kernel bakes the shipped estimator and its own RNG"
            )
        rad_sum, rays = megakernel.render_pixels(
            scene["kernel"], cam, base, jax.random.key_data(base_key),
            sample_base, quota_rt,
            width=width, height=height, max_depth=max_depth,
            rr_start_depth=rr_start_depth,
        )
        return accum + rad_sum, rays

    if pixel_chunk:
        # chunked dispatch: trace pixel_chunk pixels of the (padded,
        # permuted) pixel order per call, bounding the [lanes, T]
        # intersection intermediates for triangle-heavy XLA modes. The key
        # folds in the chunk offset — without it, lanes at the same
        # intra-chunk position would replay the same uniforms in every
        # chunk (tile-correlated noise).
        base_c = jax.lax.dynamic_slice(base, (chunk_start,), (pixel_chunk,))
        key = rng.chunk_key(key, chunk_start)
        pixel_idx = jnp.repeat(base_c, k)
        sample_idx = (
            jnp.tile(jnp.arange(k, dtype=jnp.int32), pixel_chunk) + sample_base
        )
        result = render_samples(
            scene, cam, pixel_idx, sample_idx, key,
            width=width, height=height, max_depth=max_depth,
            rr_start_depth=rr_start_depth, mode=mode, mock_random=mock_random,
            literal=literal,
        )
        rad = result.radiance.reshape(pixel_chunk, k, 3).sum(axis=1)
        acc_c = jax.lax.dynamic_slice(accum, (chunk_start, 0), (pixel_chunk, 3))
        accum = jax.lax.dynamic_update_slice(accum, acc_c + rad, (chunk_start, 0))
        return accum, result.rays_traced

    pixel_idx = jnp.repeat(base, k)
    sample_idx = jnp.tile(jnp.arange(k, dtype=jnp.int32), npix) + sample_base

    result = render_samples(
        scene,
        cam,
        pixel_idx,
        sample_idx,
        key,
        width=width,
        height=height,
        max_depth=max_depth,
        rr_start_depth=rr_start_depth,
        mode=mode,
        mock_random=mock_random,
        literal=literal,
    )
    accum = accum + result.radiance.reshape(npix, k, 3).sum(axis=1)
    return accum, result.rays_traced


@partial(
    jax.jit,
    static_argnames=(
        "width",
        "height",
        "samples_in_pass",
        "max_depth",
        "rr_start_depth",
        "mode",
        "literal",
    ),
    donate_argnames=("accum",),
)
def render_passes_fused(
    scene: dict,
    cam: dict,
    accum,
    base_key,
    *,
    n_passes,
    width: int,
    height: int,
    samples_in_pass: int,
    max_depth: int = 12,
    rr_start_depth: int = 5,
    mode: str = "fast",
    pixel_perm=None,
    quota_rt=None,
    literal: bool = False,
):
    """`n_passes` equal full passes in ONE device dispatch (fori_loop over
    the render_pass body). Hookless renders (no progress, no cancel, no
    checkpoint — bench/CLI steady state) use this to drop the per-pass
    dispatch and host-loop overhead. n_passes is a RUNTIME value (the fori
    lowers to a while_loop) so one compiled program serves every spp.
    Semantics are identical to the unfused pass loop: pass i covers global
    samples [i*k, (i+1)*k) with the same chunk_key(base_key, i) stream,
    where k is quota_rt in kernel mode and samples_in_pass otherwise."""
    k = samples_in_pass if quota_rt is None else quota_rt

    def body(i, carry):
        acc, rays = carry
        acc, r = render_pass(
            scene, cam, acc, i, base_key,
            sample_base=i * jnp.int32(k), width=width, height=height,
            samples_in_pass=samples_in_pass, max_depth=max_depth,
            rr_start_depth=rr_start_depth, mode=mode, pixel_perm=pixel_perm,
            quota_rt=quota_rt, literal=literal,
        )
        return acc, rays + r

    return lax.fori_loop(
        0, n_passes, body, (accum, jnp.float32(0.0))
    )


def finalize(accum, spp: int):
    """Average over spp and clamp per channel to [0,1] AFTER averaging
    (mod.rs:849-856)."""
    return jnp.clip(accum / jnp.float32(spp), 0.0, 1.0)

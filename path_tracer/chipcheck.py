"""Checks that only the card can run, as plain functions.

``chip_smoke.py`` calls them in one process (a JAX process reserves most of
the card's memory, so they cannot run in child processes), and the tests
marked ``gpu`` call the same functions. Each returns the numbers it
compared; the caller decides pass or fail.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

import path_tracer as pt
from path_tracer.ops import rng
from path_tracer.ops.pallas import megakernel
from path_tracer.ops.tonemap import quantize_np
from path_tracer.render.integrator import trace
from path_tracer.render.pipeline import prepare_scene
from path_tracer.render.raygen import camera_arrays, generate_rays

# The parity rule of PARITY_REPORT.md: an image agrees with the reference
# when its RMSE against an independent reference render is at most this
# factor above the RMSE between two independent reference renders.
RMSE_SLACK = 1.15
# Lanewise rule: the fraction of lanes whose radiance agrees within 1e-3
# (sum of absolute channel differences). Two compilers round the same
# formulas differently in the last bit (FMA contraction, the order of a
# sum, the card's sin/cos/rsqrt), and a specular chain amplifies such a
# bit until a lane hits another surface some bounces later. Only such a
# lane may trace a different number of segments, and at most max_depth
# more or fewer, so the segment totals may differ by at most (lanes that
# disagree) x max_depth; equal totals are the rule everywhere else.
LANE_FRACTION = 0.995


def kernel_vs_reference(scene_id: str, n: int = 1 << 20, *,
                        max_depth: int = 12, seed: int = 0,
                        chunk: int = 1 << 17, width: int = 1024,
                        height: int = 768):
    """The kernel against XLA ``trace`` in ``exact`` mode (the arithmetic
    the kernel follows) on ``n`` camera rays of a width x height frame,
    with the integrator's threefry uniforms injected into the kernel. The
    kernel traces all n rays in one launch; the reference runs in chunks
    (its [rays, triangles, 3] intermediates), each chunk drawing from its
    own key. Returns (fraction of agreeing lanes, kernel segments,
    reference segments, the largest difference in segments that the
    disagreeing lanes can explain: their number x max_depth)."""
    scene = pt.load_scene(scene_id, "scenes")
    g = np.random.default_rng(seed)
    cam = {k: jnp.asarray(v) for k, v in camera_arrays(scene.camera).items()}
    o, d = generate_rays(
        jnp.asarray(g.integers(0, width * height, n), jnp.int32),
        jnp.asarray(g.integers(0, 4, n), jnp.int32),
        jnp.asarray(g.uniform(size=(n, 2)), jnp.float32), cam, width, height)
    bufs = prepare_scene(scene)
    root = rng.root_key(seed)
    rads, uni, x_rays = [], [], 0.0
    for c in range(0, n, chunk):
        key = rng.chunk_key(root, c)
        m = min(chunk, n - c)
        res = trace(o[c:c + m], d[c:c + m], bufs, key, max_depth=max_depth,
                    mode="exact")
        rads.append(np.asarray(res.radiance))
        x_rays += float(res.rays_traced)
        U = jnp.stack([rng.bounce_uniforms(key, s, (m,), 4)
                       for s in range(max_depth)])
        uni.append(U.transpose(0, 2, 1).reshape(max_depth * 4, m))
    tables = megakernel.scene_tables(pt.pack_scene(scene))
    k_rad, k_rays = megakernel.trace_rays(
        tables, o, d, jnp.concatenate(uni, axis=1), max_depth=max_depth)
    agree = np.abs(np.asarray(k_rad) - np.concatenate(rads)).sum(axis=1) < 1e-3
    return (float(agree.mean()), float(k_rays), x_rays,
            float((~agree).sum() * max_depth))


def image_rmse(a: np.ndarray, b: np.ndarray) -> float:
    """RMSE of two [npix, 3] linear images on tone-mapped 8-bit values / 255
    (the PARITY_REPORT.md metric)."""
    qa = quantize_np(np.asarray(a, np.float32)) / 255.0
    qb = quantize_np(np.asarray(b, np.float32)) / 255.0
    return float(np.sqrt(((qa - qb) ** 2).mean()))


def exact_references(scene, cfg, seeds=(7, 13)):
    """Two XLA ``exact`` renders (highest precision) with independent
    seeds: the reference images and their RMSE, the Monte-Carlo noise
    floor of one render at this spp."""
    a, b = (pt.render(scene, cfg.with_(backend="exact", seed=s,
                                       f32_precision="highest"),
                      out_dir=None, verbose=False).image.pixels
            for s in seeds)
    return a, image_rmse(a, b)


def parity(pixels: np.ndarray, reference: np.ndarray, noise: float):
    """(rmse, ok) under the PARITY_REPORT.md rule."""
    rmse = image_rmse(pixels, reference)
    return rmse, rmse <= RMSE_SLACK * noise


def device_summary() -> dict:
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}

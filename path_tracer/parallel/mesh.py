"""Sharded rendering over a device mesh.

Maps the ray megabatch onto a 2D ``Mesh(dp, sp)``:

- the pixel axis is sharded over ``dp`` (each device owns a contiguous
  framebuffer tile; zero communication),
- the sample axis is sharded over ``sp`` (each device traces a subset of each
  pixel's samples; one ``psum`` merges the partial sums).

In the XLA modes RNG streams are decorrelated per (pass, dp-shard,
sp-shard), so images are deterministic for a fixed (seed, chunking, mesh
topology). The kernel keys its random numbers by (pixel, global sample),
so its sharded image equals the one-device image.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from path_tracer.models.scene import SceneDescriptor
from path_tracer.ops import rng
from path_tracer.ops.pallas import megakernel
from path_tracer.render import integrator
from path_tracer.render.pipeline import (
    DEFAULT_LANE_BUDGET,
    KERNEL_PASS_SPP,
    RenderDone,
    _pick_samples_per_pass,
    prepare_scene_and_mode,
    render,
)
from path_tracer.utils.config import RenderConfig


def _factor_mesh(n: int, sample_parallel: int | None) -> tuple[int, int]:
    """Choose (dp, sp) with dp*sp = n. Default: all data-parallel."""
    if sample_parallel is None:
        return n, 1
    if n % sample_parallel:
        raise ValueError(f"sample_parallel={sample_parallel} must divide {n}")
    return n // sample_parallel, sample_parallel


def make_mesh(num_devices: int = 0, sample_parallel: int | None = None) -> Mesh:
    devices = jax.devices()
    n = num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    dp, sp = _factor_mesh(n, sample_parallel)
    return Mesh(np.asarray(devices[:n]).reshape(dp, sp), axis_names=("dp", "sp"))


@lru_cache(maxsize=64)
def make_sharded_pass(
    mesh: Mesh,
    *,
    width: int,
    height: int,
    k_full: int,
    max_depth: int = 12,
    rr_start_depth: int = 5,
    mode: str = "fast",
) -> Callable:
    """Build a pass runner shard_map'ed over the mesh.

    lru-cached (the runner is stateless): a fresh ``jax.jit`` per render
    would re-trace and re-load every compiled program on each call.

    Signature matches pipeline.render's pass_runner:
    (scene_bufs, cam, accum, pass_idx, k_pass, base_key) -> (accum, rays).
    accum is [npix_padded, 3], sharded over dp on axis 0.

    k_full is the FULL pass size (k_full % sp == 0); each call's k_pass may
    be any value <= k_full (the ragged remainder pass included) — it rides
    the one compiled program as a RUNTIME limit: the kernel splits it into
    per-shard runtime quotas, XLA modes mask the samples at index >= limit.
    The reference honors any spp in [1,10000] (main.rs:157-170); this is the
    sharded equivalent.
    """
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    if k_full % sp:
        raise ValueError(f"k_full={k_full} must be divisible by sp={sp}")
    if mode not in ("fast", "exact", "pallas"):
        raise ValueError(
            f"make_sharded_pass cannot shard mode={mode!r}; expected "
            "fast/exact/pallas"
        )
    npix = width * height

    def _local_pass(scene_bufs, cam, accum_local, pass_idx, base_key, limit):
        # inside shard_map: accum_local is this device's pixel tile;
        # limit (traced) = valid samples this pass, <= k_full
        npix_local = accum_local.shape[0]
        dp_idx = lax.axis_index("dp")
        sp_idx = lax.axis_index("sp")

        k_local = k_full // sp  # static per-shard cap
        pix_base = dp_idx * npix_local
        # decorrelated stream per (pass, dp, sp)
        key = rng.chunk_key(base_key, (pass_idx * sp + sp_idx) * dp + dp_idx)

        if mode == "pallas":
            # the kernel does its own raygen from pixel indices, so a dp
            # shard hands it its tile's indices (padding marked -1); sp
            # shards split the pass's RUNTIME sample count into contiguous
            # per-shard quotas: shard i gets cnt = limit//sp (+1 for the
            # first limit%sp shards), starting at its prefix sum.
            pix_local = pix_base + jnp.arange(npix_local, dtype=jnp.int32)
            pix_local = jnp.where(pix_local < npix, pix_local, -1)
            base_cnt = limit // sp
            rem = limit - base_cnt * sp
            cnt = base_cnt + (sp_idx < rem).astype(jnp.int32)
            start = sp_idx * base_cnt + jnp.minimum(sp_idx, rem)
            rad_sum, rays = megakernel.render_pixels(
                scene_bufs["kernel"], cam, pix_local,
                jax.random.key_data(base_key), pass_idx * k_full + start, cnt,
                width=width, height=height, max_depth=max_depth,
                rr_start_depth=rr_start_depth,
            )
            accum_local = accum_local + lax.psum(rad_sum, "sp")
            return accum_local, lax.psum(rays, ("dp", "sp"))

        # XLA modes: static per-shard width k_local; samples whose global
        # index lands at or beyond the runtime limit trace (cheap, only the
        # one ragged pass wastes <= sp-1 lanes/pixel) but contribute zero.
        gid = jnp.arange(k_local, dtype=jnp.int32) + sp_idx * k_local
        pixel_idx = (
            jnp.repeat(jnp.arange(npix_local, dtype=jnp.int32), k_local) + pix_base
        )
        sample_idx = jnp.tile(gid, npix_local) + pass_idx * k_full

        res = integrator.render_samples(
            scene_bufs,
            cam,
            pixel_idx,
            sample_idx,
            key,
            width=width,
            height=height,
            max_depth=max_depth,
            rr_start_depth=rr_start_depth,
            mode=mode,
        )
        valid = (gid < limit).astype(jnp.float32)[None, :, None]
        partial_sum = (
            res.radiance.reshape(npix_local, k_local, 3) * valid
        ).sum(axis=1)
        # merge sample shards; dp tiles stay put
        accum_local = accum_local + lax.psum(partial_sum, "sp")
        rays = lax.psum(res.rays_traced, ("dp", "sp"))
        return accum_local, rays

    @partial(jax.jit, donate_argnames=("accum",))
    def pass_fn(scene_bufs, cam, accum, pass_idx, base_key, limit):
        sharded = jax.shard_map(
            _local_pass,
            mesh=mesh,
            in_specs=(P(), P(), P("dp", None), P(), P(), P()),
            out_specs=(P("dp", None), P()),
            # the integrator's scan carry starts unvarying (fresh zeros) and
            # becomes device-varying after step 1 — skip the static VMA check
            check_vma=False,
        )
        return sharded(scene_bufs, cam, accum, pass_idx, base_key, limit)

    def runner(scene_bufs, cam, accum, pass_idx, k_pass, base_key):
        if k_pass > k_full:
            raise ValueError(f"k_pass={k_pass} exceeds k_full={k_full}")
        return pass_fn(
            scene_bufs, cam, accum, jnp.int32(pass_idx), base_key,
            jnp.int32(k_pass),
        )

    return runner


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def render_sharded(
    scene: SceneDescriptor,
    config: RenderConfig,
    *,
    num_devices: int = 0,
    sample_parallel: int | None = None,
    mesh: Mesh | None = None,
    **kw,
) -> RenderDone:
    """Multi-device render: pipeline.render with a shard_map'ed pass.

    The framebuffer is padded so the pixel axis divides dp; padding rows are
    cropped at the end.
    """
    mesh = mesh or make_mesh(num_devices, sample_parallel)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    res = config.resolution
    npix = res.num_pixels
    npix_pad = _round_up(npix, dp)
    scene_bufs, mode = prepare_scene_and_mode(scene, config.backend)

    # the scene is host-loaded on every process (deterministic, no
    # broadcast); refuse to render against divergent inputs
    from path_tracer.parallel.distributed import check_scene_consistency

    if not check_scene_consistency(scene):
        raise RuntimeError(
            "scene digests differ across hosts — every process must load an "
            "identical scene (same JSON + meshes) before render_sharded"
        )

    # full-pass size k: must divide by sp (static shapes); any spp is then
    # honored exactly via the runtime limit/quota machinery in
    # make_sharded_pass — no rounding of samples_per_pixel (parity:
    # main.rs:157-170 honors any spp in [1,10000])
    k = config.samples_per_pass
    if not k:
        if mode == "pallas":
            # per-shard runtime quotas of one kernel pass each
            k = min(config.samples_per_pixel, KERNEL_PASS_SPP * sp)
        else:
            k = _pick_samples_per_pass(
                npix_pad, config.samples_per_pixel, DEFAULT_LANE_BUDGET
            )
    k = max(_round_up(k, sp), sp)
    k = min(k, _round_up(config.samples_per_pixel, sp))
    config = config.with_(samples_per_pass=k)

    runner = make_sharded_pass(
        mesh,
        width=res.width,
        height=res.height,
        k_full=k,
        max_depth=config.max_depth,
        rr_start_depth=config.rr_start_depth,
        mode=mode,
    )

    sharding = NamedSharding(mesh, P("dp", None))
    accum0 = jax.device_put(jnp.zeros((npix_pad, 3), jnp.float32), sharding)
    replicate = NamedSharding(mesh, P())
    scene_bufs = jax.device_put(scene_bufs, replicate)

    return render(
        scene,
        config,
        device_buffers=scene_bufs,
        device_mode=mode,
        pass_runner=runner,
        accum_init=accum0,
        **kw,
    )

"""Host-side render orchestration.

Replaces the reference's thread/channel architecture (``mod.rs:928-1099``:
rayon pool + cancel-watcher thread + progress thread + mutexed framebuffer)
with chunked device dispatch: one jit call per sample-pass, a pure-functional
accumulator that never leaves the device between passes, progress callbacks
and cooperative cancellation between dispatches, and chunk-level
checkpoint/resume at pass boundaries (the reference has no persistence at
all).

Cancellation parity (§3.3 of the survey): a cancelled render still produces a
``RenderDone`` with the partial image and still writes the PPM.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from path_tracer.models.scene import SceneDescriptor, pack_scene
from path_tracer.ops import rng
from path_tracer.ops.pallas import megakernel
from path_tracer.ops.intersect import triangle_coeffs_np
from path_tracer.render import integrator
from path_tracer.render.image import Image, write_ppm
from path_tracer.render.raygen import camera_arrays
from path_tracer.utils.config import RenderConfig
from path_tracer.utils.profiling import RenderStats


@dataclass
class RenderUpdate:
    progress: float
    image: Image | None = None
    samples_done: int = 0
    stats: RenderStats | None = None


@dataclass
class RenderDone:
    image: Image
    duration: float
    stats: RenderStats = field(default_factory=RenderStats)
    ppm_path: str | None = None
    cancelled: bool = False


# Target wavefront width per XLA dispatch (lanes). ~2M lanes is ~160 MB of
# carried scan state in device memory, enough to fill the device.
DEFAULT_LANE_BUDGET = 2 * 1024 * 1024

# Samples per pixel in one kernel pass. The quota is a runtime value, so any
# pass size reuses the compiled kernel; progress, cancel and checkpoints land
# on pass boundaries, and a larger quota shortens each block's tail (lanes
# that finished their quota wait for the slowest lane of the block).
KERNEL_PASS_SPP = 256


def prepare_scene(
    scene: SceneDescriptor, mode: str = "fast", packed=None
) -> dict:
    """Pack + upload scene buffers: the XLA tables, plus precomputed
    triangle coefficients ("fast") or the kernel's tables ("pallas")."""
    packed = packed if packed is not None else pack_scene(scene)
    bufs = {k: jnp.asarray(v) for k, v in packed.buffers().items()}
    if mode == "fast":
        bufs["tri_coeffs"] = {
            k: jnp.asarray(v) for k, v in triangle_coeffs_np(packed.tri_v).items()
        }
    if mode == "pallas":
        bufs["kernel"] = megakernel.scene_tables(packed)
    return bufs


def prepare_scene_and_mode(
    scene: SceneDescriptor, backend: str
) -> tuple[dict, str]:
    """Resolve the backend and upload the scene's buffers for it."""
    mode = resolve_backend(backend)
    return prepare_scene(scene, mode), mode


def resolve_backend(backend: str) -> str:
    """RenderConfig.backend → execution mode: "pallas" (the GPU megakernel),
    "fast" or "exact" (XLA).

    auto is the kernel on a GPU: it beat XLA fast end to end on every
    scene class measured, 11x to 100x on an H100 (PERF.md, PR 1). On the
    CPU auto is XLA fast. "pallas" needs a GPU: the CPU runs the kernel
    only inside ``megakernel.interpret_mode()``, which tests ask for
    explicitly. Other platforms are not supported."""
    platform = jax.default_backend()
    if platform not in ("gpu", "cpu"):
        raise ValueError(
            f"unsupported platform {platform!r}: the renderer runs on a GPU "
            "or on the CPU"
        )
    if backend == "auto":
        return "pallas" if platform == "gpu" else "fast"
    if backend == "pallas":
        if platform != "gpu" and not megakernel.interpreting():
            raise ValueError(
                "backend='pallas' needs a GPU (found only the CPU); use "
                "'fast' or 'exact' here"
            )
        return "pallas"
    if backend in ("fast", "exact"):
        return backend
    raise ValueError(
        f"unknown backend {backend!r}; expected auto, pallas, fast or exact"
    )


def _pick_samples_per_pass(npix: int, spp: int, budget: int) -> int:
    k = max(1, budget // max(npix, 1))
    return min(k, spp)


_CAM_CACHE: dict[tuple, dict] = {}


def _device_camera(camera) -> dict:
    """Device-resident camera basis arrays, cached by value so repeated
    renders of one pose upload nothing. Entries are tiny; the dict grows
    only with distinct camera poses (interactive orbits evict via FIFO)."""
    arrs = camera_arrays(camera)
    key = tuple(
        (k, np.asarray(v).tobytes()) for k, v in sorted(arrs.items())
    )
    hit = _CAM_CACHE.get(key)
    if hit is None:
        if len(_CAM_CACHE) >= 64:
            _CAM_CACHE.pop(next(iter(_CAM_CACHE)))
        hit = _CAM_CACHE[key] = {k: jnp.asarray(v) for k, v in arrs.items()}
    return hit


@functools.lru_cache(maxsize=8)
def _device_pixel_perm(width: int, height: int, npix_pad: int):
    """(perm [npix_pad] on device, inv [npix] host): cached — the Morton
    permutation is pure in (w, h), so it is uploaded once per size."""
    perm_np, inv_perm = morton_pixel_order(width, height)
    if npix_pad != len(perm_np):
        # pad lanes redo pixel 0; their accum rows are cropped at the end
        perm_np = np.concatenate(
            [perm_np, np.zeros(npix_pad - len(perm_np), perm_np.dtype)]
        )
    return jnp.asarray(perm_np), inv_perm


@functools.lru_cache(maxsize=8)
def morton_pixel_order(width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """(perm, inv): Z-order traversal of the pixel grid. Lane blocks then
    cover compact screen tiles (coherent rays for the kernel's block-level
    bounding-sphere skip).
    perm[i] = pixel index visited i-th; inv is its inverse. Cached: the
    argsort is ~30 ms of host time at 1024x768 — real money against a
    ~1 s steady-state render (callers must not mutate the arrays)."""
    p = np.arange(width * height, dtype=np.int64)
    row = p // width
    col = p % width

    def spread(v):  # 16-bit -> even bit positions
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    code = (spread(row) << 1) | spread(col)
    perm = np.argsort(code, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return perm, inv


def render(
    scene: SceneDescriptor,
    config: RenderConfig,
    *,
    progress: Callable[[RenderUpdate], None] | None = None,
    progress_interval: float = 0.5,
    progress_snapshots: bool = True,
    cancel: Callable[[], bool] | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    out_dir: str | None = "out",
    device_buffers: dict | None = None,
    device_mode: str | None = None,
    pass_runner: Callable | None = None,
    accum_init=None,
    verbose: bool = True,
) -> RenderDone:
    """Render a scene to completion (or cancellation). See module docstring."""
    config = config.validated()
    if config.f32_precision != "highest":
        from path_tracer.ops import intersect

        # process-global; affects newly compiled programs only
        intersect.set_precision(config.f32_precision)
    if checkpoint_path and not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"  # np.savez appends it regardless
    res = config.resolution
    npix = res.num_pixels
    spp = config.samples_per_pixel

    if verbose:
        print(
            f"Rendering scene {scene.id} ({len(scene.objects)} objects), "
            f"{spp} samples per pixel, {res.width}x{res.height} resolution"
        )

    literal = config.estimator == "literal"
    t_start = time.perf_counter()
    if device_buffers is not None:
        scene_bufs = device_buffers
        mode = device_mode or resolve_backend(config.backend)
        if literal and mode not in ("fast", "exact"):
            raise ValueError(
                "estimator='literal' needs an XLA mode (fast/exact); got "
                f"device_mode={mode!r}"
            )
    elif config.mock_random or literal:
        # both are XLA-only semantics switches: the kernel bakes the
        # shipped estimator (EPS_TRI_T + prev-exclusion) and its own hash RNG
        mode = resolve_backend(config.backend)
        mode = mode if mode in ("fast", "exact") else "fast"
        scene_bufs = prepare_scene(scene, mode)
    else:
        scene_bufs, mode = prepare_scene_and_mode(scene, config.backend)
    cam = _device_camera(scene.camera)
    base_key = rng.root_key(config.seed)

    budget = DEFAULT_LANE_BUDGET
    if mode in ("exact", "fast"):
        T = int(scene_bufs["tri_v"].shape[0])
        if mode == "exact":
            # the literal-arithmetic oracle materializes [lanes, T, 3]
            # intermediates — bound them to ~2 GB of device memory
            budget = min(budget, max(2_000_000_000 // (T * 36), 4096))
        else:
            # the matmul form materializes several [lanes, T] f32
            # intermediates (det/u/v/t) — same bound, smaller factor
            budget = min(budget, max(2_000_000_000 // (T * 16), 4096))
    # the kernel takes its quota at runtime: one compiled program serves
    # every pass size, including the ragged remainder
    kernel = mode == "pallas"
    if config.samples_per_pass:
        k = config.samples_per_pass
    elif kernel:
        k = min(spp, KERNEL_PASS_SPP)
    else:
        k = _pick_samples_per_pass(npix, spp, budget)
    full_passes, remainder = divmod(spp, k)

    # pixel chunking: when even one sample/pixel exceeds the lane budget
    # (full-res renders of triangle-heavy scenes in the XLA modes), split
    # the pixel axis across dispatches (config.pixel_chunk overrides)
    chunk = 0
    if pass_runner is None and mode in ("exact", "fast"):
        chunk = config.pixel_chunk
        if not chunk and npix > budget:
            chunk = max(budget // k, 4096)
        if chunk >= npix:
            chunk = 0
    npix_pad = npix if not chunk else ((npix + chunk - 1) // chunk) * chunk
    n_chunks = npix_pad // chunk if chunk else 1

    # Z-order pixel traversal (see morton_pixel_order); accum lives in
    # permuted order until finalize. Only the single-device path uses it.
    perm = inv_perm = None
    if pass_runner is None:
        perm, inv_perm = _device_pixel_perm(res.width, res.height, npix_pad)

    def unpermute(arr: np.ndarray) -> np.ndarray:
        return arr if inv_perm is None else arr[inv_perm]

    accum = (
        accum_init
        if accum_init is not None
        else jnp.zeros((npix_pad, 3), jnp.float32)
    )
    # sharded accum (render_sharded): checkpoints must gather the global
    # value (multi-host: np.asarray on a non-addressable array would throw)
    # and restores must re-shard it. Every jax array carries a .sharding
    # (SingleDeviceSharding for plain arrays), so "is it sharded" tests for
    # a NamedSharding.
    accum_sharding = getattr(accum, "sharding", None)
    is_sharded_accum = isinstance(accum_sharding, jax.sharding.NamedSharding)

    def accum_to_host(a) -> np.ndarray:
        from path_tracer.parallel.distributed import assemble_image

        return assemble_image(a)

    def host_to_accum(a_np: np.ndarray):
        if accum_sharding is None or jax.process_count() == 1:
            return jax.device_put(jnp.asarray(a_np), accum_sharding)
        return jax.make_array_from_callback(
            a_np.shape, accum_sharding, lambda idx: a_np[idx]
        )
    samples_done = 0
    pass_start = 0
    stats = RenderStats()

    # ---- resume ----
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        mismatches = [
            f"{name} {int(ck[name])} != {want}"
            for name, want in (
                ("seed", config.seed), ("spp", spp), ("npix", npix), ("k", k),
            )
            if int(ck[name]) != want
        ]
        if ck["accum"].shape[0] != npix_pad:
            mismatches.append(
                f"accum rows {ck['accum'].shape[0]} != {npix_pad} (chunking)"
            )
        if not mismatches:
            accum = host_to_accum(ck["accum"])
            samples_done = int(ck["samples_done"])
            pass_start = int(ck["next_pass"])
            stats.num_rays = int(ck["num_rays"])
            stats.resumed_samples = samples_done
            if verbose:
                print(f"Resumed from {checkpoint_path} at {samples_done}/{spp} spp")
        else:
            # a silently dropped checkpoint would discard hours of
            # accumulation without a trace — ALWAYS say why it was ignored
            import sys

            print(
                f"WARNING: ignoring checkpoint {checkpoint_path} "
                f"(config mismatch: {'; '.join(mismatches)}); "
                "rendering restarts from zero",
                file=sys.stderr,
            )

    def run_pass(accum, pass_idx: int, k_pass: int):
        if pass_runner is not None:
            return pass_runner(scene_bufs, cam, accum, pass_idx, k_pass, base_key)
        rays = jnp.zeros((), jnp.float32)
        for c in range(n_chunks):
            accum, r = integrator.render_pass(
                scene_bufs,
                cam,
                accum,
                jnp.int32(pass_idx),
                base_key,
                # global sample base (k = FULL pass size, not k_pass)
                sample_base=jnp.int32(pass_idx * k),
                width=res.width,
                height=res.height,
                samples_in_pass=0 if kernel else k_pass,
                max_depth=config.max_depth,
                rr_start_depth=config.rr_start_depth,
                mode=mode,
                pixel_perm=perm,
                mock_random=config.mock_random,
                pixel_chunk=chunk,
                chunk_start=jnp.int32(c * chunk) if chunk else None,
                quota_rt=jnp.int32(k_pass) if kernel else None,
                literal=literal,
            )
            rays = rays + r
        return accum, rays

    last_update = 0.0
    cancelled = False

    def maybe_progress(force: bool = False):
        nonlocal last_update
        if progress is None:
            return
        now = time.perf_counter()
        if not force and now - last_update < progress_interval:
            return
        last_update = now
        img = None
        if progress_snapshots and samples_done > 0:
            partial = integrator.finalize(accum, samples_done)
            # accum may be padded beyond the framebuffer (sharded execution)
            img = Image.new(unpermute(np.asarray(partial)[:npix]), res)
        progress(
            RenderUpdate(
                progress=min(samples_done / spp, 1.0),
                image=img,
                samples_done=samples_done,
                stats=stats,
            )
        )

    # ---- pass schedule: full passes of k samples, then one remainder pass ----
    schedule = [(i, k) for i in range(pass_start, full_passes)]
    if remainder:
        schedule.append((full_passes, remainder))
    # resume may land inside the remainder
    schedule = [(i, kp) for (i, kp) in schedule if i >= pass_start]

    # ray counts are fetched lazily: an int() per pass would block the host
    # until the device finishes, serializing passes — keeping them as device
    # handles lets jax queue the next pass while the previous one runs.
    # Counts arrive as f32 (reduced on device), so passes beyond 2^24 rays
    # are rounded to ~1e-7 relative — num_rays is a throughput metric, not
    # an exact tally; the int64 host sum avoids adding further error
    ray_handles: list = []

    def drain_rays():
        nonlocal ray_handles
        if ray_handles:
            counts = np.asarray(jnp.stack(ray_handles))
            stats.num_rays += int(counts.astype(np.int64).sum())
        ray_handles = []

    # hookless fast path: no progress, no cancel, no checkpoint, no pixel
    # chunking, not resumed — run all FULL passes as ONE fused dispatch
    # (integrator.render_passes_fused); the remainder pass (if any) still
    # goes through the ordinary loop below.
    if (
        pass_runner is None and progress is None and cancel is None
        and not (checkpoint_path and checkpoint_every)
        and not config.mock_random and not chunk and pass_start == 0
        and full_passes > 1
    ):
        accum, rays = integrator.render_passes_fused(
            scene_bufs, cam, accum, base_key,
            n_passes=full_passes, width=res.width, height=res.height,
            samples_in_pass=0 if kernel else k,
            max_depth=config.max_depth,
            rr_start_depth=config.rr_start_depth, mode=mode,
            pixel_perm=perm,
            quota_rt=jnp.int32(k) if kernel else None,
            literal=literal,
        )
        ray_handles.append(rays)
        samples_done += k * full_passes
        stats.num_samples += k * full_passes * npix
        stats.num_dispatches += 1
        schedule = [(i, kp) for (i, kp) in schedule if i >= full_passes]

    for pass_idx, k_pass in schedule:
        if cancel is not None and cancel():
            if verbose:
                print("Canceling render prematurely")
            cancelled = True
            break
        accum, rays = run_pass(accum, pass_idx, k_pass)
        ray_handles.append(rays)
        samples_done += k_pass * 1  # per pixel
        stats.num_samples += k_pass * npix
        stats.num_dispatches += n_chunks
        maybe_progress()

        if checkpoint_path and checkpoint_every and (
            (pass_idx + 1) % checkpoint_every == 0
        ):
            drain_rays()  # the snapshot stores the count up to this pass
            accum.block_until_ready()
            np.savez(
                checkpoint_path,
                accum=accum_to_host(accum),
                samples_done=samples_done,
                next_pass=pass_idx + 1,
                seed=config.seed,
                spp=spp,
                npix=npix,
                k=k,
                num_rays=stats.num_rays,
            )

    # ---- finalize ----
    final = integrator.finalize(accum, max(samples_done, 1))
    if not is_sharded_accum and jax.process_count() == 1:
        # one device-to-host copy for image + ray counts
        packed = jnp.concatenate(
            [final.reshape(-1)]
            + ([jnp.stack(ray_handles)] if ray_handles else [])
        )
        host = np.asarray(packed)
        if ray_handles:
            counts = host[final.size:]
            stats.num_rays += int(counts.astype(np.int64).sum())
            ray_handles = []
        final_np = host[: final.size].reshape(final.shape)
    else:
        drain_rays()  # host fetch: syncs all queued passes
        final.block_until_ready()
        final_np = accum_to_host(final)
    duration = time.perf_counter() - t_start
    stats.wall_seconds = duration

    image = Image.new(unpermute(final_np[:npix]), res)
    if verbose:
        print("Rendering complete" if not cancelled else "Rendering cancelled")

    ppm_path = None
    if out_dir is not None:
        ppm_path = write_ppm(image, scene.id, spp, duration, out_dir=out_dir)

    if checkpoint_path and not cancelled and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)

    maybe_progress(force=True)
    return RenderDone(
        image=image,
        duration=duration,
        stats=stats,
        ppm_path=ppm_path,
        cancelled=cancelled,
    )

"""Progressive preview renderer.

The device-side equivalent of the reference's interactive wgpu raster
viewport (survey §2.11): the same path tracer at low spp per frame with
accumulation across frames, restarted on camera moves. Feeds any host UI a
steadily-denoising image at interactive rates. The camera is a kernel input,
so a camera move restarts accumulation without recompiling anything.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from path_tracer.models.scene import SceneDescriptor
from path_tracer.ops import rng
from path_tracer.render import integrator
from path_tracer.render.image import Image
from path_tracer.render.pipeline import prepare_scene
from path_tracer.render.raygen import camera_arrays
from path_tracer.utils.config import RenderConfig, Resolution


class ProgressiveRenderer:
    """Accumulates samples frame by frame; reset() on scene/camera edits.

    Thread-safe: step/reset/move_camera serialize on an internal lock (the
    HTTP viewer serves concurrent requests, and render_pass donates the
    accumulator — a concurrent second dispatch would hit a deleted buffer).
    """

    def __init__(
        self,
        scene: SceneDescriptor,
        resolution: Resolution,
        spp_per_frame: int = 2,
        seed: int = 0,
        max_depth: int = 12,
        backend: str = "auto",
    ):
        from path_tracer.render.pipeline import prepare_scene_and_mode

        self.scene = scene
        self.resolution = resolution
        self.spp_per_frame = spp_per_frame
        self.seed = seed
        self.max_depth = max_depth
        import threading

        self._lock = threading.Lock()
        self.scene_bufs, self.mode = prepare_scene_and_mode(scene, backend)
        self.reset()

    def reset(self) -> None:
        """Restart accumulation (after camera/scene edits)."""
        with self._lock:
            self._reset_locked()

    def _reset_locked(self) -> None:
        npix = self.resolution.num_pixels
        self._accum = jnp.zeros((npix, 3), jnp.float32)
        self._frame = 0
        self._cam = {
            k: jnp.asarray(v) for k, v in camera_arrays(self.scene.camera).items()
        }
        self._key = rng.root_key(self.seed)

    @property
    def samples_done(self) -> int:
        return self._frame * self.spp_per_frame

    def step(self) -> Image:
        """Render one frame's worth of samples; returns the running image."""
        with self._lock:
            self._advance_locked()
            img = integrator.finalize(self._accum, self.samples_done)
            return Image.new(np.asarray(img), self.resolution)

    def step_u8(self) -> np.ndarray:
        """One frame, fetched gamma-quantized as uint8 ``[npix, 3]``.

        The display transport for HTTP viewers: gamma + quantization run
        on-device and the frame crosses the host link as 1 byte/channel —
        4x smaller than the f32 ``Image`` ``step()`` fetches. Same quantizer
        as the PPM writer (``to_int_with_gamma_correction``) up to f32-pow
        last-ulp rounding."""
        from path_tracer.ops import tonemap

        with self._lock:
            self._advance_locked()
            img8 = tonemap.to_int_with_gamma_correction(
                integrator.finalize(self._accum, self.samples_done)
            ).astype(jnp.uint8)
            return np.asarray(img8)

    def _advance_locked(self) -> None:
        kernel = self.mode == "pallas"
        self._accum, _ = integrator.render_pass(
            self.scene_bufs,
            self._cam,
            self._accum,
            jnp.int32(self._frame),
            self._key,
            # equal-sized frames: frame index * per-frame spp
            sample_base=jnp.int32(self._frame * self.spp_per_frame),
            width=self.resolution.width,
            height=self.resolution.height,
            samples_in_pass=0 if kernel else self.spp_per_frame,
            max_depth=self.max_depth,
            mode=self.mode,
            quota_rt=jnp.int32(self.spp_per_frame) if kernel else None,
        )
        self._frame += 1

    def move_camera(self, camera) -> None:
        with self._lock:
            self.scene.camera = camera
            self._reset_locked()

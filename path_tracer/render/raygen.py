"""Camera ray generation.

Parity with ``render_pixel`` (``mod.rs:794-843``):

- pixel index → (x, y) with the y flip ``y = H-1 - idx/W``;
- sample s maps to a 2×2 subpixel grid (``ysub=(s/2)%2``, ``xsub=s%2``);
- tent filter ``r<1 ? sqrt(r)-1 : 1-sqrt(2-r)`` on 2×uniform;
- sensor-plane position ``sensor_origin + su*sx + sv*sy`` with
  ``sx = (x + 0.5*(0.5+xsub+xf))/W - 0.5``;
- the ray originates at the lens center and points from the sensor position
  through the pinhole: ``normalize(lens_center - sensor_pos)``.

Vectorized over a flat batch of (pixel_index, sample_index) pairs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

import numpy as np

from path_tracer.models.camera import Camera


def camera_arrays(camera: Camera) -> dict[str, np.ndarray]:
    """Host-precomputed camera basis (lens_center/orthogonals once per render,
    parity with mod.rs:998-999)."""
    su, sv = camera.orthogonals()
    return {
        "sensor_origin": np.asarray(camera.position, np.float32),
        "su": su,
        "sv": sv,
        "lens_center": camera.lens_center(),
    }


def tent_filter(u):
    """u in [0,1) → tent-distributed offset in (-1, 1)."""
    r = 2.0 * u
    return jnp.where(r < 1.0, jnp.sqrt(r) - 1.0, 1.0 - jnp.sqrt(jnp.maximum(2.0 - r, 0.0)))


def generate_rays(pixel_idx, sample_idx, u, cam: dict, width: int, height: int):
    """pixel_idx [N] i32, sample_idx [N] i32, u [N,2] uniforms → (o, d) [N,3]."""
    y = (height - 1 - pixel_idx // width).astype(jnp.float32)
    x = (pixel_idx % width).astype(jnp.float32)

    ysub = ((sample_idx // 2) % 2).astype(jnp.float32)
    xsub = (sample_idx % 2).astype(jnp.float32)

    xf = tent_filter(u[:, 0])
    yf = tent_filter(u[:, 1])

    sx = (x + 0.5 * (0.5 + xsub + xf)) / width - 0.5
    sy = (y + 0.5 * (0.5 + ysub + yf)) / height - 0.5

    sensor_pos = (
        cam["sensor_origin"][None, :]
        + cam["su"][None, :] * sx[:, None]
        + cam["sv"][None, :] * sy[:, None]
    )
    lens = cam["lens_center"][None, :]
    d = lens - sensor_pos
    d = d * lax.rsqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    o = jnp.broadcast_to(lens, d.shape)
    return o, d

"""Time the interactive preview loop on the GPU.

Measures exactly what the HTTP viewer pays per request, per transport:

  f32   ProgressiveRenderer.step()    — one low-spp pass + running-average
        finalize + [npix,3] f32 frame fetch (12 B/pixel)
  u8    ProgressiveRenderer.step_u8() — same pass, gamma+quantize
        ON-DEVICE, [npix,3] uint8 fetch (3 B/pixel — 4x smaller payload)

plus the drag-restart latency (reset() + first frame: what a camera move
costs before the first denoised frame lands).

Protocol: warm every program first, then 2nd-best of N warm frames; each
rep is one frame fetch because the frame fetch is the quantity under test.

Usage: python scripts/bench_progressive.py [res_y] [reps]
       (scenes x spp/frame grid is fixed; res defaults to the reference
        GUI default 300 -> 450x300, main.rs:91-92)
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
os.chdir(_ROOT)  # scene/mesh paths are repo-relative

from path_tracer.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

from path_tracer.models.scenes import load_scene  # noqa: E402
from path_tracer.utils.config import Resolution  # noqa: E402
from path_tracer.viewer.progressive import ProgressiveRenderer  # noqa: E402


def time_frames(r, fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[1]


def main():
    res_y = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    res = Resolution.from_height(res_y)
    grid = [
        ("cornell", 1), ("cornell", 2), ("cornell", 4),
        ("two-spheres", 2),
        ("mesh", 1), ("mesh", 2), ("mesh", 4),
    ]
    print(f"preview loop @ {res.width}x{res.height}, 2nd-best of {reps}")
    print(f"{'scene':>12} {'spp/f':>5} {'f32 ms':>8} {'u8 ms':>8} "
          f"{'u8 fps':>7} {'restart ms':>10}")
    for sid, spp in grid:
        r = ProgressiveRenderer(load_scene(sid), res, spp_per_frame=spp)
        r.step(); r.step_u8()  # warm both transports' programs
        t32 = time_frames(r, r.step, reps)
        tu8 = time_frames(r, r.step_u8, reps)
        # drag-restart: reset + first u8 frame (what a camera move costs)
        restarts = []
        for _ in range(4):
            t0 = time.perf_counter()
            r.reset()
            r.step_u8()
            restarts.append(time.perf_counter() - t0)
        tre = sorted(restarts)[1]
        print(f"{sid:>12} {spp:>5} {t32 * 1e3:>8.1f} {tu8 * 1e3:>8.1f} "
              f"{1.0 / tu8:>7.1f} {tre * 1e3:>10.1f}")


if __name__ == "__main__":
    main()

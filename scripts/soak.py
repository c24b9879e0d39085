"""Serving soak test: N consecutive renders in one process.

Asserts what production serving needs: flat steady-state timing (no
per-render slowdown) and bounded host memory (donated device buffers —
no per-render leak). Run on the GPU:

    python scripts/soak.py [n_renders]
"""

import os
import resource
import statistics
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
os.chdir(_ROOT)


def main(n: int = 30) -> int:
    from path_tracer.utils.runtime import enable_compile_cache

    enable_compile_cache()
    import path_tracer as pt
    from path_tracer.utils.config import RenderConfig, Resolution

    scene = pt.load_scene("cornell", "scenes")
    cfg = RenderConfig(samples_per_pixel=512, resolution=Resolution(768, 1024))
    pt.render(scene, cfg, out_dir=None, verbose=False)  # warm/compile

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        pt.render(scene, cfg, out_dir=None, verbose=False)
        times.append(time.perf_counter() - t0)
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    med = statistics.median(times)
    first = statistics.median(times[: max(n // 6, 2)])
    last = statistics.median(times[-max(n // 6, 2):])
    print(f"{n} renders: median {med:.2f}s  first-sixth {first:.2f}s  "
          f"last-sixth {last:.2f}s  max {max(times):.2f}s")
    print(f"peak RSS {rss0:.2f} -> {rss1:.2f} GB")
    drift = last / first
    leak = rss1 - rss0
    ok = drift < 1.15 and leak < 1.0
    print("OK" if ok else f"FAIL (drift {drift:.2f}x, rss +{leak:.2f} GB)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 30))

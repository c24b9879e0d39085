"""Headline throughput: cornell.json at 1024×768 through ``pt.render`` on one GPU.

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "spp", "wall_s", "device"}. Steady state: one
warm-up render (compile), then the 2nd-best of 4 timed renders, each
timed by the pipeline from scene upload to the final image on the host,
counting traced ray segments (alive lanes summed over bounces). Fails
without a GPU: a CPU number is not a device measurement.

    python bench.py            # BENCH_SPP (default 512) and BENCH_BACKEND
"""

import json
import os

os.chdir(os.path.dirname(os.path.abspath(__file__)))


def main():
    from path_tracer.utils.runtime import (
        card_info, enable_compile_cache, require_gpu,
    )

    enable_compile_cache()
    require_gpu()
    import jax

    import path_tracer as pt
    from path_tracer.utils.config import RenderConfig, Resolution

    print(card_info(), flush=True)
    spp = int(os.environ.get("BENCH_SPP", "512"))
    backend = os.environ.get("BENCH_BACKEND", "auto")
    scene = pt.load_scene("cornell", "scenes")
    cfg = RenderConfig(samples_per_pixel=spp, resolution=Resolution(768, 1024),
                       backend=backend)
    kw = dict(out_dir=None, verbose=False)
    pt.render(scene, cfg, **kw)  # compile
    runs = sorted((pt.render(scene, cfg, **kw) for _ in range(4)),
                  key=lambda d: d.duration)
    done = runs[1]
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "cornell_1024x768_throughput",
        "value": done.stats.mrays_per_sec,
        "unit": "Mrays/s",
        "spp": spp,
        "wall_s": done.duration,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()

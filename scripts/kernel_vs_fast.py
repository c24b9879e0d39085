"""The megakernel against XLA ``fast`` on one GPU: the table behind
``resolve_backend``'s auto choice, the kernel's tuning sweep and its
lanewise check.

    python scripts/kernel_vs_fast.py [--check] [--sweep] [--table]

--check  kernel vs XLA ``trace`` with injected uniforms, 2^20 rays each
         for cornell, mesh and two-spheres (chip_smoke.py phase 2);
--sweep  kernel-only device time over block size x num_warps, full
         1024x768 frame (cornell at 32 spp, mesh at 8 spp);
--table  end to end through ``pt.render``, warm, in one process: kernel
         and fast on cornell 1024x768 @ 1000, mesh 1024x768 @ 200,
         mesh 450x300 @ 500 and two-spheres 384x256 @ 64; the median of
         the timed renders.
With no flag, all three. Every line is also appended, as JSON, to
chiprun_out/kernel_vs_fast.jsonl.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TABLE = [
    ("cornell", 1024, 768, 1000),
    ("mesh", 1024, 768, 200),
    ("mesh", 450, 300, 500),
    ("two-spheres", 384, 256, 64),
]
SWEEP = [(64, 2), (128, 2), (128, 4), (256, 4), (256, 8), (512, 8)]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--check", action="store_true")
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--table", action="store_true")
    p.add_argument("--reps", type=int, default=3)
    a = p.parse_args()
    if not (a.check or a.sweep or a.table):
        a.check = a.sweep = a.table = True
    os.chdir(ROOT)
    from path_tracer.utils.runtime import (
        card_info, enable_compile_cache, require_gpu,
    )

    enable_compile_cache()
    require_gpu()
    os.makedirs("chiprun_out", exist_ok=True)
    log = open(os.path.join("chiprun_out", "kernel_vs_fast.jsonl"), "a")
    card = card_info()

    def emit(**rec):
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        log.write(json.dumps(rec) + "\n")
        log.flush()

    print(card, flush=True)
    if a.check:
        check(emit)
    if a.sweep:
        sweep(emit)
    if a.table:
        table(emit, a.reps)


def check(emit):
    from path_tracer.chipcheck import kernel_vs_reference

    for sid in ("cornell", "mesh", "two-spheres"):
        t0 = time.perf_counter()
        frac, k_rays, x_rays, slack = kernel_vs_reference(sid)
        emit(phase="check", scene=sid, lanes=1 << 20, frac=frac,
             kernel_rays=k_rays, ref_rays=x_rays, ray_slack=slack,
             seconds=time.perf_counter() - t0)


def sweep(emit):
    import jax
    import jax.numpy as jnp

    import path_tracer as pt
    from path_tracer.ops.pallas import megakernel
    from path_tracer.render.pipeline import morton_pixel_order
    from path_tracer.render.raygen import camera_arrays

    w, h = 1024, 768
    perm = jnp.asarray(morton_pixel_order(w, h)[0])
    for sid, spp in (("cornell", 32), ("mesh", 8)):
        scene = pt.load_scene(sid, "scenes")
        tables = megakernel.scene_tables(pt.pack_scene(scene))
        cam = {k: jnp.asarray(v) for k, v in
               camera_arrays(scene.camera).items()}
        seed = jax.random.key_data(jax.random.PRNGKey(0))
        for block, warps in SWEEP:
            def run():
                rad, rays = megakernel.render_pixels(
                    tables, cam, perm, seed, 0, spp, width=w, height=h,
                    block=block, num_warps=warps)
                rad.block_until_ready()
                return float(rays)

            t0 = time.perf_counter()
            run()
            compile_s = time.perf_counter() - t0
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                rays = run()
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls)
            emit(phase="sweep", scene=sid, spp=spp, block=block,
                 num_warps=warps, wall_s=wall, mrays_s=rays / wall / 1e6,
                 first_call_s=compile_s)


def table(emit, reps):
    import path_tracer as pt
    from path_tracer.utils.config import RenderConfig, Resolution

    for sid, w, h, spp in TABLE:
        scene = pt.load_scene(sid, "scenes")
        for backend in ("pallas", "fast"):
            cfg = RenderConfig(samples_per_pixel=spp,
                               resolution=Resolution(h, w), backend=backend)
            t0 = time.perf_counter()
            pt.render(scene, cfg, out_dir=None, verbose=False)
            first = time.perf_counter() - t0
            runs = [pt.render(scene, cfg, out_dir=None, verbose=False)
                    for _ in range(reps)]
            walls = sorted(r.duration for r in runs)
            mid = runs[[r.duration for r in runs].index(
                statistics.median_low(walls))]
            emit(phase="table", scene=sid, res=f"{w}x{h}", spp=spp,
                 backend=backend, wall_s=mid.duration, walls=walls,
                 mrays_s=mid.stats.mrays_per_sec, rays=mid.stats.num_rays,
                 first_render_s=first)


if __name__ == "__main__":
    main()

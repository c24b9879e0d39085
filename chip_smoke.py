"""Proof that the renderer runs on the GPU, through the entry points a user
calls, with every kernel compiled for the card.

    python chip_smoke.py           # one card: phases 1-5
    python chip_smoke.py --multi   # four cards: phase 6 only

1. Device: a GPU is required; prints the card's name and power limit.
2. Kernel vs reference at real width: the megakernel against XLA ``trace``
   (exact mode) with injected uniforms on 2^20 camera rays each of
   cornell, mesh and two-spheres: >= 99.5% of lanes within 1e-3, and ray
   counts that differ by no more than the disagreeing lanes x max_depth
   (see chipcheck.LANE_FRACTION for why not exactly equal).
3. End to end: the CLI renders cornell at res_y 768 (1152x768) @ 1000 spp and
   ``pt.render`` mesh 450x300 @ 500; each image must agree with XLA
   ``exact`` at equal spp: RMSE(image, exact) <= 1.15 x RMSE(exact seed a,
   exact seed b), on tone-mapped 8-bit values (PARITY_REPORT.md).
4. Daemon: ``server.serve(isolate=False)`` in a thread on its own socket
   answers two jobs (cornell and mesh, 450x300 @ 100).
5. Viewer: ``ViewerState(preview_res=300)`` serves three preview frames,
   orbits, serves two more; the etag changes after the move.
6. (--multi) ``render_sharded`` on cornell 1024x768 @ 1000 and mesh
   450x300 @ 500 at dp x sp = 4x1 and 2x2 against one-card renders under
   the same RMSE rule, the same-seed image against the one-card image, and
   a check that the sharded pass really ran on all four cards.

Everything runs in this one process: a JAX process reserves most of the
card's memory, so a second process on the card would fail. Any failed
phase exits non-zero before the last line, which is otherwise exactly
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# The workloads of each phase (the sizes the repo treats as real).
KERNEL_SCENES = ("cornell", "mesh", "two-spheres")
KERNEL_LANES = 1 << 20
CLI_RUN = ("cornell", 1152, 768, 1000)  # scene, width, height (res_y*3/2), spp
PT_RUN = ("mesh", 450, 300, 500)
DAEMON_JOBS = (("cornell", 300, 100), ("mesh", 300, 100))  # scene, res_y, spp
PREVIEW_RES = 300
MULTI_RUNS = (("cornell", 1024, 768, 1000), ("mesh", 450, 300, 500))


def phase(num: int, name: str, fn, *args):
    t0 = time.perf_counter()
    print(f"== phase {num}: {name}", flush=True)
    try:
        fn(*args)
    except Exception:
        traceback.print_exc()
        print(f"phase {num} ({name}) FAILED after "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        raise SystemExit(1)
    print(f"phase {num} ({name}) ok in {time.perf_counter() - t0:.1f} s",
          flush=True)


def check(cond: bool, what: str):
    print(("  ok   " if cond else "  FAIL ") + what, flush=True)
    if not cond:
        raise AssertionError(what)


def device_phase():
    from path_tracer.utils.runtime import card_info

    import jax

    print(card_info(), flush=True)
    print(f"  jax {jax.__version__}: {jax.devices()}", flush=True)


def kernel_phase():
    from path_tracer.chipcheck import LANE_FRACTION, kernel_vs_reference

    for sid in KERNEL_SCENES:
        frac, k_rays, x_rays, slack = kernel_vs_reference(sid, KERNEL_LANES)
        check(abs(k_rays - x_rays) <= slack,
              f"{sid}: ray counts kernel {k_rays:.0f} vs reference "
              f"{x_rays:.0f} (difference {k_rays - x_rays:+.0f}, at most "
              f"{slack:.0f} from the disagreeing lanes)")
        check(frac >= LANE_FRACTION,
              f"{sid}: {frac:.6f} of {KERNEL_LANES} lanes agree within 1e-3")


def parity_check(label, pixels, scene, cfg):
    from path_tracer.chipcheck import RMSE_SLACK, exact_references, parity

    ref, noise = exact_references(scene, cfg)
    rmse, ok = parity(pixels, ref, noise)
    check(ok, f"{label}: RMSE(prod, exact) {rmse:.5f} <= {RMSE_SLACK} x "
              f"noise {noise:.5f}")


def end_to_end_phase(out_dir):
    import numpy as np

    import path_tracer as pt
    from path_tracer import cli
    from path_tracer.ops.tonemap import quantize_np
    from path_tracer.render.image import read_ppm
    from path_tracer.utils.config import RenderConfig, Resolution

    sid, w0, h0, spp = CLI_RUN
    cli_out = os.path.join(out_dir, "cli")
    t0 = time.perf_counter()
    rc = cli.main([str(spp), str(h0), sid, "--no-daemon", "--quiet",
                   "--out-dir", cli_out])
    check(rc == 0, f"cli {sid} {w0}x{h0} @ {spp} exit 0 "
                   f"({time.perf_counter() - t0:.1f} s with compile)")
    (ppm,) = [os.path.join(cli_out, f) for f in os.listdir(cli_out)]
    vals, w, h = read_ppm(ppm)
    check((w, h) == (w0, h0), f"PPM is {w}x{h}")
    # the PPM holds quantized values in reverse pixel order; invert the
    # quantizer's gamma to compare on the same 8-bit grid
    q = vals[::-1].astype(np.float32)
    lin = (q / 255.0) ** 2.2
    check(np.array_equal(quantize_np(lin.astype(np.float32)), q),
          "PPM values survive the inverse-gamma round trip")
    scene = pt.load_scene(sid, "scenes")
    cfg = RenderConfig(samples_per_pixel=spp, resolution=Resolution(h0, w0))
    parity_check(f"{sid} {w0}x{h0} @ {spp} (cli)", lin, scene, cfg)

    sid, w0, h0, spp = PT_RUN
    scene = pt.load_scene(sid, "scenes")
    cfg = RenderConfig(samples_per_pixel=spp, resolution=Resolution(h0, w0))
    done = pt.render(scene, cfg, out_dir=None, verbose=False)
    print(f"  {sid} {w0}x{h0} @ {spp}: {done.duration:.2f} s, "
          f"{done.stats.mrays_per_sec:.1f} Mrays/s (first render)",
          flush=True)
    parity_check(f"{sid} {w0}x{h0} @ {spp} (pt.render)", done.image.pixels,
                 scene, cfg)


def daemon_phase(out_dir):
    from path_tracer import server
    from path_tracer.render.image import read_ppm

    sock = os.path.join(tempfile.mkdtemp(prefix="ptd"), "d.sock")
    ready = threading.Event()
    t = threading.Thread(
        target=server.serve, args=(sock,),
        kwargs=dict(ready=ready, isolate=False,
                    out_dir=os.path.join(out_dir, "daemon")),
        daemon=True)
    t.start()
    check(ready.wait(60), "daemon listening")
    try:
        for sid, res_y, spp in DAEMON_JOBS:
            t0 = time.perf_counter()
            reply = server.submit({"scene": sid, "spp": spp, "res_y": res_y},
                                  socket_path=sock, timeout=900)
            check(reply.get("done") is True and not reply.get("cancelled"),
                  f"daemon {sid} res_y {res_y} @ {spp}: {reply} "
                  f"({time.perf_counter() - t0:.1f} s)")
            vals, w, h = read_ppm(reply["ppm_path"])
            check((w, h) == (res_y * 3 // 2, res_y) and vals.max() > 0
                  and reply["num_rays"] > 0, f"daemon {sid} image {w}x{h}")
    finally:
        server.submit({"shutdown": True}, socket_path=sock, timeout=60)
        t.join(60)
    check(not t.is_alive(), "daemon stopped")


def viewer_phase():
    from path_tracer.render.image import decode_png
    from path_tracer.viewer.app import ViewerState

    state = ViewerState(preview_res=PREVIEW_RES)
    tags = []
    for i in range(5):
        if i == 3:
            state.control("orbit", 40.0, 10.0)
        t0 = time.perf_counter()
        png, etag = state.preview_frame()
        tags.append(etag)
        print(f"  frame {i}: {time.perf_counter() - t0:.3f} s, etag {etag}",
              flush=True)
    shape = (PREVIEW_RES, PREVIEW_RES * 3 // 2, 3)
    check(decode_png(png).shape == shape, f"preview is {shape} RGB")
    check(tags[3] != tags[2], "etag changes after the orbit")
    check(len(set(tags)) == 5, "every frame adds samples (new etag)")


def multi_phase():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import path_tracer as pt
    from path_tracer.chipcheck import RMSE_SLACK, image_rmse
    from path_tracer.ops import rng
    from path_tracer.parallel.mesh import (
        make_mesh, make_sharded_pass, render_sharded,
    )
    from path_tracer.render.pipeline import prepare_scene_and_mode, \
        _device_camera
    from path_tracer.utils.config import RenderConfig, Resolution

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} cards")
    for sid, w, h, spp in MULTI_RUNS:
        scene = pt.load_scene(sid, "scenes")
        cfg = RenderConfig(samples_per_pixel=spp, resolution=Resolution(h, w))
        kw = dict(out_dir=None, verbose=False)
        pt.render(scene, cfg, **kw)  # compile
        one = pt.render(scene, cfg, **kw)
        noise = image_rmse(one.image.pixels,
                           pt.render(scene, cfg.with_(seed=1), **kw)
                           .image.pixels)
        for dp, sp in ((4, 1), (2, 2)):
            mesh = make_mesh(4, sample_parallel=sp)
            same = render_sharded(scene, cfg, mesh=mesh, **kw)  # compile
            same = render_sharded(scene, cfg, mesh=mesh, **kw)
            other = render_sharded(scene, cfg.with_(seed=2), mesh=mesh, **kw)
            rmse = image_rmse(other.image.pixels, one.image.pixels)
            label = f"{sid} {w}x{h} @ {spp} dp={dp} x sp={sp}"
            check(rmse <= RMSE_SLACK * noise,
                  f"{label}: RMSE(sharded, one card) {rmse:.5f} <= "
                  f"{RMSE_SLACK} x noise {noise:.5f}")
            diff = float(np.abs(same.image.pixels - one.image.pixels).max())
            check(diff <= 1e-4, f"{label}: same seed as one card, max "
                                f"|diff| {diff:.2e}")
            print(f"  {label}: {same.duration:.3f} s vs one card "
                  f"{one.duration:.3f} s ({one.duration / same.duration:.2f}x)"
                  f", {same.stats.mrays_per_sec:.1f} Mrays/s", flush=True)

        # one sharded kernel pass, read back shard by shard
        mesh = make_mesh(4, sample_parallel=1)
        bufs, mode = prepare_scene_and_mode(scene, "auto")
        runner = make_sharded_pass(mesh, width=w, height=h, k_full=4,
                                   mode=mode)
        accum = jax.device_put(jnp.zeros((w * h, 3), jnp.float32),
                               NamedSharding(mesh, P("dp", None)))
        bufs = jax.device_put(bufs, NamedSharding(mesh, P()))
        accum, _ = runner(bufs, _device_camera(scene.camera), accum, 0, 4,
                          rng.root_key(0))
        shards = accum.addressable_shards
        devs = {s.device for s in shards}
        sums = [float(jnp.sum(s.data)) for s in shards]
        check(len(devs) == 4 and min(sums) > 0.0,
              f"{sid} {mode} pass: 4 shards on {len(devs)} cards, "
              f"radiance per shard {[round(x) for x in sums]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: render_sharded against one card only")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from path_tracer.chipcheck import device_summary
    from path_tracer.utils.runtime import enable_compile_cache

    enable_compile_cache()
    phase(1, "device", device_phase)
    if args.multi:
        phase(6, "render_sharded on four cards", multi_phase)
    else:
        out_dir = tempfile.mkdtemp(prefix="chip_smoke")
        phase(2, "kernel vs reference at real width", kernel_phase)
        phase(3, "end to end vs XLA exact", end_to_end_phase, out_dir)
        phase(4, "daemon", daemon_phase, out_dir)
        phase(5, "viewer", viewer_phase)
    print(json.dumps({"ok": True, "device": device_summary()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

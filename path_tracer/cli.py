"""Headless render CLI.

The reference shipped a *dead* CLI (``src/cmd_render.rs`` — not in the module
tree, broken references; survey §2 C25) with the interface
``spp res_y scene_id|scene_index`` and a ``\r`` progress line with percent,
elapsed and estimated h:mm:ss. This is the live version of that interface,
plus flags for the device knobs.

Usage:
    python -m path_tracer.cli [spp] [res_y] [scene] [options]
    python -m path_tracer.cli 500 300 mesh
    python -m path_tracer.cli --list-scenes
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from path_tracer.utils.profiling import format_eta

# Defaults follow the GUI (main.rs:91-92: spp 100, res_y 300); the dead
# CLI's commented usage suggested 4000 spp @ 600 (cmd_render.rs:48).
DEFAULT_SPP = 100
DEFAULT_RES_Y = 300
DEFAULT_SCENE = "cornell"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="path_tracer",
        description="GPU path tracer (headless CLI)",
    )
    p.add_argument("spp", nargs="?", type=int, default=DEFAULT_SPP,
                   help=f"samples per pixel (default {DEFAULT_SPP})")
    p.add_argument("res_y", nargs="?", type=int, default=DEFAULT_RES_Y,
                   help=f"vertical resolution; width = res_y*3/2 (default {DEFAULT_RES_Y})")
    p.add_argument("scene", nargs="?", default=DEFAULT_SCENE,
                   help="scene id or numeric index (default cornell)")
    p.add_argument("--scene-dir", default="scenes")
    p.add_argument("--mesh-dir", default="meshes")
    p.add_argument("--out-dir", default="out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-depth", type=int, default=12)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "exact", "fast", "pallas"])
    p.add_argument("--samples-per-pass", type=int, default=0,
                   help="samples per device dispatch (0 = auto)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for resumable renders")
    p.add_argument("--checkpoint-every", type=int, default=8,
                   help="passes between checkpoints (with --checkpoint)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard over N devices (0 = single device)")
    p.add_argument("--list-scenes", action="store_true")
    p.add_argument("--no-validate", action="store_true",
                   help="skip the GUI-parity range checks on spp/res_y")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace into DIR")
    p.add_argument("--daemon", action="store_true",
                   help="run as a resident render daemon (see --socket); "
                        "subsequent CLI invocations dispatch to it and skip "
                        "the fresh process's jax start-up and kernel loads")
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="daemon socket path (default "
                        "~/.cache/path_tracer/daemon.sock)")
    p.add_argument("--warm", default=None, metavar="SPECS",
                   help="with --daemon: pre-compile scene:res_y kernels "
                        "before serving (e.g. cornell:768)")
    p.add_argument("--no-daemon", action="store_true",
                   help="render in-process even when a daemon is running")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans (the pure-functional analog "
                        "of the reference's race/sanitizer story: NaNs are "
                        "the only 'corruption' possible — fail fast on them)")
    return p


def resolve_scene(name: str, scene_dir: str, mesh_dir: str):
    from path_tracer.models.scenes import load_scene, load_scene_ids

    ids = load_scene_ids(scene_dir, mesh_dir)
    if name.isdigit() and name not in ids:
        idx = int(name)
        if not 0 <= idx < len(ids):
            raise SystemExit(f"scene index {idx} out of range (have {len(ids)})")
        name = ids[idx]
    if name not in ids:
        raise SystemExit(f"unknown scene {name!r}; available: {', '.join(ids)}")
    return load_scene(name, scene_dir, mesh_dir)


def _dispatch_to_daemon(args) -> int:
    """Forward the job to a resident daemon (milliseconds of client-side
    startup — no jax import). Returns the process exit code."""
    from path_tracer import server

    t0 = time.perf_counter()

    def progress(p):
        if args.quiet:
            return
        elapsed = time.perf_counter() - t0
        eta = elapsed / max(p, 1e-9)
        sys.stderr.write(
            f"\rRendering... {p * 100:5.1f}%  elapsed {format_eta(elapsed)}"
            f" / estimated {format_eta(eta)}   "
        )
        sys.stderr.flush()

    reply = server.submit(
        {
            "scene": args.scene,
            "spp": args.spp,
            "res_y": args.res_y,
            "seed": args.seed,
            "max_depth": args.max_depth,
            "backend": args.backend,
            "samples_per_pass": args.samples_per_pass,
            "out_dir": args.out_dir,
            "checkpoint": args.checkpoint,
            "checkpoint_every": args.checkpoint_every,
            "validate": not args.no_validate,
        },
        socket_path=args.socket or server.DEFAULT_SOCKET,
        progress=progress,
    )
    if not args.quiet:
        sys.stderr.write("\n")
    if "error" in reply:
        print(f"daemon error: {reply['error']}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(
            f"Done in {reply['duration']:.2f} s —"
            f" {reply['msamples_per_sec']:.1f} Msamples/s,"
            f" {reply['mrays_per_sec']:.1f} Mrays/s ({reply['num_rays']} rays,"
            f" via daemon)"
        )
        if reply.get("ppm_path"):
            print(f"Wrote {reply['ppm_path']}")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.daemon:
        from path_tracer import server

        return server.main(
            (["--socket", args.socket] if args.socket else [])
            + (["--warm", args.warm] if args.warm else [])
            + ["--scene-dir", args.scene_dir, "--mesh-dir", args.mesh_dir,
               "--out-dir", args.out_dir]
        )

    # a resident daemon renders without fresh-process startup costs; use it
    # when present. PT_NO_DAEMON opts out globally (tests set it so CI
    # never silently depends on a daemon that happens to be running).
    if (not args.no_daemon and not args.list_scenes
            and not os.environ.get("PT_NO_DAEMON")):
        from path_tracer import server

        if server.daemon_running(args.socket or server.DEFAULT_SOCKET):
            return _dispatch_to_daemon(args)

    from path_tracer.utils.runtime import enable_compile_cache

    enable_compile_cache()

    from path_tracer.models.scenes import load_scene_ids
    from path_tracer.render.pipeline import render
    from path_tracer.utils.config import RenderConfig, Resolution
    from path_tracer.utils.profiling import profiler_trace

    if args.debug_nans:
        import jax

        jax.config.update("jax_debug_nans", True)

    if args.list_scenes:
        for i, sid in enumerate(load_scene_ids(args.scene_dir, args.mesh_dir)):
            print(f"{i}: {sid}")
        return 0

    scene = resolve_scene(args.scene, args.scene_dir, args.mesh_dir)
    config = RenderConfig(
        samples_per_pixel=args.spp,
        resolution=Resolution.from_height(args.res_y),
        seed=args.seed,
        max_depth=args.max_depth,
        backend=args.backend,
        samples_per_pass=args.samples_per_pass,
        validate=not args.no_validate,
    )

    t0 = time.perf_counter()

    def progress(update):
        # parity with cmd_render.rs:54-80: \r percent + elapsed/eta h:mm:ss
        if args.quiet:
            return
        pct = update.progress * 100.0
        elapsed = time.perf_counter() - t0
        eta = elapsed / max(update.progress, 1e-9)
        sys.stderr.write(
            f"\rRendering... {pct:5.1f}%  elapsed {format_eta(elapsed)}"
            f" / estimated {format_eta(eta)}   "
        )
        sys.stderr.flush()

    render_fn = render
    if args.devices:
        from path_tracer.parallel.mesh import render_sharded

        def render_fn(scene, config, **kw):
            return render_sharded(scene, config, num_devices=args.devices, **kw)

    with profiler_trace(args.profile):
        done = render_fn(
            scene,
            config,
            progress=progress,
            progress_snapshots=False,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            out_dir=args.out_dir,
            verbose=not args.quiet,
        )
    if not args.quiet:
        sys.stderr.write("\n")
        s = done.stats
        print(
            f"Done in {done.duration:.2f} s — {s.msamples_per_sec:.1f} Msamples/s,"
            f" {s.mrays_per_sec:.1f} Mrays/s ({s.num_rays} rays,"
            f" {s.num_dispatches} dispatches)"
        )
        if done.ppm_path:
            print(f"Wrote {done.ppm_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Render daemon: a resident process serving render jobs over a unix socket.

The reference is a desktop app; its "serving" story is the GUI worker
(main.rs:340-401). On an accelerator the equivalent production concern is
process start-up: a fresh CLI process pays the jax import and the
compile-cache load before its first pass. The daemon keeps one process
(and its compiled kernels) resident; clients submit jobs and stream
progress over a line-delimited JSON protocol:

    client → {"scene": "cornell", "spp": 100, "res_y": 300,
              "checkpoint": "ck.npz", ...}\n
    server → {"progress": 0.25}\n ...
    server → {"done": true, "ppm_path": ..., "duration": ...,
              "msamples_per_sec": ..., "mrays_per_sec": ...}\n
    or     → {"error": "..."}\n

Jobs run serially (the card is single-tenant); a job failure is reported
to its client and the daemon keeps serving (failure isolation). The
client side (`submit`, used by cli.py) deliberately imports neither jax
nor the framework — connecting costs milliseconds.

Failure detection / recovery (survey §5: the reference has none): with
``isolate=True`` (the CLI default) jobs execute in a persistent *worker
subprocess*, the only process of the daemon that touches the card. The
front-end relays the worker's line-JSON stream to the client and watches
for stalls — a hung device call cannot be interrupted by any in-process
cooperative cancel. If the worker emits nothing for ``stall_timeout``
seconds (default 900, above any cold compile), it is killed and reaped,
the client gets an error, and the next job respawns a fresh worker whose
kernels reload from the on-disk compile cache. Checkpointed jobs
(``checkpoint=...``) resume where the killed render left off.

A JAX process reserves most of the card's memory when it first uses it,
so a daemon and another renderer (the viewer app, a CLI render with
``--no-daemon``) must not share one card.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import socketserver
import subprocess
import sys
import threading

DEFAULT_SOCKET = os.path.join(
    os.path.expanduser("~"), ".cache", "path_tracer", "daemon.sock"
)


# --------------------------------------------------------------------------
# client (no jax / framework imports — keep startup at milliseconds)
# --------------------------------------------------------------------------

def submit(job: dict, socket_path: str = DEFAULT_SOCKET, progress=None,
           timeout: float | None = None):
    """Send a render job to a running daemon; returns the final reply dict.

    progress: optional callback receiving each {"progress": f} message.
    Raises ConnectionError if no daemon is listening.
    """
    try:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(timeout)
        conn.connect(socket_path)
    except OSError as e:
        raise ConnectionError(f"no render daemon at {socket_path}: {e}") from e
    with conn:
        conn.sendall(json.dumps(job).encode() + b"\n")
        buf = b""
        while True:
            chunk = conn.recv(65536)
            if not chunk:
                raise ConnectionError("daemon closed the connection mid-job")
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                msg = json.loads(line)
                if "progress" in msg and progress is not None:
                    progress(msg["progress"])
                if "done" in msg or "error" in msg:
                    return msg


def daemon_running(socket_path: str = DEFAULT_SOCKET) -> bool:
    """True when a daemon accepts connections at socket_path."""
    try:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(0.25)
        conn.connect(socket_path)
        conn.close()
        return True
    except OSError:
        return False


# --------------------------------------------------------------------------
# server
# --------------------------------------------------------------------------

def _render_job(job: dict, send, scene_dir: str, mesh_dir: str,
                out_dir: str) -> dict:
    from path_tracer.models.scenes import load_scene
    from path_tracer.render.pipeline import render
    from path_tracer.utils.config import RenderConfig, Resolution

    scene = load_scene(str(job.get("scene", "cornell")), scene_dir, mesh_dir)
    config = RenderConfig(
        samples_per_pixel=int(job.get("spp", 100)),
        resolution=Resolution.from_height(int(job.get("res_y", 300))),
        seed=int(job.get("seed", 0)),
        max_depth=int(job.get("max_depth", 12)),
        backend=str(job.get("backend", "auto")),
        samples_per_pass=int(job.get("samples_per_pass", 0)),
        validate=bool(job.get("validate", True)),
    )
    done = render(
        scene,
        config,
        progress=lambda u: send({"progress": u.progress}),
        progress_snapshots=False,
        out_dir=job.get("out_dir", out_dir),
        checkpoint_path=job.get("checkpoint"),
        checkpoint_every=int(job.get("checkpoint_every", 8)),
        verbose=False,
    )
    s = done.stats
    return {
        "done": True,
        "ppm_path": done.ppm_path,
        "duration": done.duration,
        "cancelled": done.cancelled,
        "num_rays": s.num_rays,
        "msamples_per_sec": s.msamples_per_sec,
        "mrays_per_sec": s.mrays_per_sec,
        # per-pixel samples restored from a checkpoint (0 = fresh render)
        "resumed_samples": s.resumed_samples,
    }


def warm(specs: list[str], scene_dir: str, mesh_dir: str) -> None:
    """Pre-compile kernels for "scene:res_y" specs so the first real job
    doesn't pay the compile/cache load (renders one pass and discards the
    image). The kernel takes the per-pass sample count at RUNTIME, so this
    one pass warms jobs of EVERY spp at this scene/resolution."""
    from path_tracer.models.scenes import load_scene
    from path_tracer.render.pipeline import KERNEL_PASS_SPP, render
    from path_tracer.utils.config import RenderConfig, Resolution

    for spec in specs:
        sid, _, res = spec.partition(":")
        scene = load_scene(sid, scene_dir, mesh_dir)
        # one kernel pass: the program real jobs of any spp reuse
        render(scene, RenderConfig(samples_per_pixel=KERNEL_PASS_SPP,
                                   resolution=Resolution.from_height(
                                       int(res or 300))),
               out_dir=None, verbose=False)
        print(f"warmed {spec}")


def worker_loop(scene_dir: str, mesh_dir: str, out_dir: str) -> None:
    """Resident renderer child: one line-JSON job per stdin line, stream of
    progress/result lines on stdout. Crashes and hangs are the front-end's
    problem (that is the point — it can kill this process)."""
    # Claim fd 1 for the protocol and point everything else at stderr —
    # at the fd level, not just sys.stdout: native code (XLA dumps, driver
    # banners, ctypes printf) writes to fd 1 directly and would corrupt
    # the line-JSON stream.
    out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    jax_ready = False

    def ensure_jax():
        # LAZY: the watchdog test's echo/hang hooks and the kill/respawn
        # protocol stay import-free; the first render/warm job pays the
        # jax import instead.
        nonlocal jax_ready
        if jax_ready:
            return
        jax_ready = True
        import jax

        from path_tracer.utils.runtime import enable_compile_cache

        enable_compile_cache()
        if os.environ.get("PT_CPU"):
            # tests use CPU workers; the config route also covers a
            # platform chosen before this point
            jax.config.update("jax_platforms", "cpu")
            # small-shape CPU programs compile in <1 s each — below the
            # default persist threshold — so cache all of them: respawned
            # workers then skip recompiling
            jax.config.update(
                "jax_persistent_cache_min_compile_time_secs", 0.0
            )

    def send(msg: dict):
        out.write(json.dumps(msg) + "\n")
        out.flush()

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            job = json.loads(line)
            if "__warm__" in job:
                # one spec at a time, with a progress line after each, so a
                # multi-spec cold warm keeps resetting the watchdog clock
                ensure_jax()
                specs = list(job["__warm__"])
                for i, spec in enumerate(specs):
                    warm([spec], scene_dir, mesh_dir)
                    send({"progress": (i + 1) / len(specs)})
                send({"done": True, "warmed": specs})
                continue
            if job.get("__test_hang__"):  # stall-recovery test hook
                threading.Event().wait()
            if "__test_echo__" in job:  # watchdog test hook: no jax import
                send({"progress": 0.5})
                send({"done": True, "echo": job["__test_echo__"],
                      "pid": os.getpid()})
                continue
            ensure_jax()
            send(_render_job(job, send, scene_dir, mesh_dir, out_dir))
        except Exception as e:
            send({"error": f"{type(e).__name__}: {e}"})


class _Worker:
    """Persistent worker subprocess + line reader; respawned after failures."""

    def __init__(self, scene_dir: str, mesh_dir: str, out_dir: str):
        self._args = (scene_dir, mesh_dir, out_dir)
        self._proc: subprocess.Popen | None = None
        self._lines: queue.Queue | None = None

    def _spawn(self):
        scene_dir, mesh_dir, out_dir = self._args
        # run server.py by PATH, not -m: `-m path_tracer.server` first
        # imports the package __init__, which imports jax, and jobs that
        # never touch jax (the watchdog protocol itself) should not wait
        # for it. server.py's top-level imports are stdlib-only; everything
        # heavy is lazy. PYTHONPATH carries the repo root for those imports.
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(here)]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
        )
        self._proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "server.py"), "--worker",
             "--scene-dir", scene_dir, "--mesh-dir", mesh_dir,
             "--out-dir", out_dir],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env,
        )
        self._lines = queue.Queue()

        def reader(proc=self._proc, q=self._lines):
            for ln in proc.stdout:
                q.put(ln)
            q.put(None)  # EOF → worker died

        threading.Thread(target=reader, daemon=True).start()

    def run_job(self, job: dict, send, stall_timeout: float) -> dict:
        """Forward one job; relay its stream; kill on stall. Returns the
        final reply (also already sent for done/progress relaying)."""
        if self._proc is None or self._proc.poll() is not None:
            self._spawn()
        try:
            self._proc.stdin.write(json.dumps(job) + "\n")
            self._proc.stdin.flush()
        except OSError:
            self.kill()
            return {"error": "worker pipe broken; respawning on next job"}
        while True:
            try:
                ln = self._lines.get(timeout=stall_timeout)
            except queue.Empty:
                self.kill()
                return {"error":
                        f"worker made no progress for {stall_timeout:.0f}s "
                        "(device stall?); killed — checkpointed jobs resume "
                        "on retry"}
            if ln is None:
                self.kill()
                return {"error": "worker died mid-job; respawning on next job"}
            try:
                msg = json.loads(ln)
            except Exception as e:
                # a stray stdout line: the worker is mid-job and its
                # remaining output would answer the NEXT job (one-off
                # protocol desync). Kill it — a fresh worker costs one
                # respawn, a desynced one corrupts every job after.
                self.kill()
                return {"error": f"job relay failed ({type(e).__name__}: "
                                 f"{e}); worker killed"}
            if "done" in msg or "error" in msg:
                return msg
            try:
                send(msg)  # progress relay
            except Exception:
                # the CLIENT hung up mid-relay; the worker itself is fine.
                # Drain its stream to the job's final line so the protocol
                # stays in sync and the warm compiled state survives —
                # the job completes (and checkpoints) even with nobody
                # listening.
                send = lambda m: None  # noqa: E731 — drop later progress

    def kill(self):
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._proc = None


def serve(socket_path: str = DEFAULT_SOCKET, *, scene_dir: str = "scenes",
          mesh_dir: str = "meshes", out_dir: str = "out",
          ready: threading.Event | None = None, isolate: bool = False,
          stall_timeout: float = 900.0, warm_specs: list[str] | None = None,
          ) -> None:
    """Run the daemon until the process is killed (or a {"shutdown": true}
    job arrives — used by tests)."""
    os.makedirs(os.path.dirname(socket_path), exist_ok=True)
    if os.path.exists(socket_path):
        os.unlink(socket_path)  # stale socket from a dead daemon
    # one render at a time: the card is single-tenant — serialize at the
    # accept level
    lock = threading.Lock()
    shutdown = threading.Event()
    worker = _Worker(scene_dir, mesh_dir, out_dir) if isolate else None
    if worker is not None and warm_specs:
        r = worker.run_job({"__warm__": warm_specs}, lambda m: None,
                           max(stall_timeout, 1800.0))
        print(f"warm: {r}")  # surface failures — silent cold serving is worse

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            def send(msg: dict):
                self.wfile.write(json.dumps(msg).encode() + b"\n")
                self.wfile.flush()

            try:
                job = json.loads(self.rfile.readline() or b"{}")
                if job.get("shutdown"):
                    send({"done": True})
                    shutdown.set()
                    return
                with lock:
                    if worker is not None:
                        t = float(job.pop("stall_timeout", stall_timeout))
                        send(worker.run_job(job, send, t))
                    else:
                        send(_render_job(job, send, scene_dir, mesh_dir,
                                         out_dir))
            except Exception as e:  # job isolation: report, keep serving
                try:
                    send({"error": f"{type(e).__name__}: {e}"})
                except OSError:
                    pass  # client went away

    class Server(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True

    with Server(socket_path, Handler) as srv:
        if ready is not None:
            ready.set()
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        shutdown.wait()
        srv.shutdown()
    if worker is not None:
        worker.kill()
    if os.path.exists(socket_path):
        os.unlink(socket_path)


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="path_tracer.server",
                                description="resident render daemon")
    p.add_argument("--socket", default=DEFAULT_SOCKET)
    p.add_argument("--scene-dir", default="scenes")
    p.add_argument("--mesh-dir", default="meshes")
    p.add_argument("--out-dir", default="out")
    p.add_argument("--warm", default=None, metavar="SPECS",
                   help="comma-separated scene:res_y list to pre-compile "
                        "before serving (e.g. cornell:768,mesh:768)")
    p.add_argument("--worker", action="store_true",
                   help="internal: run as the resident renderer subprocess")
    p.add_argument("--no-isolate", action="store_true",
                   help="render in-process instead of a watchdogged worker "
                        "subprocess (no stall recovery)")
    p.add_argument("--stall-timeout", type=float, default=900.0,
                   help="seconds without worker output before a job is "
                        "declared stalled and the worker is killed")
    args = p.parse_args(argv)
    from path_tracer.utils.runtime import enable_compile_cache

    enable_compile_cache()  # inherited by the worker subprocess
    if args.worker:
        worker_loop(args.scene_dir, args.mesh_dir, args.out_dir)
        return 0
    warm_specs = args.warm.split(",") if args.warm else None
    if warm_specs and args.no_isolate:
        warm(warm_specs, args.scene_dir, args.mesh_dir)
    print(f"render daemon listening on {args.socket}")
    serve(args.socket, scene_dir=args.scene_dir, mesh_dir=args.mesh_dir,
          out_dir=args.out_dir, isolate=not args.no_isolate,
          stall_timeout=args.stall_timeout,
          warm_specs=None if args.no_isolate else warm_specs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Render daemon: unix-socket protocol, job isolation, shutdown."""

import os
import threading

import numpy as np
import pytest

from path_tracer import server


@pytest.fixture
def daemon(tmp_path):
    sock = str(tmp_path / "d.sock")
    ready = threading.Event()
    t = threading.Thread(
        target=server.serve,
        args=(sock,),
        kwargs=dict(scene_dir="scenes", mesh_dir="meshes",
                    out_dir=str(tmp_path / "out"), ready=ready),
        daemon=True,
    )
    t.start()
    assert ready.wait(10)
    yield sock
    server.submit({"shutdown": True}, socket_path=sock)
    t.join(10)


def test_daemon_renders_and_streams_progress(daemon, tmp_path):
    seen = []
    reply = server.submit(
        {"scene": "two-spheres", "spp": 8, "res_y": 24},
        socket_path=daemon, progress=seen.append,
    )
    assert reply["done"] and not reply["cancelled"]
    assert reply["num_rays"] > 0
    assert os.path.exists(reply["ppm_path"])
    assert all(0.0 <= p <= 1.0 for p in seen)


def test_daemon_job_isolation(daemon):
    bad = server.submit({"scene": "nope"}, socket_path=daemon)
    assert "error" in bad and "nope" in bad["error"]
    # the daemon must keep serving after a failed job
    ok = server.submit({"scene": "two-spheres", "spp": 4, "res_y": 24},
                       socket_path=daemon)
    assert ok.get("done")


def test_daemon_running_and_refused():
    assert not server.daemon_running("/tmp/definitely-not-a-socket")
    with pytest.raises(ConnectionError):
        server.submit({}, socket_path="/tmp/definitely-not-a-socket")


def test_daemon_checkpointed_job(daemon, tmp_path):
    ck = str(tmp_path / "job.ck.npz")
    seen_midrender = []

    def watch(p):
        # with checkpoint_every=1 the file must exist between passes —
        # proving the field is passed through, not silently dropped
        if 0.2 < p < 1.0:
            seen_midrender.append(os.path.exists(ck))

    reply = server.submit(
        {"scene": "two-spheres", "spp": 64, "res_y": 24,
         "checkpoint": ck, "checkpoint_every": 1, "samples_per_pass": 4},
        socket_path=daemon, progress=watch,
    )
    assert reply["done"]
    assert any(seen_midrender), "checkpoint never materialized mid-render"
    # completed renders clean up their checkpoint
    assert not os.path.exists(ck)


def test_daemon_resumes_checkpointed_job(daemon, tmp_path):
    """A daemon job pointed at a checkpoint left by an interrupted render
    RESUMES it instead of restarting from zero (the preemption-recovery
    story end-to-end: interrupt -> resubmit -> exact completion). Proof:
    the reply's resumed_samples equals the checkpoint's samples_done
    (num_rays alone cannot discriminate — a resume RESTORES the
    interrupted render's ray count, so totals match the full job), and
    the completed job cleans up the file."""
    import numpy as np

    import path_tracer as pt
    from path_tracer.utils.config import RenderConfig, Resolution

    job = {"scene": "two-spheres", "spp": 64, "res_y": 24,
           "samples_per_pass": 4}
    full = server.submit(dict(job), socket_path=daemon)
    assert full["done"] and full["resumed_samples"] == 0

    # interrupt a checkpointed render after its first checkpoint lands
    ck = str(tmp_path / "resume.ck.npz")
    scene = pt.load_scene("two-spheres", "scenes")
    cfg = RenderConfig(samples_per_pixel=64,
                       resolution=Resolution.from_height(24),
                       samples_per_pass=4)
    pt.render(scene, cfg, checkpoint_path=ck, checkpoint_every=1,
              cancel=lambda: os.path.exists(ck), out_dir=None,
              verbose=False)
    assert os.path.exists(ck)
    done0 = int(np.load(ck)["samples_done"])
    assert 0 < done0 < 64

    reply = server.submit({**job, "checkpoint": ck, "checkpoint_every": 1},
                          socket_path=daemon)
    assert reply["done"] and not reply["cancelled"]
    assert reply["resumed_samples"] == done0  # resumed, not restarted
    # a resume restores the interrupted render's ray count, so the total
    # must equal the uncheckpointed job's (per-pass seeds deterministic)
    assert reply["num_rays"] == full["num_rays"]
    assert not os.path.exists(ck)  # completed renders clean up


@pytest.fixture
def isolated_daemon(tmp_path, monkeypatch):
    """Daemon with the worker-subprocess watchdog (isolate=True). The worker
    is a fresh python that would pick the default (accelerator) backend;
    PT_CPU pins it to CPU (inherited through the environment)."""
    monkeypatch.setenv("PT_CPU", "1")
    sock = str(tmp_path / "di.sock")
    ready = threading.Event()
    t = threading.Thread(
        target=server.serve,
        args=(sock,),
        kwargs=dict(scene_dir="scenes", mesh_dir="meshes",
                    out_dir=str(tmp_path / "out"), ready=ready,
                    isolate=True),
        daemon=True,
    )
    t.start()
    assert ready.wait(10)
    yield sock
    server.submit({"shutdown": True}, socket_path=sock)
    t.join(10)


def test_isolated_daemon_watchdog_lifecycle(isolated_daemon):
    """Spawn/relay/stall-detect/kill/respawn of the worker subprocess,
    via no-jax echo jobs (CI exercises the watchdog mechanics only; the
    render-through-worker path shares _render_job with the in-process
    daemon tests above)."""
    seen = []
    first = server.submit({"__test_echo__": "a"}, socket_path=isolated_daemon,
                          progress=seen.append, timeout=120)
    assert first.get("done") and first["echo"] == "a", first
    assert seen == [0.5]  # progress relayed through the pipe

    bad = server.submit(
        {"__test_hang__": True, "stall_timeout": 3},
        socket_path=isolated_daemon, timeout=60,
    )
    assert "error" in bad and "no progress" in bad["error"], bad

    again = server.submit({"__test_echo__": "b"}, socket_path=isolated_daemon,
                          timeout=120)
    assert again.get("done") and again["echo"] == "b", again
    # recovery spawned a NEW worker process
    assert again["pid"] != first["pid"]

"""Viewer layer: controls math, picking, probe, raster preview, HTTP app."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import path_tracer as pt
from path_tracer.viewer.controls import SceneNavigator, axis_angle_matrix
from path_tracer.viewer.debug import test_scene_ray as scene_ray_probe
from path_tracer.viewer.raster import render_preview, grid_triangles


@pytest.fixture()
def cornell(all_scenes):
    """A private copy: navigation mutates the camera, and the session-wide
    scenes must stay as loaded for the tests that render them."""
    import copy

    return copy.deepcopy(all_scenes["cornell"])


def test_axis_angle_matrix():
    R = axis_angle_matrix(np.array([0, 1, 0]), np.pi / 2)
    np.testing.assert_allclose(R @ np.array([1, 0, 0]), [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(R @ np.array([0, 1, 0]), [0, 1, 0], atol=1e-6)


def test_orbit_preserves_pivot_distance(cornell):
    nav = SceneNavigator(cornell)
    cam = nav.scene.camera
    nav.begin_orbit()
    pivot = nav._orbit_point.copy()
    r0 = np.linalg.norm(cam.position - pivot)
    for _ in range(5):
        nav.orbit(40.0, 25.0)
    r1 = np.linalg.norm(cam.position - pivot)
    np.testing.assert_allclose(r0, r1, rtol=1e-4)
    # camera looks back at the pivot
    to_pivot = pivot - cam.position
    to_pivot /= np.linalg.norm(to_pivot)
    np.testing.assert_allclose(cam.direction, to_pivot, atol=1e-4)


def test_zoom_moves_along_direction(cornell):
    nav = SceneNavigator(cornell)
    cam = nav.scene.camera
    p0, d0 = cam.position.copy(), cam.direction.copy()
    nav.zoom(100.0)
    delta = cam.position - p0
    np.testing.assert_allclose(
        delta / np.linalg.norm(delta), d0, atol=1e-5
    )
    np.testing.assert_array_equal(cam.direction, d0)  # direction unchanged


def test_pan_is_perpendicular(cornell):
    nav = SceneNavigator(cornell)
    cam = nav.scene.camera
    p0 = cam.position.copy()
    nav.pan(50.0, 30.0)
    delta = cam.position - p0
    assert abs(np.dot(delta, cam.direction)) < 1e-5 * np.linalg.norm(delta)


def test_look_around_keeps_position(cornell):
    nav = SceneNavigator(cornell)
    cam = nav.scene.camera
    p0, d0 = cam.position.copy(), cam.direction.copy()
    nav.look_around(120.0, 60.0, viewport_height=400.0)
    np.testing.assert_array_equal(cam.position, p0)
    assert not np.allclose(cam.direction, d0)
    np.testing.assert_allclose(np.linalg.norm(cam.direction), 1.0, rtol=1e-5)


def test_pick_center_of_cornell(cornell):
    nav = SceneNavigator(cornell)
    # center of view: inside the box, should select *something*
    obj = nav.pick_object(0.5, 0.5, 1.5)
    assert obj is not None and 0 <= obj < 11


def test_probe_matches_oracle(all_scenes):
    from tests import oracle

    scene = all_scenes["cornell"]
    r = scene_ray_probe(0.5, 0.5, scene, verbose=False)
    assert r is not None
    # rebuild the same ray and check with the oracle
    cam = scene.camera
    su, sv = cam.orthogonals()
    sensor = cam.position + su * np.float32(0.0) + sv * np.float32(0.0)
    d = cam.lens_center() - sensor
    d = d / np.linalg.norm(d)
    ref = oracle.intersect_scene(scene.objects, cam.lens_center().astype(np.float64),
                                 d.astype(np.float64))
    assert ref is not None
    assert ref[0] == r.object_id
    np.testing.assert_allclose(ref[1][0], r.distance, rtol=1e-4)


def test_raster_preview(all_scenes):
    out = render_preview(all_scenes["cornell"], 96, 64)
    assert out["color"].shape == (64, 96, 3)
    assert out["depth"].shape == (64, 96)
    assert out["composite"].shape == (64, 96, 3)
    assert np.isfinite(out["color"]).all()
    # something was rasterized in the lower (color) half of the composite
    assert out["color"].std() > 0.01
    # the composite's top half is grayscale depth
    top = out["composite"][: 64 // 2]
    assert np.allclose(top[..., 0], top[..., 1])


def test_grid_spacing_log_scale():
    from path_tracer.models.camera import Camera

    near = grid_triangles(Camera.looking([0, 0, 4], [0, 0, -1]))[0]
    far = grid_triangles(Camera.looking([0, 0, 400], [0, 0, -1]))[0]
    assert far.max() > near.max() * 5  # spacing grows with zoom


def test_progressive_u8_transport(all_scenes):
    """step_u8 (the HTTP preview transport: on-device gamma+quantize,
    uint8 fetch) is the same quantizer as the PPM writer: exact vs the
    f32 formula on the renderer's own accumulator, within 1 count of the
    f64 host quantizer (f32-pow last-ulp rounding, tonemap.quantize_np)."""
    from path_tracer.ops import tonemap
    from path_tracer.render import integrator
    from path_tracer.utils.config import Resolution
    from path_tracer.viewer.progressive import ProgressiveRenderer

    r = ProgressiveRenderer(all_scenes["two-spheres"], Resolution.from_height(24))
    frame = r.step_u8()
    npix = r.resolution.num_pixels
    assert frame.dtype == np.uint8 and frame.shape == (npix, 3)
    fin = integrator.finalize(r._accum, r.samples_done)
    exact = np.asarray(tonemap.to_int_with_gamma_correction(fin))
    assert np.array_equal(frame, exact.astype(np.uint8))
    host = tonemap.quantize_np(np.asarray(fin))
    assert np.abs(frame.astype(np.int32) - host).max() <= 1
    # interleaving transports keeps one shared accumulation stream
    img = r.step()
    assert r.samples_done == 2 * r.spp_per_frame
    assert img.pixels.shape == (npix, 3)


def test_preview_png_orientation(repo_root):
    """The served preview PNG is the u8 frame in display orientation —
    the same double flip as Image.to_grid (row 0 = PPM row 0). PNG is
    lossless, so the decode must be bit-exact against the renderer's own
    accumulator."""
    import os

    from path_tracer.ops import tonemap
    from path_tracer.render.image import decode_png
    from path_tracer.render import integrator

    os.chdir(repo_root)
    from path_tracer.viewer.app import ViewerState

    state = ViewerState(preview_res=24)
    state.select_scene("two-spheres")
    png, _ = state.preview_frame()
    arr = decode_png(png)
    r = state.preview
    h, w = r.resolution.height, r.resolution.width
    exact = np.asarray(
        tonemap.to_int_with_gamma_correction(
            integrator.finalize(r._accum, r.samples_done)
        )
    ).astype(np.uint8)
    np.testing.assert_array_equal(arr, exact.reshape(h, w, 3)[::-1, ::-1, :])


@pytest.mark.filterwarnings("ignore")
def test_http_app_endpoints(repo_root):
    import os

    os.chdir(repo_root)
    from http.server import ThreadingHTTPServer

    from path_tracer.viewer.app import ViewerState, make_handler

    state = ViewerState(preview_res=32)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def get(p):
        return urllib.request.urlopen(f"http://127.0.0.1:{port}{p}", timeout=60).read()

    def post(p, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{p}", data=json.dumps(body).encode(),
            method="POST",
        )
        return json.loads(urllib.request.urlopen(req, timeout=120).read())

    try:
        assert b"path_tracer" in get("/")
        s = json.loads(get("/state"))
        assert s["render_state"] == "not_rendering"
        assert get("/preview.png")[:4] == b"\x89PNG"
        post("/select_scene", {"id": "two-spheres"})
        post("/start_render", {"spp": 4, "res_y": 16})
        deadline = time.time() + 120
        while time.time() < deadline:
            s = json.loads(get("/state"))
            if s["render_state"] == "done":
                break
            time.sleep(0.5)
        assert s["render_state"] == "done"
        assert get("/render.png")[:4] == b"\x89PNG"
        # validation error surfaces as HTTP 400
        with pytest.raises(urllib.error.HTTPError):
            post("/start_render", {"spp": 123456, "res_y": 16})
    finally:
        server.shutdown()

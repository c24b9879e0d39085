"""Scene JSON / OFF format parity and round-trips."""

import json
import os

import numpy as np
import pytest

import path_tracer as pt
from path_tracer.models.off import OffParseError, load_off, parse_off
from path_tracer.models.scene import SceneDescriptor, dumps_scene_json


def _semantic_diff(a, b, path=""):
    out = []
    if isinstance(a, dict) and isinstance(b, dict):
        for k in set(a) | set(b):
            if k == "updating_direction":  # legacy key, ignored on load
                continue
            if k not in a or k not in b:
                out.append(f"{path}.{k}: missing")
                continue
            out += _semantic_diff(a[k], b[k], f"{path}.{k}")
        return out
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: len {len(a)} vs {len(b)}"]
        for i, (x, y) in enumerate(zip(a, b)):
            out += _semantic_diff(x, y, f"{path}[{i}]")
        return out
    try:
        if np.float32(a) == np.float32(b):
            return []
        return [f"{path}: {a} vs {b}"]
    except (TypeError, ValueError):
        return [] if a == b else [f"{path}: {a!r} vs {b!r}"]


BUILTIN_MATCHES_SHIPPED = [
    "single-sphere",
    "cartesian",
    "two-spheres",
    "three-spheres",
    "cornell",
]


def test_builtins_match_shipped_scene_files(repo_root):
    os.chdir(repo_root)
    scenes = {s.id: s for s in pt.builtin_scenes("meshes")}
    for sid in BUILTIN_MATCHES_SHIPPED:
        shipped = json.load(open(os.path.join("scenes", f"{sid}.json")))
        ours = json.loads(dumps_scene_json(scenes[sid].to_json()))
        diff = _semantic_diff(ours, shipped, sid)
        assert not diff, diff[:10]


def test_mesh_scene_loads_with_legacy_keys(all_scenes):
    scene = all_scenes["mesh"]
    assert scene.num_objects == 8
    mesh_obj = scene.objects[0]
    assert not mesh_obj.is_sphere
    assert mesh_obj.mesh.num_triangles == 810


def test_scene_save_load_roundtrip(tmp_path, all_scenes):
    scene = all_scenes["cornell"]
    scene.save(str(tmp_path))
    loaded = SceneDescriptor.load("cornell", str(tmp_path))
    assert loaded.camera == scene.camera
    assert len(loaded.objects) == len(scene.objects)
    for a, b in zip(loaded.objects, scene.objects):
        np.testing.assert_array_equal(a.position, b.position)
        assert a.material == b.material
        if not a.is_sphere:
            np.testing.assert_array_equal(a.mesh.triangles, b.mesh.triangles)
            np.testing.assert_array_equal(
                a.mesh.bounding_sphere_center, b.mesh.bounding_sphere_center
            )


def test_off_loader_mctri(repo_root):
    mesh = load_off(os.path.join(repo_root, "meshes", "mctri.off"), 0.16)
    assert mesh.num_triangles == 810
    # scale applied to vertices
    assert np.abs(mesh.triangles).max() < 10.0


def test_off_rejects_non_triangles(repo_root):
    # hdodec.off has pentagonal faces → reference loader errors (survey §2.10)
    with pytest.raises(OffParseError):
        load_off(os.path.join(repo_root, "meshes", "hdodec.off"), 1.0)


def test_off_parse_errors():
    with pytest.raises(OffParseError):
        parse_off("NOT_OFF\n1 1 1\n")
    with pytest.raises(OffParseError):
        parse_off("OFF\n1 1\n")
    with pytest.raises(OffParseError):
        parse_off("OFF\n1 1 0\n0 0\n")


def test_off_comments_and_blanks():
    text = "# leading comment\n\nOFF\n# counts\n3 1 0\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n"
    tris = parse_off(text, 2.0)
    assert tris.shape == (1, 3, 3)
    np.testing.assert_array_equal(tris[0, 1], [2, 0, 0])


def test_float_formatting_shortest_f32():
    from path_tracer.models.scene import _fmt_f32

    assert _fmt_f32(np.float32(0.98) * 15) == "14.700001"
    assert _fmt_f32(2.0) == "2.0"
    assert _fmt_f32(-0.05989229) == "-0.05989229"
    assert _fmt_f32(13.536618) == "13.536618"


def test_load_scene_ids_generates_builtins(tmp_path, repo_root):
    os.chdir(repo_root)
    d = str(tmp_path / "scenes_new")
    ids = pt.load_scene_ids(d, "meshes")
    assert set(ids) == {
        "single-sphere",
        "cartesian",
        "two-spheres",
        "three-spheres",
        "cornell",
        "mesh",
    }
    # saved files reload
    scene = SceneDescriptor.load("cornell", d)
    assert scene.num_objects == 11

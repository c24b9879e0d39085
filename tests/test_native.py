"""Native C++ runtime vs pure-Python fallbacks (skipped if not built)."""

import os
import subprocess

import numpy as np
import pytest

from path_tracer import native


def _built():
    return native.native_available()


pytestmark = pytest.mark.skipif(
    not _built(), reason="libpt_native.so not built (make -C csrc)"
)


def test_off_matches_python(repo_root):
    from path_tracer.models.off import parse_off

    path = os.path.join(repo_root, "meshes", "mctri.off")
    tris_native = native.native_parse_off(path, 0.16)
    with open(path) as f:
        tris_py = parse_off(f.read(), 0.16)
    assert tris_native.shape == tris_py.shape == (810, 3, 3)
    np.testing.assert_allclose(tris_native, tris_py, rtol=1e-6)


def test_off_rejects_pentagons(repo_root):
    from path_tracer.models.off import OffParseError

    with pytest.raises(OffParseError):
        native.native_parse_off(os.path.join(repo_root, "meshes", "hdodec.off"), 1.0)


def test_ppm_body_matches_python():
    from path_tracer.ops.tonemap import quantize_np

    g = np.random.default_rng(0)
    px = g.uniform(-0.1, 1.1, (257, 3)).astype(np.float32)
    body = native.native_ppm_body(px, reverse=True)
    q = quantize_np(px)[::-1]
    expected = b"".join(b"%d %d %d " % tuple(row) for row in q)
    assert body == expected


def test_hash_matches_reference_fnv():
    from path_tracer.utils.hashing import fnv1a

    px = np.arange(30, dtype=np.float32) / 7.0
    assert native.native_hash_image(px) == fnv1a(px.tobytes())


def test_morton_codes():
    pts = np.array([[0, 0, 0], [0.9999999, 0.9999999, 0.9999999], [0.5, 0, 0]],
                   np.float32)
    codes = native.native_morton3d(pts)
    assert codes[0] == 0
    assert codes[1] == (1 << 30) - 1  # all 30 bits set (1023 per axis)
    # x=0.5 -> quantized 512 = bit 9 -> interleaved bit 27, x-shift +2 -> 29
    assert codes[2] == 1 << 29

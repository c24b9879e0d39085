"""ctypes bindings to the C++ native runtime (csrc/pt_native.cpp).

The native library accelerates host-side work that the reference did in Rust:
OFF mesh parsing, ASCII-P3 PPM encoding with gamma quantization, FNV-1a image
hashing, and Morton-code computation for LBVH builds. Every entry point has a
pure-Python fallback; the framework is fully functional without the library.

Build with ``make -C csrc`` (produces ``csrc/libpt_native.so``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "csrc", "libpt_native.so")


def load_native():
    """Load (and cache) the native library, or None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.environ.get("PT_NATIVE_LIB", _lib_path())
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.pt_parse_off.restype = ctypes.c_longlong
        lib.pt_parse_off.argtypes = [
            ctypes.c_char_p,            # path
            ctypes.c_float,             # scale
            ctypes.POINTER(ctypes.c_float),  # out triangles [cap*9]
            ctypes.c_longlong,          # cap (triangles)
        ]
        lib.pt_ppm_encode.restype = ctypes.c_longlong
        lib.pt_ppm_encode.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # pixels [n*3]
            ctypes.c_longlong,               # n pixels
            ctypes.c_int,                    # reverse order flag
            ctypes.POINTER(ctypes.c_char),   # out buffer
            ctypes.c_longlong,               # out capacity
        ]
        lib.pt_hash_image.restype = ctypes.c_ulonglong
        lib.pt_hash_image.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
        ]
        lib.pt_morton3d.restype = None
        lib.pt_morton3d.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # points [n*3] in [0,1)
            ctypes.c_longlong,                # n
            ctypes.POINTER(ctypes.c_uint32),  # out codes [n]
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def native_available() -> bool:
    return load_native() is not None


def native_parse_off(path: str, scale: float) -> np.ndarray | None:
    """Parse OFF via native code; returns [T,3,3] float32 or None (fallback)."""
    lib = load_native()
    if lib is None:
        return None
    # First call with cap=0 returns required triangle count (or -1 on error).
    need = lib.pt_parse_off(
        path.encode(), ctypes.c_float(scale), None, ctypes.c_longlong(0)
    )
    if need < 0:
        from path_tracer.models.off import OffParseError

        raise OffParseError(f"native OFF parse failed for {path} (code {need})")
    out = np.empty((max(int(need), 1), 3, 3), np.float32)
    got = lib.pt_parse_off(
        path.encode(),
        ctypes.c_float(scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(int(need)),
    )
    if got < 0:
        from path_tracer.models.off import OffParseError

        raise OffParseError(f"native OFF parse failed for {path} (code {got})")
    return out[: int(got)]


def native_ppm_body(pixels: np.ndarray, reverse: bool) -> bytes | None:
    """Encode gamma-quantized 'r g b ' ASCII triplets; None → lib unbuilt.

    Not on the production path anymore: render.image.ppm_body uses a
    vectorized numpy digit-scatter that matches or beats this encoder with
    no build step. Kept (with its byte-equality test) as an independent
    reference implementation of the C14 output format."""
    lib = load_native()
    if lib is None:
        return None
    px = np.ascontiguousarray(pixels, np.float32).reshape(-1)
    n = px.size // 3
    cap = n * 12 + 16
    buf = ctypes.create_string_buffer(cap)
    written = lib.pt_ppm_encode(
        px.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(n),
        ctypes.c_int(1 if reverse else 0),
        buf,
        ctypes.c_longlong(cap),
    )
    if written < 0:
        return None
    return buf.raw[: int(written)]


def native_hash_image(pixels: np.ndarray) -> int | None:
    lib = load_native()
    if lib is None:
        return None
    px = np.ascontiguousarray(pixels, np.float32).reshape(-1)
    return int(
        lib.pt_hash_image(
            px.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_longlong(px.size),
        )
    )


def native_morton3d(points01: np.ndarray) -> np.ndarray | None:
    """30-bit Morton codes for points normalized to [0,1)."""
    lib = load_native()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points01, np.float32)
    n = pts.shape[0]
    out = np.empty(n, np.uint32)
    lib.pt_morton3d(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out

"""Image content hashing.

Role parity with ``hash_vec_of_vectors`` (``mod.rs:916-926``): a cheap,
deterministic digest over the f32 bit patterns of all pixels, used as a
cache-invalidation key by viewers. We use FNV-1a 64-bit (stable across
platforms/processes, unlike Rust's DefaultHasher which is SipHash with a
process-random key — bitwise parity with the reference is impossible and not
needed; only self-consistency matters).
"""

from __future__ import annotations

import numpy as np

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
MASK64 = (1 << 64) - 1


def hash_image(pixels: np.ndarray) -> int:
    """Digest over the f32 bit patterns of all components.

    Native path: FNV-1a (C++, ~GB/s). Python fallback: blake2b — FNV is
    inherently byte-sequential and a Python loop costs seconds per megapixel
    frame (the hash is a cache key; only self-consistency matters, so the
    two paths need not agree with each other)."""
    from path_tracer.native import native_hash_image

    native = native_hash_image(np.asarray(pixels, np.float32))
    if native is not None:
        return native
    import hashlib

    data = np.ascontiguousarray(pixels, np.float32).tobytes()
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")


def hash_bytes(data: bytes) -> int:
    """Content digest over raw bytes (uint8 preview frames). blake2b: the
    frames are small (~100 KB) and only self-consistency matters."""
    import hashlib

    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")


def fnv1a(data: bytes) -> int:
    """Reference FNV-1a 64 (used by tests to validate the native encoder)."""
    h = FNV_OFFSET
    for b in data:
        h = ((h ^ b) * FNV_PRIME) & MASK64
    return h

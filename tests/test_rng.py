"""RNG determinism and fixture parity."""

import numpy as np
import jax

from path_tracer.ops import rng


def test_bounce_uniforms_deterministic():
    k = rng.root_key(42)
    a = np.asarray(rng.bounce_uniforms(k, 3, (64,), 4))
    b = np.asarray(rng.bounce_uniforms(k, 3, (64,), 4))
    np.testing.assert_array_equal(a, b)
    c = np.asarray(rng.bounce_uniforms(k, 4, (64,), 4))
    assert not np.array_equal(a, c)
    assert a.min() >= 0.0 and a.max() < 1.0


def test_chunk_streams_differ():
    k = rng.root_key(0)
    a = np.asarray(rng.bounce_uniforms(rng.chunk_key(k, 0), 0, (128,), 2))
    b = np.asarray(rng.bounce_uniforms(rng.chunk_key(k, 1), 0, (128,), 2))
    assert not np.array_equal(a, b)


def test_mock_fixture_cycles():
    u = np.asarray(rng.mock_uniforms(0, (3,), 4))
    flat = u.reshape(-1)
    np.testing.assert_array_equal(flat[:9], rng.MOCK_RANDOMS)
    np.testing.assert_array_equal(flat[9:12], rng.MOCK_RANDOMS[:3])
    # offset continues the global cursor like the reference's atomic index
    u2 = np.asarray(rng.mock_uniforms(2, (1,), 3)).reshape(-1)
    np.testing.assert_array_equal(u2, rng.MOCK_RANDOMS[2:5])


def test_mock_fixture_values_match_reference():
    # mod.rs:33-43, f32-rounded
    assert abs(float(rng.MOCK_RANDOMS[0]) - 0.75902418061906407) < 1e-7
    assert len(rng.MOCK_RANDOMS) == 9

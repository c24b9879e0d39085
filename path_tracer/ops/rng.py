"""Counter-based RNG for deterministic, parallel-safe sampling.

The reference draws from a thread-global ``rand::random::<f32>()``
(``mod.rs:48-55``) — bitwise replay is impossible by design (even two
reference runs differ). The replacement is counter-based threefry
(``jax.random``): every dispatch derives its stream from
``(seed, chunk_id, bounce)`` so renders are exactly reproducible for a fixed
seed and chunking, under any device count or scheduling.

``MOCK_RANDOM`` parity: the reference's deterministic fixture (a fixed
9-float cycle, ``mod.rs:31-45``) is reproduced as ``mock_uniforms`` — a pure
function of the draw counter — for golden tests of the sampling math.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# The reference's fixed mock sequence (mod.rs:33-43), rounded to f32.
MOCK_RANDOMS = np.array(
    [
        0.75902418061906407,
        0.023879213030728041,
        0.21016190197770457,
        0.78814922184253244,
        0.56819568237964491,
        0.7689823904006352,
        0.16910304067812287,
        0.54519597695203492,
        0.63614169009490062,
    ],
    dtype=np.float32,
)


def root_key(seed: int) -> jax.Array:
    return jax.random.PRNGKey(seed)


def chunk_key(key: jax.Array, chunk_id) -> jax.Array:
    return jax.random.fold_in(key, chunk_id)


def bounce_uniforms(key: jax.Array, bounce, shape, n: int) -> jax.Array:
    """n uniform f32 draws in [0,1) per lane for one bounce: [*shape, n]."""
    k = jax.random.fold_in(key, bounce)
    return jax.random.uniform(k, tuple(shape) + (n,), dtype=jnp.float32)


def raygen_uniforms(key: jax.Array, shape, n: int = 2) -> jax.Array:
    k = jax.random.fold_in(key, 0x5EED)
    return jax.random.uniform(k, tuple(shape) + (n,), dtype=jnp.float32)


def mock_uniforms_traced(bounce, shape, n: int) -> jnp.ndarray:
    """MOCK_RANDOM fixture for the wavefront: draw (lane, bounce, slot) maps
    to MOCK_RANDOMS[(lane*max_slots*max_bounce + bounce*n + slot) % 9] — a
    pure counter function (the reference's global atomic cursor cannot be
    reproduced under parallelism; this keeps the fixture's determinism and
    its 9-value cycle, documented deviation)."""
    total = int(np.prod(shape))
    table = jnp.asarray(MOCK_RANDOMS)
    lane = jnp.arange(total, dtype=jnp.int32).reshape(tuple(shape) + (1,))
    slot = jnp.arange(n, dtype=jnp.int32)
    idx = (lane * (n * 16) + bounce.astype(jnp.int32) * n + slot) % len(
        MOCK_RANDOMS
    )
    return table[idx]


def mock_uniforms(counter_start: int, shape, n: int) -> jnp.ndarray:
    """Deterministic fixture: draw i returns MOCK_RANDOMS[i % 9], counting
    row-major over [*shape, n] starting at counter_start."""
    total = int(np.prod(shape)) * n
    idx = (np.arange(total, dtype=np.int64) + counter_start) % len(MOCK_RANDOMS)
    return jnp.asarray(MOCK_RANDOMS[idx].reshape(tuple(shape) + (n,)))

"""Multi-host support.

The reference is strictly single-host (survey §2.11: rayon within one
process; "distributed communication backend: none"). This framework
scales to several hosts the JAX way:

- ``initialize()`` wraps ``jax.distributed.initialize`` (coordinator
  from explicit args, or the cluster's own environment where JAX finds one);
- the scene is tiny (KBs) — every host packs it independently from the same
  JSON (deterministic), so no broadcast is needed; a digest check catches
  divergent inputs across hosts;
- render-path collectives (sample psum, framebuffer assembly) run over the
  Mesh in parallel.mesh; the network between hosts carries only the final
  per-host framebuffer shards when the caller gathers the image
  (``assemble_image``).
"""

from __future__ import annotations

import hashlib

import jax
import numpy as np

from path_tracer.models.scene import SceneDescriptor, dumps_scene_json


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up jax.distributed (no-op if already initialized or single-host)."""
    if jax.process_count() > 1:
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError):
        # single-process environment (no cluster found): stay single-host
        pass


def scene_digest(scene: SceneDescriptor) -> str:
    """Content digest of a scene; hosts must agree before rendering."""
    return hashlib.sha256(dumps_scene_json(scene.to_json()).encode()).hexdigest()


def check_scene_consistency(scene: SceneDescriptor) -> bool:
    """All-gather the scene digest across processes and compare.

    Returns True when every host loaded an identical scene (the scene is
    host-loaded data, not broadcast — determinism makes broadcast redundant,
    this check makes it safe)."""
    if jax.process_count() == 1:
        return True
    from jax.experimental import multihost_utils

    digest = np.frombuffer(
        bytes.fromhex(scene_digest(scene)), dtype=np.uint8
    ).astype(np.int32)
    gathered = multihost_utils.process_allgather(digest)
    return bool((gathered == gathered[0]).all())


def assemble_image(accum) -> np.ndarray:
    """Gather a (possibly host-sharded) framebuffer to every host.

    With a fully-addressable array this is a device→host copy; with
    multi-host sharding it all-gathers the pixel shards once at the
    end of the render (the only cross-host data movement in the pipeline).
    """
    if jax.process_count() == 1:
        return np.asarray(accum)
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(accum, tiled=True)
    )

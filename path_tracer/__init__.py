"""path_tracer — a Monte-Carlo path-tracing framework in JAX, for NVIDIA GPUs.

A ground-up rebuild of the capabilities of ``filippo-orru/path-tracer-rust``
(a Rust/rayon port of the smallpt-family ``cgrpt`` tracer):

- on a GPU the whole bounce loop runs in one regenerative Pallas kernel
  (``ops/pallas/megakernel.py``): lanes own pixels, scene and camera are
  kernel inputs, random numbers come from a counter-based hash;
- the XLA integrator (``render/integrator.py``: a flat megabatch of rays
  stepped with ``lax.scan`` over bounce depth) is the reference (``exact``)
  and the CPU path (``fast``),
- scaling happens via ``jax.sharding`` meshes + ``shard_map``, not threads,
- RNG is counter-based (deterministic replay under any parallelism),
- host-side IO (OFF meshes, PPM images, hashing) runs through a C++ native
  runtime (``csrc/``) with pure-Python fallbacks.

Scene JSON files, OFF meshes, camera intrinsics, and tone mapping are
schema/semantics-compatible with the reference so renders match it in
expectation (RMSE parity at equal spp).
"""

from path_tracer.version import __version__

from path_tracer.models.material import Material, ReflectType
from path_tracer.models.camera import Camera
from path_tracer.models.geometry import Mesh, Triangle
from path_tracer.models.scene import (
    SceneDescriptor,
    SceneObject,
    ScenePacked,
    pack_scene,
)
from path_tracer.models.scenes import builtin_scenes, load_scene, load_scene_ids
from path_tracer.utils.config import RenderConfig, Resolution
# NOTE: this must stay an eager import — `render` (the function) shares its
# name with the `render` subpackage, and only an explicit module-level
# assignment shadows the submodule binding (a lazy __getattr__ never fires
# for an attribute that already exists). The daemon client (server.py) is
# imported by path where it must stay light.
from path_tracer.render.pipeline import render, RenderDone, RenderUpdate

__all__ = [
    "__version__",
    "Material",
    "ReflectType",
    "Camera",
    "Mesh",
    "Triangle",
    "SceneDescriptor",
    "SceneObject",
    "ScenePacked",
    "pack_scene",
    "builtin_scenes",
    "load_scene",
    "load_scene_ids",
    "RenderConfig",
    "Resolution",
    "render",
    "RenderDone",
    "RenderUpdate",
]

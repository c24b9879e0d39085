"""Child process for tests/test_distributed.py: one rank of a 2-process
jax.distributed CPU cluster rendering a sharded frame.

Run: python tests/_dist_child.py <pid> <nproc> <port> <outdir>

Must be a fresh process (its own jax runtime): pins the CPU platform the
same way tests/conftest.py does, with 2 local CPU devices per process.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def main():
    pid, nproc, port, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 2 * nproc  # global device view

    import numpy as np

    import path_tracer as pt
    from path_tracer.parallel.distributed import check_scene_consistency
    from path_tracer.parallel.mesh import render_sharded
    from path_tracer.utils.config import RenderConfig, Resolution

    scene = pt.load_scene("cornell", os.path.join(_ROOT, "scenes"))

    # 1. consistency gate: identical scenes pass ...
    assert check_scene_consistency(scene)
    # ... divergent scenes are caught (rank 1 perturbs a sphere radius)
    import dataclasses

    bad = scene
    if pid == 1:
        objs = list(scene.objects)
        objs[0] = dataclasses.replace(objs[0], radius=objs[0].radius + 0.5)
        bad = dataclasses.replace(scene, objects=objs)
    assert not check_scene_consistency(bad)

    # 2. sharded render over the global 4-device mesh (dp=2 x sp=2), odd spp
    # (5) exercises the exact-spp ragged pass across sp shards
    cfg = RenderConfig(
        samples_per_pixel=5, resolution=Resolution(16, 24),
        backend="fast", seed=3,
    )
    done = render_sharded(
        scene, cfg, sample_parallel=2, out_dir=None, verbose=False
    )
    np.save(os.path.join(outdir, f"img_{pid}.npy"), done.image.pixels)
    print(f"rank {pid} ok", flush=True)


if __name__ == "__main__":
    main()

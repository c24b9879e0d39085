"""Multi-device / multi-host scaling.

The reference's only parallelism is rayon work-stealing over shuffled pixels
within one host (``mod.rs:1020-1023``). The JAX equivalent is a
``jax.sharding.Mesh`` with two axes:

- ``dp``: pixels sharded across devices (no communication needed),
- ``sp``: samples sharded across devices (one ``psum`` to merge
  partial radiance sums).

plus ``jax.distributed`` initialization for several hosts (the network
between hosts carries only the final framebuffer gather; render-path
collectives stay on the cards' own links).
"""

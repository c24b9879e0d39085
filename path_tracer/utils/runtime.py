"""Process set-up shared by the entry points: the compile cache and the card.

The persistent compilation cache lives where ``JAX_COMPILATION_CACHE_DIR``
says, and otherwise in ``.jax_cache`` at the root of the checkout (derived
from this package's location, and listed in ``.gitignore``). No other cache
directory is set anywhere in the code.
"""

from __future__ import annotations

import os
import subprocess
import sys

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    for this process and the processes it starts; returns the directory.
    Safe to call before or after JAX is imported."""
    path = compile_cache_dir()
    os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_info() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def require_gpu() -> None:
    """Raise unless JAX's default backend is a GPU: measurements and card
    checks never fall back to the CPU."""
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"no GPU: JAX found only {jax.default_backend()!r} devices")

"""Test env: CPU backend with 8 virtual devices, set BEFORE jax imports.

Mirrors the survey's test strategy (§4): exact-geometry unit tests, a
statistical integrator test, parity tests against a literal recursive oracle,
and multi-device tests on a virtual CPU mesh so CI needs no accelerator. The
GPU kernel runs here in the Pallas interpreter, which a test asks for
explicitly (``megakernel.interpret_mode()``); checks that need the card are
marked ``gpu`` and skip here (``python chip_smoke.py`` runs them on the card).
"""

import os

os.environ["PT_NO_DAEMON"] = "1"

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# pin the platform through jax.config as well: a platform chosen at import
# time elsewhere would otherwise win over the environment variable
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def scenes_dir():
    return os.path.join(os.path.dirname(os.path.dirname(__file__)), "scenes")


@pytest.fixture(scope="session")
def repo_root():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def all_scenes(repo_root):
    import path_tracer as pt

    old = os.getcwd()
    os.chdir(repo_root)  # MeshFile paths are repo-relative
    try:
        ids = pt.load_scene_ids("scenes")
        out = {sid: pt.load_scene(sid, "scenes") for sid in ids}
    finally:
        os.chdir(old)
    return out


@pytest.fixture()
def rng_np():
    return np.random.default_rng(1234)


@pytest.fixture()
def gpu():
    """Skip unless a GPU is present (decided when the test runs, never at
    import or collection, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; `python chip_smoke.py` runs this on the card")

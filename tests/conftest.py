"""Test harness config: CPU with 8 virtual devices unless told otherwise.

Multi-device sharding is validated on a virtual CPU mesh.  Tests marked
``gpu`` need the card and skip elsewhere; run them there with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.  Must run
before jax is imported anywhere.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

import distributionraytracer  # noqa: E402,F401

# the package turns JAX's persistent compilation cache on at import; test
# runs keep the checkout clean and compile from scratch
jax.config.update("jax_enable_compilation_cache", False)

SCENE_SEED = 0


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips where there is none)")


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU; decided here, never at import time, so
    every xdist worker collects the same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a CUDA device (run with JAX_PLATFORMS=cuda,cpu)")
    return devs[0]


@pytest.fixture(scope="session")
def scenes_dir(tmp_path_factory):
    """The reference deployments, generated from SCENE_SEED and written as
    P3F files (with their skybox faces) under the reference file names."""
    from distributionraytracer.scene.generate import SCENES, write_p3f
    d = str(tmp_path_factory.mktemp("P3D_Scenes"))
    for name in SCENES:
        write_p3f(name, SCENE_SEED, d)
    return d

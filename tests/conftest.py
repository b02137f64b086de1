"""Test configuration: make an 8-virtual-CPU-device mesh available.

Must run before the first ``import jax`` anywhere (SURVEY.md §4: the
multi-device tests use the single-process fake-mesh pattern via
``--xla_force_host_platform_device_count``).  The multi-device tests build
their mesh from ``jax.devices("cpu")`` explicitly.  Tests that need an
NVIDIA GPU carry the ``gpu`` marker and skip without one (tests/test_gpu.py);
on the CPU run everything with ``JAX_PLATFORMS=cpu``.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cpu_devices():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("need 8 virtual CPU devices (XLA_FLAGS forcing failed)")
    return devs

REFERENCE_DIR = "/root/reference"


@pytest.fixture(scope="session")
def reference_data_dir():
    path = os.path.join(REFERENCE_DIR, "data")
    if not os.path.isdir(path):
        pytest.skip("reference assets not available")
    return path


@pytest.fixture(scope="session")
def reference_renders_dir():
    path = os.path.join(REFERENCE_DIR, "renders")
    if not os.path.isdir(path):
        pytest.skip("reference golden renders not available")
    return path


@pytest.fixture(scope="session")
def cornell_scene():
    from chiaroscuro_tpu.scene.builtin import cornell_box
    from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays

    return build_scene_arrays(cornell_box())


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running render tests")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one")

"""Test configuration: hermetic CPU runs with 8 virtual devices.

The unit tests run on the host CPU backend (JAX_PLATFORMS=cpu, set here
unless the caller chose a platform) with 8 virtual devices so the parallel/
sharding paths are exercised. The program itself is checked on the GPU by
`python chip_smoke.py` (README, "Tests & bench").
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def cpu_mesh(shape, axis_names):
    """An n-device CPU mesh for sharding tests."""
    devs = np.asarray(jax.devices("cpu")[: int(np.prod(shape))]).reshape(shape)
    return jax.sharding.Mesh(devs, axis_names)


@pytest.fixture
def rng():
    return np.random.default_rng(0)

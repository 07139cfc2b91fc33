"""Test configuration.

Tests run on host CPU with an 8-device virtual mesh so sharding paths are
exercised without accelerator hardware (SURVEY.md par. 4: multi-host tests via
xla_force_host_platform_device_count).

x64 is enabled so float64 reference checks (numeric-diff Jacobians,
dense-vs-Schur solves) are meaningful; engine code uses explicit float32
dtypes throughout, so this only widens test-side reference computations.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# NOTE: do not enable the persistent compilation cache here — the
# cache-write path intermittently segfaults the XLA CPU compiler in this
# jaxlib build (observed under tests/test_long_run.py).

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long end-to-end tests; deselect with -m 'not slow' for the "
        "fast tier (full suite stays the CI gate)",
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)

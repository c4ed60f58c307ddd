"""Test harness: force an 8-device virtual CPU mesh BEFORE jax is used.

SURVEY.md section 5 "Multi-chip without a cluster": sharding logic is
exercised with simulated devices; identical shard_map code then runs on
the GPUs of one host.  The suite runs on the CPU (run it with
JAX_PLATFORMS=cpu; the platform is pinned here as well): the plain
paths run natively and the GPU kernels through the Pallas interpreter
(``interpret=True``).  Tests marked ``gpu`` need the card and skip
here; ``python chip_smoke.py`` runs them on it.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)

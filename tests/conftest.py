"""Test configuration: force an 8-virtual-device CPU backend BEFORE jax import
so multi-device sharding paths are exercised without accelerator hardware
(SURVEY.md §5 item 4).  Must run before anything imports jax."""
import os

# The env var alone is not enough when a site bootstrap re-sets
# jax_platforms programmatically — override through jax.config after
# import, before any backend is touched.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", "tests must run on the CPU backend"
assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)

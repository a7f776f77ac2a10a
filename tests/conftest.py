"""Test configuration: CPU (unless JAX_PLATFORMS says otherwise) with 8
virtual devices, and float64.

Accuracy-parity tests vs the Julia reference require f64; multi-device tests
use the host-platform device-count flag. Must run before jax initializes a
backend.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest

jax.config.update("jax_enable_x64", True)
# Persistent compile cache: DISABLED for the test suite. Full-suite runs
# died with SIGSEGV inside `backend.deserialize_executable` when a long
# pytest process loaded a persisted XLA:CPU executable ~150 tests in; the
# same entries deserialize fine from fresh short-lived processes (every
# crash-site file passes in isolation). The jax 0.9.0 XLA:CPU AOT
# deserialization path is not safe in long-lived processes, so the suite
# pays cold compiles (deterministic, crash-free).
jax.config.update("jax_enable_compilation_cache", False)


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run @pytest.mark.slow tests (flagship-scale live integrations)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: flagship-scale live re-integration (minutes of CPU); "
        "excluded from the default tier, run with --runslow",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow tier: pass --runslow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


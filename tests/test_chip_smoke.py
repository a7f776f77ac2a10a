"""chip_smoke.py's guards that can be checked without a card."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_require_gpu_refuses_cpu_devices():
    """The smoke test never continues on the CPU: a CPU-only device list
    stops it with a non-zero exit before any phase runs."""
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(jax.devices("cpu"))
    assert exc.value.code != 0
    assert "no GPU" in str(exc.value.code)

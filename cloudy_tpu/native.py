"""ctypes binding + on-demand build of the native golden model.

`native/cloudy_golden.cc` is an independent C++ implementation of the
analytical coalescence step (closure inversion + Simpson/incomplete-gamma
autoconversion + Q/R/S) used as a cross-validation oracle and as the
single-CPU-core baseline for bench.py. Built with g++ at first use into
`native/libcloudy_golden.so` (git-ignored) and rebuilt when the source is
newer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from cloudy_tpu.spec import Family
from cloudy_tpu.coalescence import CoalescenceData

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "native", "cloudy_golden.cc")
_LIB = os.path.join(_REPO, "native", "libcloudy_golden.so")

_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> str:
    """Compile the shared library if missing or stale."""
    if (
        not force
        and os.path.exists(_LIB)
        and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
    ):
        return _LIB
    # build beside the target and rename: concurrent test workers may
    # build at once, and a half-written library must never be loaded
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)
    return _LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.coal_ints_golden.restype = ctypes.c_int
        lib.coal_ints_golden.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
    return _lib


def coal_ints_golden(data: CoalescenceData, mom: np.ndarray) -> np.ndarray:
    """Golden-model coalescence tendencies for ``mom [B, n_tot]``
    (normalized units). Gamma/exponential modes, FixedThreshold only."""
    spec = data.spec
    if data.moving:
        raise ValueError("golden model supports FixedThreshold only")
    fam_codes = []
    for f in spec.families:
        if f == Family.EXPONENTIAL:
            fam_codes.append(0)
        elif f == Family.GAMMA:
            fam_codes.append(1)
        else:
            raise ValueError(f"golden model does not support {f}")

    mom = np.ascontiguousarray(np.atleast_2d(np.asarray(mom, np.float64)))
    B = mom.shape[0]
    out = np.empty_like(mom)
    families = np.asarray(fam_codes, np.int32)
    nprog = np.asarray(spec.nprogmoms, np.int32)
    kernels = np.ascontiguousarray(data.kernels, np.float64)
    thresholds = np.ascontiguousarray(data.thresholds, np.float64)

    lib = _load()
    rc = lib.coal_ints_golden(
        mom.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(B),
        ctypes.c_int(spec.n_modes),
        families.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        nprog.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        kernels.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int(data.P),
        thresholds.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise RuntimeError(f"coal_ints_golden failed: {rc}")
    return out

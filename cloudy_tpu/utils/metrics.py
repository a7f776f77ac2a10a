"""Observability: step timing, conservation monitors, profiling hooks.

The reference's only performance tooling is CI-enforced BenchmarkTools
budgets (SURVEY.md §5/§6); here observability is first-class: wall-clock step
timers with device sync, physics invariant monitors (mass conservation,
positivity) and `jax.profiler` trace capture.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import jax
import jax.numpy as jnp


@dataclass
class StepTimer:
    """Accumulates per-step wall times (device-synchronized)."""

    times: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def time_step(self, result_holder=None):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def timed_call(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        self.times.append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, float]:
        t = np.asarray(self.times[1:] or self.times)  # drop compile step
        return {
            "n": len(self.times),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "min_s": float(t.min()),
        }


def conservation_report(spec, mom_flat) -> Dict[str, float]:
    """Mass/number totals + positivity violations for a state
    ``[..., n_tot]`` — the psum-able invariants of the SCE (gain−loss
    structure conserves total M1 exactly; M0 must fall, M2 rise)."""
    mom = jnp.asarray(mom_flat)
    m0 = sum(mom[..., spec.dist_moment_ind(i, 0)] for i in range(spec.n_modes))
    m1 = sum(mom[..., spec.dist_moment_ind(i, 1)] for i in range(spec.n_modes))
    return {
        "total_number": float(jnp.sum(m0)),
        "total_mass": float(jnp.sum(m1)),
        "negative_fraction": float(jnp.mean((mom < 0).astype(jnp.float32))),
        "nonfinite_fraction": float(
            jnp.mean((~jnp.isfinite(mom)).astype(jnp.float32))
        ),
    }


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a jax.profiler trace (TensorBoard-compatible)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class JsonlLogger:
    """Append-only JSONL metrics log (one dict per line)."""

    def __init__(self, path: str):
        self.path = path

    def log(self, record: Dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

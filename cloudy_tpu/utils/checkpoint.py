"""Checkpoint/resume for long scan runs.

The reference has no checkpointing (output-only NetCDF writers, SURVEY.md §5)
— this is new capability for pod-scale jobs: npz checkpoints (exact
round-trip, no serializer dependency) plus a checkpointed segment-scan
driver that survives restarts at segment granularity.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import jax


def save_checkpoint(path: str, state, step: int) -> None:
    """Persist (state pytree, step) as ``{path}_step{step}.npz``."""
    flat, _ = jax.tree_util.tree_flatten(state)
    np.savez(
        f"{path}_step{step}.npz",
        step=np.int64(step),
        n_leaves=len(flat),
        **{f"leaf{i}": np.asarray(l) for i, l in enumerate(flat)},
    )


def load_checkpoint(path: str, step: int, like=None):
    """Restore a checkpoint written by `save_checkpoint`. `like` provides the
    pytree structure."""
    data = np.load(f"{path}_step{step}.npz")
    flat = [data[f"leaf{i}"] for i in range(int(data["n_leaves"]))]
    treedef = jax.tree_util.tree_structure(like)
    return jax.tree_util.tree_unflatten(treedef, flat), int(data["step"])


def latest_step(path: str) -> Optional[int]:
    """Newest checkpoint step saved under `path_step*`."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path) + "_step"
    steps = []
    for name in os.listdir(d):
        if name.startswith(base):
            tail = name[len(base):].removesuffix(".npz")
            if tail.isdigit():
                steps.append(int(tail))
    return max(steps) if steps else None


def run_segments(
    step_fn: Callable,
    state,
    n_steps: int,
    segment: int,
    ckpt_path: Optional[str] = None,
    resume: bool = True,
):
    """Run ``n_steps`` applications of `step_fn` (jitted, scanned in segments
    of `segment` steps), checkpointing after each segment and resuming from
    the newest checkpoint when `resume`."""
    start = 0
    if ckpt_path and resume:
        s = latest_step(ckpt_path)
        if s is not None:
            state, start = load_checkpoint(ckpt_path, s, like=state)
            state = jax.device_put(state)

    @jax.jit
    def seg(y):
        def body(c, _):
            return step_fn(c), None

        y, _ = jax.lax.scan(body, y, None, length=segment)
        return y

    done = start
    while done < n_steps:
        state = seg(state)
        done += segment
        if ckpt_path:
            jax.block_until_ready(state)
            save_checkpoint(ckpt_path, state, done)
    return state, done

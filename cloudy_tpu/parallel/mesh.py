"""Device mesh construction and multi-host initialization.

Scaling design (SURVEY.md §5/§7): columns are embarrassingly parallel (the
only inter-column coupling in the physics is zero), so the primary mesh axis
shards the column ensemble; an optional second axis shards the vertical (z)
dimension with a one-cell halo for the sedimentation flux
(cloudy_tpu/parallel/halo.py). The mesh is a plain device list: the cards of
one host are joined all to all, so its shape follows the algorithm alone.
Cross-device traffic is limited to diagnostics reductions (psum of
conservation sums).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh

logger = logging.getLogger(__name__)

#: environment variables whose presence means "this run is part of a cluster"
#: (jax cluster autodetection inputs: explicit coordinator, SLURM/OpenMPI
#: launchers).
_CLUSTER_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "SLURM_JOB_NUM_NODES",
    "OMPI_MCA_orte_hnp_uri",
)


def cluster_env_detected() -> bool:
    """True when the environment indicates a multi-process launch."""
    return any(os.environ.get(v) for v in _CLUSTER_ENV_VARS)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Multi-host bring-up: `jax.distributed.initialize` with arguments
    resolved from the environment when omitted (SLURM / OpenMPI
    autodetection). Returns True when a multi-process cluster was
    initialized (exercised by tests/test_distributed.py with a 2-process CPU
    cluster and a local TCP coordinator).

    Failure policy: a misconfigured pod must not silently degrade into N
    independent single-process runs. If the caller passed explicit cluster
    arguments, or cluster environment variables are present, initialization
    errors RAISE. Only a genuinely single-process run (no cluster signals at
    all, nothing to autodetect) returns False.
    """
    explicit = coordinator_address is not None or num_processes is not None
    in_cluster = explicit or cluster_env_detected()
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except Exception as e:  # noqa: BLE001 — classified below
        already = "already initialized" in str(e).lower()
        if already:
            logger.info("jax.distributed already initialized: %s", e)
            return jax.process_count() > 1
        if in_cluster:
            raise RuntimeError(
                "cluster launch detected (explicit args or cluster env vars) "
                "but jax.distributed.initialize failed — refusing to continue "
                "as N independent single-process runs"
            ) from e
        logger.info("no cluster detected; running single-process (%s)", e)
        return False
    n = jax.process_count()
    logger.info(
        "jax.distributed initialized: process %d/%d", jax.process_index(), n
    )
    if in_cluster and n < 2 and (num_processes or 2) > 1:
        raise RuntimeError(
            f"cluster launch detected but only {n} process(es) joined"
        )
    return n > 1


def make_mesh(
    axis_names: Sequence[str] = ("columns",),
    axis_sizes: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a Mesh over all (or the given) devices.

    With `axis_sizes=None`, all devices go on the first axis and remaining
    axes get size 1. Example: ``make_mesh(("columns", "z"), (4, 2))`` on
    8 devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"mesh {tuple(axis_sizes)} != {n} devices")
    dev_array = np.asarray(devices).reshape(tuple(axis_sizes))
    return Mesh(dev_array, tuple(axis_names))

"""Multi-process entry path.

The sharded engine (parallel.distributed) is mesh-agnostic: once
`jax.distributed.initialize()` has run, `jax.devices()` spans every process
and `make_mesh`/`gemm_sharded` work unchanged — XLA inserts the collectives
from the same psum/psum_scatter the single-process path uses. This module
is the initialization entry a multi-process user runs.

Launch procedure (one command per process):

    GEMMUL8_COORD=<host0-addr:port> GEMMUL8_NPROC=<N> GEMMUL8_PROC_ID=<i> \
        python your_script.py          # which calls initialize_from_env()

Nothing discovers a cluster by itself: without the three variables
`initialize_from_env()` is a no-op and the run is single-process.
`scripts/weak_scaling.py` calls it first, so the same script measures one
process or N.

A 2-process 1-host CPU smoke of this exact path (gloo collectives over
the sharded engine) runs in CI: tests/test_multihost.py.
"""

from __future__ import annotations

import os

import jax

_ENV_COORD = "GEMMUL8_COORD"
_ENV_NPROC = "GEMMUL8_NPROC"
_ENV_PROCID = "GEMMUL8_PROC_ID"
_ENV_LOCAL_IDS = "GEMMUL8_LOCAL_DEVICE_IDS"

_initialized = False


def initialize_from_env(force_cpu: bool = False) -> bool:
    """Initialize jax.distributed from the GEMMUL8_* env. Returns True if a
    multi-process runtime was (or already had been) initialized, False
    when running single-process.

    force_cpu: pin the CPU backend before backend init. Used by the CI
    smoke and CPU-only multi-process runs."""
    global _initialized
    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    if _initialized:
        return True
    coord = os.environ.get(_ENV_COORD)
    nproc = os.environ.get(_ENV_NPROC)
    pid = os.environ.get(_ENV_PROCID)
    kwargs = {}
    if coord is not None:
        kwargs["coordinator_address"] = coord
    if nproc is not None:
        kwargs["num_processes"] = int(nproc)
    if pid is not None:
        kwargs["process_id"] = int(pid)
    ids = os.environ.get(_ENV_LOCAL_IDS)
    if ids:
        kwargs["local_device_ids"] = [int(v) for v in ids.split(",")]
    if not kwargs:
        return False  # single-process run: nothing to initialize
    jax.distributed.initialize(**kwargs)
    _initialized = True
    return True


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def process_summary() -> str:
    return (f"process {jax.process_index()}/{jax.process_count()}: "
            f"{jax.local_device_count()} local of "
            f"{jax.device_count()} global devices")

"""Multi-process groups and their meshes.

The reference has no distributed story at all (SURVEY.md section 2.9: one
GPU, an unused DistributedDataParallel import at
reference ``utils.py:22``). This is the collective backend it lacks:

- ``initialize_multihost`` wraps ``jax.distributed.initialize`` — the
  NCCL/MPI-equivalent process-group bootstrap. Pass the coordinator
  address, process count and process id explicitly (tests/test_multihost.py
  runs 2 processes x 4 virtual CPU devices each and checks numerics
  against a dense reference).
- ``make_multihost_graph_mesh`` builds the 1-D ``('graph',)`` mesh for
  DistGraph row-sharding with each process's devices CONTIGUOUS along the
  axis, so the ring SpMM's ppermute neighbors share a process for all but
  one hop per process boundary.

All collectives themselves (ppermute/psum/all_gather in distgraph.py and
distributed.py) are ordinary JAX collectives: once the process group and
mesh exist, XLA lowers them with no further code.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join the multi-host process group. No-op if already initialized or
    if running single-process with no coordinator configured.

    Pass coordinator_address ("host:port"), num_processes and process_id
    explicitly; with none of them JAX's own cluster detection runs."""
    # NOTE: must not touch jax.process_count()/jax.devices() here — any
    # backend-initialising call before jax.distributed.initialize is an
    # error. The only initialization probe is the distributed global state.
    try:
        from jax._src import distributed as _dist

        if _dist.global_state.client is not None:
            return  # already initialized
    except ImportError:  # pragma: no cover - private-API drift fallback
        pass
    if coordinator_address is None and num_processes is None:
        # No explicit args: delegate to JAX's cluster auto-detection
        # (SLURM, ...). On a plain single-process machine detection fails
        # -> stay local.
        try:
            jax.distributed.initialize()
        except Exception:
            pass
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)


def make_multihost_graph_mesh(axis: str = "graph") -> Mesh:
    """1-D mesh over ALL devices of the process group, ordered process-major
    (process 0's devices first, then process 1's, ...), so contiguous
    dst-row shards — and therefore ring ppermute neighbors — share a
    process wherever possible."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs), (axis,))

"""Multi-host initialization and pod-slice meshes.

The reference is single-process (SURVEY.md §2.10). For multi-host runs the
standard JAX recipe applies: every host calls ``init_multihost()``
(jax.distributed), then builds one global mesh over ``jax.devices()`` — the
sharded operators in ``parallel.sharding`` work unchanged, with XLA routing
collectives over the hosts' interconnect.

This module is exercised two ways: single-process on the simulated
8-device mesh (test suite, driver ``dryrun_multichip``), and in REAL
multi-process form by ``tests/test_multihost.py`` — 2 OS processes
rendezvous through ``init_multihost`` over a localhost gRPC
coordinator, build one global ``pod_mesh`` of 2x4 CPU devices, and
parity-check cross-process psums, fused CGLS and the int8 bucketed
format against single-process oracles. Runs on several GPU hosts use
the same entry points.
"""
from __future__ import annotations

import jax
import numpy as np



def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None):
    """Initialize jax.distributed (no-op when single-process)."""
    if num_processes in (None, 1):
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def pod_mesh(time_shards=1, rows_shards=None):
    """Global mesh over all devices of the (possibly multi-host) runtime.

    Lay the 'rows' axis along the fastest (intra-host, NVLink) dimension
    and 'time' across hosts: the dynamic-CT time axis only exchanges
    nearest-neighbor halos (spacetime TV), which tolerates the inter-host
    network's latency, while SpMV partial-sum psums stay within a host.
    """
    devices = jax.devices()
    n = len(devices)
    if rows_shards is None:
        rows_shards = n // time_shards
    if time_shards * rows_shards != n:
        raise ValueError(
            f"{time_shards} x {rows_shards} != {n} available devices"
        )
    # order devices host-major so 'time' lands across hosts
    devs = sorted(devices, key=lambda d: (d.process_index, d.id))
    arr = np.array(devs).reshape(time_shards, rows_shards)
    from jax.sharding import Mesh

    return Mesh(arr, ("time", "rows"))

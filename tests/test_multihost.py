"""REAL multi-process multi-host execution test (SURVEY.md §2.10).

Launches 2 OS processes that rendezvous through
``trips_tpu.parallel.init_multihost`` (jax.distributed, localhost gRPC
coordinator), each exposing 4 CPU devices, and form one 8-device global
mesh via ``pod_mesh``. The worker (``tests/multihost_worker.py``)
parity-asserts forward / psum'd normal / fused-CGLS / int8-bucketed
applies against single-process oracles — so the
process-spanning data path (global arrays from per-host replicas,
cross-process shard_map psums over gloo, fused while_loop solvers on a
multi-host mesh) is exercised for real, not simulated inside one
process. The processes stay on the CPU backend (gloo collectives); on
several GPU hosts the identical program rides NCCL, and only the
collective transport differs.

The reference (``/root/reference/trips``) is single-process NumPy and
has no analog — this covers the distribution subsystem that is new in
this design.
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "multihost_worker.py")
_NPROC = 2


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_global_mesh_parity():
    # hang guard is the communicate(timeout=540) below (pytest-timeout
    # is not available in this image)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(port), str(i), str(_NPROC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(_NPROC)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if "MULTIHOST_SKIP" in out:
            pytest.skip(f"worker {i}: {out.splitlines()[-1]}")
        assert p.returncode == 0, f"worker {i} rc={p.returncode}\n{out}"
        assert f"MULTIHOST_OK p{i} procs={_NPROC}" in out, \
            f"worker {i} missing OK sentinel\n{out}"
        # every parity leg must have reported
        for leg in ("fwd", "normal(psum)", "fused cgls",
                    "bucketed int8 cgls_normal",
                    "dynamic time-x-angles normal", "dynamic cgls_normal"):
            assert f"p{i} {leg}: rel=" in out, f"worker {i} missing {leg}"

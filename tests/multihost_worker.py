"""Worker for the REAL multi-process multi-host test (test_multihost.py).

Each OS process runs this script with its own ``process_id``; the
processes rendezvous through ``trips_tpu.parallel.init_multihost``
(jax.distributed over a localhost gRPC coordinator), expose 4 local CPU
devices each, and form ONE global mesh via ``pod_mesh`` — the same
recipe several GPU hosts use (SURVEY.md §2.10; the reference,
``/root/reference/trips``, is single-process NumPy and has no analog).
Cross-process collectives ride jax's gloo CPU backend here; on GPU
hosts the same program rides NCCL.

Every leg parity-asserts the multi-process result against a
single-process oracle (scipy matrix or the unsharded operator running
process-locally), so this validates the *process-spanning* data path —
global array creation from per-host replicas, shard_map psums across
process boundaries, fused while_loop solvers over a multi-host mesh —
not just that the program runs.

Run as: ``python multihost_worker.py <coordinator_port> <process_id>
<num_processes>`` (all processes on one machine; the test launches 2).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT, PROC_ID, NPROC = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

# The workers stay on the CPU backend; set it before the backend
# initializes. Replace XLA_FLAGS wholesale: the parent test session exports its own
# 8-device-count flag which must not leak into the workers.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
try:
    # Cross-process CPU collectives need an explicit implementation.
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
except Exception as e:  # pragma: no cover - jax built without gloo
    print(f"MULTIHOST_SKIP gloo unavailable: {e}", flush=True)
    sys.exit(0)

from trips_tpu.parallel import init_multihost  # noqa: E402

init_multihost(coordinator_address=f"localhost:{PORT}",
               num_processes=NPROC, process_id=PROC_ID)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

assert jax.process_count() == NPROC, jax.process_count()
n_local = jax.local_device_count()
n_global = len(jax.devices())
assert n_global == NPROC * n_local, (n_global, NPROC, n_local)

from trips_tpu.krylov import cgls, cgls_normal  # noqa: E402
from trips_tpu.parallel import (  # noqa: E402
    ShardedBandedProjector,
    ShardedBucketedBandedProjector,
    pod_mesh,
)
from trips_tpu.problems.phantoms import shepp_logan  # noqa: E402
from trips_tpu.problems.projector import fan_beam_matrix  # noqa: E402
from trips_tpu.sparse import BandedProjector  # noqa: E402
from trips_tpu.sparse.banded_buckets import BucketedBandedProjector  # noqa: E402


def _gather(a):
    """Global array -> full numpy array on every process."""
    from jax.experimental import multihost_utils

    if getattr(a, "is_fully_replicated", False):
        return np.asarray(a)
    return np.asarray(multihost_utils.process_allgather(
        a, tiled=True))


def _assert_close(got, ref, tol, what):
    got = np.asarray(got, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    rel = float(np.linalg.norm(got - ref)) / max(
        float(np.linalg.norm(ref)), 1e-12)
    assert np.isfinite(rel) and rel < tol, (what, rel, tol)
    print(f"p{PROC_ID} {what}: rel={rel:.2e}", flush=True)


# One global mesh over all processes' devices, 'rows' spanning the
# process boundary — every psum below is a real cross-process collective.
mesh = pod_mesh(time_shards=1)
assert mesh.devices.size == n_global
procs_in_mesh = {d.process_index for d in mesh.devices.ravel()}
assert len(procs_in_mesh) == NPROC, procs_in_mesh

# Identical deterministic problem built on every host (standard multi-host
# input recipe: replicated host data, device_put against the global mesh).
nx, views = 32, 2 * n_global
A = fan_beam_matrix(nx, views=views).astype(np.float32)
xt = shepp_logan(nx).reshape(-1).astype(np.float32)

# ---- leg 1: flat banded pack, forward/normal parity vs scipy ----------
bop = BandedProjector.from_scipy_fan(A, nx, views, n_groups=8)
sop = ShardedBandedProjector.from_banded(bop, mesh, axis="rows")
b = sop.matvec(jnp.asarray(xt))
_assert_close(_gather(b), A @ xt.astype(np.float64), 1e-4, "fwd")
_assert_close(_gather(sop.normal_matvec(jnp.asarray(xt))),
              A.T @ (A @ xt.astype(np.float64)), 1e-3, "normal(psum)")

# ---- leg 2: fused CGLS while_loop across the process boundary ---------
x_mp, _ = cgls(sop, b, jnp.zeros(sop.shape[1], jnp.float32), 5, 0.0)
x_ref, _ = cgls(bop, jnp.asarray(A @ xt),
                jnp.zeros(bop.shape[1], jnp.float32), 5, 0.0)
_assert_close(_gather(x_mp), x_ref, 1e-3, "fused cgls")

# ---- leg 3: the champion storage format (Ta-bucketed, int8 scales) ----
buck = BucketedBandedProjector.from_scipy_fan(
    A, nx, views, n_groups=8, n_buckets=3, dtype="int8")
sbuck = ShardedBucketedBandedProjector.from_bucketed(
    buck, mesh, axis="rows")
xn_mp, _ = cgls_normal(sbuck, b, jnp.zeros(sbuck.shape[1], jnp.float32),
                       5, 0.0)
xn_ref, _ = cgls_normal(buck, jnp.asarray(A @ xt),
                        jnp.zeros(buck.shape[1], jnp.float32), 5, 0.0)
_assert_close(_gather(xn_mp), xn_ref, 1e-3, "bucketed int8 cgls_normal")

# ---- leg 4: dynamic CT with the TIME axis across the process boundary -
# pod_mesh's design claim (multihost.py): time shards land host-major so
# each host owns whole frames and only the tiny per-frame-slab angle
# psums cross chips; here time shard 0 = process 0's devices, shard 1 =
# process 1's, so frame slabs really live on different OS processes.
from jax.sharding import Mesh  # noqa: E402

from trips_tpu.parallel import (  # noqa: E402
    ShardedBucketedDynamicBandedOperator,
)
from trips_tpu.problems.dynamic import (  # noqa: E402
    generate_synthetic_dynamic as gsd,
)
from trips_tpu.sparse.dynamic_banded import (  # noqa: E402
    BucketedDynamicBandedOperator,
)

devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
dmesh = Mesh(np.array(devs).reshape(NPROC, n_global // NPROC),
             ("time", "angles"))
assert len({d.process_index for d in dmesh.devices[0]}) == 1  # host-major
_, bd, AAd, _, nxd, _, ntd, _, _, al = gsd(
    nx=16, nt=NPROC, views=2 * (n_global // NPROC), noise_level=0.01,
    return_angles=True)
dop = BucketedDynamicBandedOperator.from_frames(
    AAd, nxd, al, n_groups=8, n_buckets=2)
sdop = ShardedBucketedDynamicBandedOperator.from_dynamic(dop, dmesh)
from scipy import sparse as sp  # noqa: E402

Adfull = sp.block_diag(AAd, format="csr")
xdp = np.random.default_rng(1).standard_normal(
    sdop.shape[1]).astype(np.float32)
_assert_close(_gather(sdop.normal_matvec(jnp.asarray(xdp))),
              Adfull.T @ (Adfull @ xdp.astype(np.float64)), 1e-3,
              "dynamic time-x-angles normal")
xd_mp, _ = cgls_normal(sdop, jnp.asarray(bd, jnp.float32),
                       jnp.zeros(sdop.shape[1], jnp.float32), 3, 0.0)
xd_ref, _ = cgls_normal(dop, jnp.asarray(bd, jnp.float32),
                        jnp.zeros(dop.shape[1], jnp.float32), 3, 0.0)
_assert_close(_gather(xd_mp), xd_ref, 1e-3, "dynamic cgls_normal")

print(f"MULTIHOST_OK p{PROC_ID} procs={NPROC} local={n_local} "
      f"global={n_global}", flush=True)
jax.distributed.shutdown()

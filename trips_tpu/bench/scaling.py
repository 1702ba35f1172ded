"""nnz/s scaling harness (1 device -> N devices).

Runs the fused CGLS loop over the sharded operators on 1, 2, ..., N
devices of whatever backend is available and reports the efficiency curve
for the distributed formats:

- ``banded``: the angle-sharded banded projector
  (``parallel/sharded_banded.py``);
- ``bsr``: the row-sharded BSR block stream (``parallel/sharded_bsr.py``);
- ``dynamic``: the (time x angles)-sharded dynamic banded operator.

On the CPU backend (simulated devices) the numbers are functional smoke
only — collectives over host-platform devices share one set of cores, so
"efficiency" there validates plumbing, not scaling.

Run ``python -m trips_tpu.bench.scaling [out.json]`` to write the artifact
(sharding parity and the compiled-HLO collective schedule).
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def _measure(op, b, iters):
    import jax
    import jax.numpy as jnp

    from ..krylov import cgls

    bp = jnp.pad(jnp.asarray(b), (0, op.shape[0] - b.shape[0]))
    x0 = jnp.zeros(op.shape[1], jnp.float32)
    x, k = cgls(op, bp, x0, 2, 0.0)
    jax.block_until_ready(x)
    t0 = time.perf_counter()
    x, k = cgls(op, bp, x0, iters, 0.0)
    jax.block_until_ready(x)
    return int(k) * 2 / (time.perf_counter() - t0)  # applies of A per sec


def run(nx=256, views=60, iters=50, device_counts=None, formats=("banded",
                                                                 "bsr",
                                                                 "dynamic")):
    import jax
    import jax.numpy as jnp

    from ..parallel import (ShardedBandedProjector, ShardedBsrOperator,
                            make_mesh)
    from ..problems.projector import fan_beam_matrix
    from ..sparse import BandedProjector

    devices = jax.devices()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]

    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    b = (A @ np.random.default_rng(0).random(A.shape[1])).astype(np.float32)

    out = {}
    for fmt in formats:
        results = []
        bop = dop = None
        if fmt == "dynamic":
            from ..parallel.sharded_dynamic_banded import (
                ShardedDynamicBandedOperator)
            from ..problems.dynamic import generate_synthetic_dynamic
            from .. import sparse as _sp

            nt = max(2, device_counts[-1] // 2)
            _, bd, AAd, _, nxd, _, _, _, _, al = generate_synthetic_dynamic(
                nx=min(nx, 64), nt=nt, views=max(views // 4, 8),
                noise_level=0.01, return_angles=True)
            dop = _sp.DynamicBandedOperator.from_frames(
                AAd, nxd, al, n_groups=16)
            b_dyn = bd.astype(np.float32)
        if fmt == "banded":
            bop = BandedProjector.from_scipy_fan(A, nx, views, n_groups=16)
        for nd in device_counts:
            if fmt == "dynamic":
                t_sh = 2 if (nd % 2 == 0 and dop.nt % 2 == 0) else 1
                if dop.nt % max(t_sh, 1):
                    continue
                mesh = make_mesh({"time": t_sh, "angles": nd // t_sh},
                                 devices=devices[:nd])
                sop = ShardedDynamicBandedOperator.from_dynamic(dop, mesh)
                rate = _measure(sop, b_dyn, iters) * dop.nnz
                results.append((nd, rate))
                continue
            if fmt == "banded":
                mesh = make_mesh({"angles": nd}, devices=devices[:nd])
                sop = ShardedBandedProjector.from_banded(
                    bop, mesh, axis="angles")
            else:
                mesh = make_mesh({"rows": nd}, devices=devices[:nd])
                sop = ShardedBsrOperator.from_scipy(
                    A, mesh, block_shape=(32, 128))
            rate = _measure(sop, b, iters) * A.nnz
            results.append((nd, rate))
        base = results[0][1]
        out[fmt] = [
            {"devices": nd, "nnz_per_s": rate,
             "efficiency": rate / (base * nd)}
            for nd, rate in results
        ]
    return out


def functional_validation(device_counts=(1, 2, 4, 8), nx=32, views=16):
    """Parity of the sharded bucketed applies vs scipy at every device
    count — correctness across mesh shapes, with NO wall-clock numbers
    (r4 postmortem: this environment runs 8 simulated devices on 2 host
    cores, so any wall-clock 'efficiency' here measures oversubscription,
    not the collective schedule)."""
    import jax
    import jax.numpy as jnp

    from ..parallel import ShardedBucketedBandedProjector, make_mesh
    from ..problems.projector import fan_beam_matrix
    from ..sparse.banded_buckets import BucketedBandedProjector

    devices = jax.devices()
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    op = BucketedBandedProjector.from_scipy_fan(A, nx, views, n_groups=8,
                                                n_buckets=3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    y = rng.standard_normal(A.shape[0]).astype(np.float32)
    refs = (A @ x, A.T @ y, A.T @ (A @ x))
    out = []
    for nd in device_counts:
        if nd > len(devices):
            continue
        mesh = make_mesh({"angles": nd}, devices=devices[:nd])
        sop = ShardedBucketedBandedProjector.from_bucketed(
            op, mesh, axis="angles")
        got = (sop.matvec(jnp.asarray(x)), sop.rmatvec(jnp.asarray(y)),
               sop.normal_matvec(jnp.asarray(x)))
        rels = [float(np.linalg.norm(np.asarray(g, np.float64) - r)
                      / np.linalg.norm(r))
                for g, r in zip(got, refs)]
        out.append({"devices": nd,
                    "rel_err": {"matvec": rels[0], "rmatvec": rels[1],
                                "normal_matvec": rels[2]},
                    "ok": bool(max(rels) < 1e-3)})
    return out


def measured_collectives(n_devices=8, static_cfg=(256, 60),
                         dynamic_cfg=(560, 45, 2)):
    """Collective schedule of the real-scale sharded programs, extracted
    from the compiled HLO. Static: the flagship bench config on the
    bucketed pack. Dynamic: STEMPO-real-scale parallel-beam frames on the
    bucketed (time x angles) stack."""
    import jax

    from ..parallel import (ShardedBucketedBandedProjector,
                            ShardedBucketedDynamicBandedOperator, make_mesh)
    from ..problems.projector import fan_beam_matrix, parallel_beam_matrix
    from ..sparse.banded_buckets import BucketedBandedProjector
    from ..sparse.dynamic_banded import BucketedDynamicBandedOperator
    from .hlo_audit import audit_operator

    devices = jax.devices()[:n_devices]
    out = {}

    nx, views = static_cfg
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    op = BucketedBandedProjector.from_scipy_fan(A, nx, views, n_groups=32,
                                                n_buckets=4)
    mesh = make_mesh({"angles": n_devices}, devices=devices)
    sop = ShardedBucketedBandedProjector.from_bucketed(op, mesh,
                                                       axis="angles")
    out[f"static_tomo{nx}x{views}_bucketed_x{n_devices}"] = {
        "nnz": int(A.nnz), "n_pad": int(op.n_pad),
        "audit": audit_operator(sop),
    }

    nxd, viewsd, nt = dynamic_cfg
    t_sh = 2 if n_devices % 2 == 0 else 1
    a_sh = n_devices // t_sh
    angles_list = [np.deg2rad(np.linspace(5 * t, 180 + 5 * t, viewsd,
                                          endpoint=False))
                   for t in range(nt)]
    AA = [parallel_beam_matrix(nxd, a, det_count=nxd,
                               model="linear").astype(np.float32) / nxd
          for a in angles_list]
    dop = BucketedDynamicBandedOperator.from_frames(
        AA, nxd, angles_list, n_groups=32, n_buckets=3)
    dmesh = make_mesh({"time": t_sh, "angles": a_sh}, devices=devices)
    sdop = ShardedBucketedDynamicBandedOperator.from_dynamic(dop, dmesh)
    out[f"dynamic_stempo{nxd}_nt{nt}_bucketed_{t_sh}x{a_sh}"] = {
        "nnz": int(dop.nnz), "n_pad": int(dop.n_pad), "nt": int(nt),
        "audit": audit_operator(sdop),
    }
    return out


def main(out_path="SCALING.json", n_devices=None):
    import jax

    devices = jax.devices()
    if n_devices is None:
        n_devices = min(8, len(devices))
    artifact = {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "functional_parity": functional_validation(
            device_counts=(1, 2, 4, min(8, n_devices))),
        "measured_collectives": measured_collectives(n_devices=n_devices),
    }
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact))
    return artifact


if __name__ == "__main__":
    main(*(sys.argv[1:2] or ["SCALING.json"]))

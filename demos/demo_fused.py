"""Fully-fused device path demo: the whole solve — Krylov recurrences,
regularization-parameter selection (gcv / dp / l_curve), projected solves,
basis growth — is ONE jitted device program per solver, with zero host
round-trips per iteration: the host dispatches one program and fetches
the result.

Beyond the reference's surface (the reference hosts every iteration's
k x k work on the CPU); numerics match the host-parity solvers to
roundoff (tests/test_fused.py).

Run: python demos/demo_fused.py [--config deblur1d|tomo] [--iters 15]
(on the default JAX backend: the GPU where there is one)
"""
import argparse
import time

import _bootstrap  # noqa: F401
import jax.numpy as jnp
import numpy as np


def relerr(x, xt):
    x = np.asarray(x).reshape(-1)
    return np.linalg.norm(x - xt) / np.linalg.norm(xt)


def build_deblur1d(n):
    from trips_tpu.operators import FirstDerivative1D
    from trips_tpu.problems import Deblurring1D

    np.random.seed(0)
    prob = Deblurring1D()
    A = prob.forward_Op_1D(parameter=10.0, nx=n)
    x_true = prob.gen_xtrue(n, "curve0")
    b, delta = prob.add_noise(prob.gen_data(x_true), "Gaussian", 0.02)
    return A, FirstDerivative1D(n), np.asarray(b).ravel(), x_true, float(delta)


def build_tomo(nx, views):
    from trips_tpu.operators import FirstDerivative2D
    from trips_tpu.problems.phantoms import tectonic
    from trips_tpu.problems.projector import fan_beam_matrix
    from trips_tpu.sparse import BucketedBandedProjector

    np.random.seed(0)
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    x_true = tectonic(nx).reshape(-1).astype(np.float32)
    b_true = A @ x_true
    e = np.random.randn(b_true.size)
    sig = 0.01 * np.linalg.norm(b_true) / np.linalg.norm(e)
    b = (b_true + sig * e).astype(np.float32)
    # the Ta-bucketed banded pack of the Siddon matrix, bf16 storage
    # (quantized class)
    op = BucketedBandedProjector.from_scipy_fan(A, nx, views, n_groups=32,
                                                n_buckets=3,
                                                dtype=jnp.bfloat16)
    return op, FirstDerivative2D(nx, nx), b, x_true, float(
        np.linalg.norm(sig * e))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("deblur1d", "tomo"),
                    default="deblur1d")
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--views", type=int, default=30)
    ap.add_argument("--iters", type=int, default=15)
    args = ap.parse_args()

    from trips_tpu.solvers.fused import (
        fused_gks,
        fused_hybrid_lsqr,
        fused_mmgks,
    )

    if args.config == "deblur1d":
        A, L, b, x_true, delta = build_deblur1d(args.n)
    else:
        A, L, b, x_true, delta = build_tomo(args.nx, args.views)
    bj = jnp.asarray(b)

    for mode in ("gcv", "dp", "l_curve"):
        t0 = time.perf_counter()
        x, lams, _ = fused_gks(A, bj, L, projection_dim=3,
                               n_iter=args.iters, regparam_mode=mode,
                               delta=delta)
        x.block_until_ready()
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, lams, _ = fused_gks(A, bj, L, projection_dim=3,
                               n_iter=args.iters, regparam_mode=mode,
                               delta=delta)
        x.block_until_ready()
        t_run = time.perf_counter() - t0
        print(f"fused_gks[{mode:8s}]  rel_err={relerr(x, x_true):.4f}  "
              f"lam={float(lams[-1]):.3e}  compile={t_compile:.1f}s  "
              f"run={t_run * 1e3:.0f}ms ({args.iters} iters, one program)")

    x, lams, _ = fused_mmgks(A, bj, L, pnorm=2.0, qnorm=1.0,
                             projection_dim=3, n_iter=args.iters,
                             regparam_mode="gcv")
    print(f"fused_mmgks[gcv]    rel_err={relerr(x, x_true):.4f}  "
          f"lam={float(lams[-1]):.3e}")

    # modified-GCV stabilizes the deep hybrid factorization (DP at a fixed
    # large n_iter keeps the semiconvergent last iterate, faithfully to the
    # reference; pair dp with dp_stop via solvers.Hybrid_LSQR for that use)
    x, lams = fused_hybrid_lsqr(A, bj, n_iter=max(args.iters, 20),
                                regparam_mode="gcv")
    print(f"fused_hyb_lsqr[gcv] rel_err={relerr(x, x_true):.4f}  "
          f"lam={float(lams[-1]):.3e}")

    # CG on the normal equations: one normal_matvec per iteration (the
    # bucketed pack applies forward and adjoint bucket by bucket)
    from trips_tpu.krylov import cgls, cgls_normal

    x0 = jnp.zeros(A.shape[1], jnp.float32)
    for name, fn in (("cgls", cgls), ("cgls_normal", cgls_normal)):
        xx, _ = fn(A, bj, x0, max(args.iters, 20), 0.0)
        xx.block_until_ready()  # compile
        t0 = time.perf_counter()
        xx, _ = fn(A, bj, x0, max(args.iters, 20), 0.0)
        xx.block_until_ready()
        print(f"{name:19s} rel_err={relerr(xx, x_true):.4f}  "
              f"run={1e3 * (time.perf_counter() - t0):.0f}ms")


if __name__ == "__main__":
    main()

"""Small-scale CGLS demo — mirrors the reference's
``demos/demo_small_scale_CGLS.ipynb``: a 50x50 deblurring problem where the
regularized system is solved by *stacking* A and sqrt(lam)*L into one
least-squares problem and running plain CGLS on it,

    min_x || [A; sqrt(lam) L] x - [b; 0] ||_2,

with x0 = A^T b, lam = 0.01, 50 iterations, tol 1e-3 (notebook cells 3-8).

This form keeps both blocks matrix-free: ``VStackOperator``
concatenates the forward blur and the scaled 2D first-derivative operator,
and the whole CGLS recurrence runs as one fused device loop.

Run: python demos/demo_small_scale_cgls.py [--n 50] [--iters 50]
"""
import argparse

import _bootstrap  # noqa: F401
import numpy as np

from trips_tpu.core.linop import ScaledOperator, VStackOperator
from trips_tpu.solvers._common import as_op
from trips_tpu.operators import FirstDerivative2D
from trips_tpu.problems import Deblurring2D
from trips_tpu.solvers import CGLS


def relerr(x, xt):
    x = np.asarray(x).reshape(-1)
    xt = np.asarray(xt).reshape(-1)
    return np.linalg.norm(x - xt) / np.linalg.norm(xt)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--regparam", type=float, default=0.01)
    args = ap.parse_args()

    np.random.seed(0)
    n = args.n
    prob = Deblurring2D()
    A = prob.forward_Op([3, 3], (1, 1), n, n)
    # the notebook uses 'satellite'; its .mat is gated data (no egress) —
    # the synthetic 'h_im' keeps the demo self-contained
    x_true = prob.gen_true("h_im", nx=n, ny=n)
    b_true = prob.gen_data(np.asarray(x_true).reshape(-1, 1))
    b, delta = prob.add_noise(b_true, "Gaussian", 0.01)
    bv = np.asarray(b).reshape(-1)

    L = FirstDerivative2D(n, n)
    Ahat = VStackOperator([as_op(A), ScaledOperator(np.sqrt(args.regparam),
                                                    as_op(L))])
    bhat = np.concatenate([bv, np.zeros(L.shape[0])])
    x0 = np.asarray(as_op(A).rmatvec(bv))

    x, info = CGLS(Ahat, bhat, x0, max_iter=args.iters, tol=1e-3,
                   x_true=np.asarray(x_true).reshape(-1))
    print(f"CGLS on stacked [A; sqrt({args.regparam}) L] "
          f"({n}x{n} h_im, 1% noise):")
    print(f"  iterations: {info['its']}")
    if info.get("relError"):
        print(f"  final relative error: {info['relError'][-1]:.4f}")
    print(f"  relative error vs x_true: {relerr(x, x_true):.4f}")


if __name__ == "__main__":
    main()

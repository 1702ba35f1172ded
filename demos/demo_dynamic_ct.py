"""Dynamic CT demo — mirrors the reference's Emoji/CrossPhantom/STEMPO
notebooks (2_demo_dynamic_CrossPhantom.ipynb and the stripped emoji/stempo
demos; paper Codes 5-7): static per-frame MMGKS vs dynamic MMGKS with
anisotropic spacetime TV, isotropic TV, and group sparsity.

With no network egress the Zenodo datasets are unavailable; this demo runs
on the synthetic moving-disc problem with the same block structure. Pass
--dataset emoji/crossphantom/stempo to use downloaded data when present.

Run: python demos/demo_dynamic_ct.py [--nx 32 --nt 8]
"""
import argparse

import _bootstrap  # noqa: F401
import numpy as np

from trips_tpu.operators import CenteredSpaceTimeDerivative, SpaceTimeDerivative
from trips_tpu.problems import (
    generate_crossPhantom,
    generate_emoji,
    generate_stempo,
    generate_synthetic_dynamic,
)
from trips_tpu.solvers import MMGKS, Hybrid_LSQR
from trips_tpu.sparse import EllOperator


def relerr(x, xt):
    x = np.asarray(x).reshape(-1)
    xt = np.asarray(xt).reshape(-1)
    return np.linalg.norm(x - xt) / np.linalg.norm(xt)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "emoji", "crossphantom", "stempo"])
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--nt", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    np.random.seed(0)
    x_true = None
    angles_list = None
    if args.dataset == "synthetic":
        (A, b, AA, B, nx, ny, nt, delta, x_true,
         angles_list) = generate_synthetic_dynamic(
            nx=args.nx, nt=args.nt, views=12, noise_level=0.01,
            return_angles=True
        )
    elif args.dataset == "emoji":
        A, b, AA, B, nx, ny, nt = generate_emoji(dataset=30)
        delta = None
    elif args.dataset == "crossphantom":
        A, b, AA, B, nx, ny, nt = generate_crossPhantom(dataset=15)
        delta = None
    else:
        A, b, AA, B, nx, ny, nt, delta, x_true = generate_stempo(
            data_set="simulation", new_shape=(args.nx, args.nx), nt=args.nt
        )

    # frame-varying banded pack with vmapped applies for the full block
    # system (ELL when per-frame angle sets are unknown, e.g. downloaded
    # datasets)
    if angles_list is not None:
        from trips_tpu.sparse import DynamicBandedOperator

        op = DynamicBandedOperator.from_frames(AA, nx, angles_list,
                                               n_groups=8)
    else:
        op = EllOperator.from_scipy(A)
    results = {}

    # static: per-frame MMGKS (the reference loops frames serially;
    # CrossPhantom demo cell 20)
    from trips_tpu.operators import FirstDerivative2D

    xs = []
    L2 = FirstDerivative2D(nx, ny)
    for t in range(nt):
        op_t = EllOperator.from_scipy(AA[t])
        x_t, _ = MMGKS(op_t, np.asarray(B[t]).reshape(-1), L2, pnorm=2, qnorm=1,
                       projection_dim=3, n_iter=max(4, args.iters // 4),
                       regparam="gcv")
        xs.append(np.asarray(x_t).reshape(-1))
    x_static = np.concatenate(xs)
    if x_true is not None:
        results["static per-frame MMGKS"] = relerr(x_static, x_true)

    # dynamic: anisotropic spacetime TV
    L = SpaceTimeDerivative(nx, ny, nt)
    x, _ = MMGKS(op, b, L, pnorm=2, qnorm=1, projection_dim=4,
                 n_iter=args.iters, regparam="gcv")
    if x_true is not None:
        results["dynamic MMGKS (anisoTV)"] = relerr(x, x_true)

    # dynamic: isotropic TV
    Ltv = CenteredSpaceTimeDerivative(nx, ny, nt)
    x, _ = MMGKS(op, b, Ltv, pnorm=2, qnorm=1, projection_dim=4,
                 n_iter=args.iters, regparam="gcv", isoTV="isoTV",
                 prob_dims=(nx, ny, nt))
    if x_true is not None:
        results["dynamic MMGKS (isoTV)"] = relerr(x, x_true)

    # dynamic: group sparsity
    x, _ = MMGKS(op, b, None, pnorm=2, qnorm=1, projection_dim=4,
                 n_iter=args.iters, regparam="gcv", GS="GS",
                 prob_dims=(nx, ny, nt))
    if x_true is not None:
        results["dynamic MMGKS (GS)"] = relerr(x, x_true)

    # Hybrid LSQR on the full block system
    x, _ = Hybrid_LSQR(op, b, n_iter=args.iters, regparam="gcv")
    if x_true is not None:
        results["Hybrid LSQR (full system)"] = relerr(x, x_true)

    for name, err in results.items():
        print(f"{name:30s} relative error = {err:.4f}")


if __name__ == "__main__":
    main()

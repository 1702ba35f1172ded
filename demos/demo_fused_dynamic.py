"""Fused dynamic reconstruction demo — the reference's flagship dynamic
MMGKS (isoTV / GS weights, paper Codes 5-7) as ONE device program over the
banded dynamic operator, plus checkpoint/resume of the fused loop.

What it shows (r4 features):
- ``fused_mmgks(weight_mode='isoTV'|'GS', prob_dims=...)`` with a
  frame-varying ``DynamicBandedOperator`` A — no host round-trips inside
  the iteration (solvers/fused.py; host twin: solvers/mmgks.py, reference
  trips/solvers/MMGKS.py:61-91);
- ``fused_mmgks_checkpointed``: the same loop in chunks with the state
  pytree persisted every chunk, and a resume that reproduces the
  uninterrupted iterates bit-for-bit (solvers/checkpointed.py).

Run: python demos/demo_fused_dynamic.py [--nx 32 --nt 6 --views 12]
(on the default JAX backend: the GPU where there is one.)
"""
import argparse
import os
import tempfile

import _bootstrap  # noqa: F401
import numpy as np

import jax.numpy as jnp

from trips_tpu.operators import CenteredSpaceTimeDerivative
from trips_tpu.problems import generate_synthetic_dynamic
from trips_tpu.solvers.checkpointed import fused_mmgks_checkpointed
from trips_tpu.solvers.fused import fused_mmgks
from trips_tpu.sparse import DynamicBandedOperator
from trips_tpu.utils.checkpoint import save_state


def relerr(x, xt):
    x = np.asarray(x).reshape(-1)
    return float(np.linalg.norm(x - xt) / np.linalg.norm(xt))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--nt", type=int, default=6)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--n_iter", type=int, default=10)
    args = ap.parse_args()

    A, b, AA, B, nx, ny, nt, delta, x_true, al = generate_synthetic_dynamic(
        nx=args.nx, nt=args.nt, views=args.views, noise_level=0.01,
        return_angles=True)
    op = DynamicBandedOperator.from_frames(AA, nx, al, n_groups=8)
    bj = jnp.asarray(b.astype(np.float32))
    Ltv = CenteredSpaceTimeDerivative(nx, ny, nt)
    dims = (nx, ny, nt)

    for mode in ("isoTV", "GS"):
        x, lams, _ = fused_mmgks(op, bj, Ltv if mode == "isoTV" else None,
                                 pnorm=2.0, qnorm=1.0, projection_dim=3,
                                 n_iter=args.n_iter, regparam_mode="gcv",
                                 weight_mode=mode, prob_dims=dims)
        print(f"fused dynamic MMGKS ({mode}):  rel_err "
              f"{relerr(x, x_true):.4f}  lam_last {float(lams[-1]):.3e}")

    # checkpoint/resume: kill after the second chunk, resume from disk
    path = os.path.join(tempfile.mkdtemp(), "dyn_ckpt.npz")
    kw = dict(pnorm=2.0, qnorm=1.0, projection_dim=3, n_iter=args.n_iter,
              regparam_mode="gcv", weight_mode="isoTV", prob_dims=dims,
              chunk=3)
    x_ref, _, _ = fused_mmgks_checkpointed(op, bj, Ltv, **kw)

    class Killed(Exception):
        pass

    def cb(it, **state):
        save_state(path, state)
        if it >= 6:
            raise Killed

    try:
        fused_mmgks_checkpointed(op, bj, Ltv, callback=cb, **kw)
    except Killed:
        print(f"killed at iteration 6; checkpoint at {path}")
    x_res, _, _ = fused_mmgks_checkpointed(op, bj, Ltv, resume_state=path,
                                           **kw)
    same = np.array_equal(np.asarray(x_res), np.asarray(x_ref))
    print(f"resumed run == uninterrupted run bit-for-bit: {same}  "
          f"(rel_err {relerr(x_res, x_true):.4f})")
    assert same


if __name__ == "__main__":
    main()

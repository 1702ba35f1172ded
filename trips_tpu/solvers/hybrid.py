"""Hybrid Krylov solvers: per-iteration regularization of the projected
problem.

Reference semantics:
- Hybrid LSQR: ``trips/solvers/Hybrid_LSQR.py:25-114`` — incremental GK; at
  step k the projected bidiagonal (k+1, k) system is regularized with lam
  from modified-GCV (fullsize=m) / DP / L-curve / scalar; x = V y.
  Iteration 0 sets lam = 0 and produces no iterate (:77-78).
- Hybrid GMRES: ``trips/solvers/Hybrid_GMRES.py:23-87`` — same scheme on the
  Arnoldi factorization of a square A; solves at every iteration (lam = 0 on
  the first).

Device-first restructuring: the full factorization to ``n_iter`` runs as one
fused device loop (``krylov.golub_kahan`` / ``krylov.arnoldi``) — identical
in exact arithmetic to the reference's per-step updates — and the
per-iteration projected solves sweep k = 1..n_iter on host over the leading
(k+1, k) blocks. The big matvecs stay on device; only O(k^2) scalars move.

Reference quirk mirrored: with ``regparam='dp'`` and ``dp_stop=True`` the
reference breaks unconditionally at the first regularized iteration
(Hybrid_LSQR.py:85-93); we reproduce that behavior.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import scipy.linalg as sla

from ..krylov import arnoldi, golub_kahan
from ..regparam.dp import dp_tikhonov_projected
from ..regparam.gcv import gcv_tikhonov_projected
from ..regparam.lcurve import l_curve
from ._common import as_op, build_info, host, stacked_lstsq, vec


def _require_delta(regparam, dp_stop, delta):
    if (regparam == "dp" or dp_stop) and delta is None:
        raise Exception(
            "A value for the noise level delta was not provided and the "
            "discrepancy principle cannot be applied. Please supply delta, "
            "or choose the regularization parameter according to gcv."
        )


def _select_lambda_projected(regparam, Bk, bhat_k, *, m, basis, b, delta, eta,
                             out_norm2):
    """lam for one hybrid iteration on the (k+1, k) projected system."""
    k = Bk.shape[1]
    if regparam == "gcv":
        U, s, _ = sla.svd(Bk, full_matrices=False)
        return gcv_tikhonov_projected(
            np.diag(s), np.eye(k), U.T @ bhat_k,
            out_norm2=float(np.linalg.norm(bhat_k - U @ (U.T @ bhat_k)) ** 2),
            t_term=float(m), variant="modified",
        )
    if regparam == "dp":
        return dp_tikhonov_projected(
            Bk, np.eye(k), bhat_k, out_norm2, delta=delta, eta=eta
        )
    if regparam == "l_curve":
        U, s, _ = sla.svd(Bk, full_matrices=False)
        return l_curve(np.diag(s), np.eye(k), (U.T @ bhat_k).reshape(-1, 1))
    return float(regparam)


def _dp_projections(U, b):
    """All DP projected data for every active width in TWO device ops per
    factorization (the per-iteration ``Uk.T @ b`` +
    residual-norm pulls were the host hybrids' only O(m)-per-iteration
    device sync in DP mode): ``Ub = U^T b`` once, and the out-of-subspace
    residual norms for every width k via one masked (m, K+1) matmul —
    column k of C holds bproj_k = Ub[:k+1] zero-padded, so
    ``outn[k] = ||b - U[:, :k+1] @ bproj_k||^2`` exactly as the
    per-iteration form (columns past the computed prefix are zero and
    contribute nothing). Returns host arrays (Ub, outn).
    """
    b = jnp.reshape(b, (-1,))
    Ub = U.T @ b
    K1 = U.shape[1]
    mask = jnp.arange(K1)[:, None] <= jnp.arange(K1)[None, :]
    C = Ub[:, None] * mask
    R = b[:, None] - U @ C
    outn = jnp.sum(R * R, axis=0)
    return host(Ub), host(outn)


def Hybrid_LSQR(A, b, n_iter=100, regparam="gcv", x_true=None, **kwargs):
    """Returns (x, info)."""
    A = as_op(A)
    b = vec(b)
    delta = kwargs.get("delta", None)
    eta = kwargs.get("eta", 1.01)
    dp_stop = kwargs.get("dp_stop", False)
    _require_delta(regparam, dp_stop, delta)

    m = A.shape[0]
    reorth = kwargs.get("reorth", False)
    # matvec economy (reference Hybrid_LSQR.py:85-93 factorizes
    # incrementally and stops at the DP iteration): with dp_stop the
    # factorization is extended in device chunks of gk_chunk steps, so a
    # stop at iteration k costs 2*ceil(k/chunk)*chunk matvecs, not
    # 2*n_iter. Without dp_stop every k is swept anyway, so the single
    # fused factorization is optimal.
    economize = regparam == "dp" and dp_stop
    chunk = int(kwargs.get("gk_chunk", 8))
    if economize:
        from ..krylov import gk_init, golub_kahan_extend

        U, V, alphas, betas = gk_init(A, b, n_iter)
        k_done = 0
        Bh = None
    else:
        U, B, V = golub_kahan(A, b, n_iter, reorth=reorth)
        Bh = host(B)
        k_done = n_iter
    matvec_count = 2 * k_done
    dp_cache = None
    beta = float(jnp.linalg.norm(b))
    # projected data: exact [beta, 0, ..., 0] by the GK relation
    x = None
    lam = 0.0
    x_history, lambda_history, residual_history = [], [], []
    its = 0

    for ii in range(n_iter):
        its = ii
        if ii == 0:
            lam = 0.0
            continue
        k = ii + 1
        while k > k_done:
            nsteps = min(max(chunk, k - k_done), n_iter - k_done)
            U, V, alphas, betas = golub_kahan_extend(
                A, U, V, alphas, betas, k_done, nsteps, reorth=reorth)
            k_done += nsteps
            matvec_count += 2 * nsteps
            Bh = None
            dp_cache = None
        if Bh is None:
            a_h, b_h = host(alphas), host(betas)
            Bh = np.zeros((n_iter + 1, n_iter))
            ar = np.arange(n_iter)
            Bh[ar, ar] = a_h
            Bh[ar + 1, ar] = b_h
        Bk = Bh[: k + 1, :k]
        bhat_k = np.zeros(k + 1)
        bhat_k[0] = beta
        out_norm2 = 0.0
        if regparam == "dp":
            if dp_cache is None:
                dp_cache = _dp_projections(U, b)
            Ub_h, outn_h = dp_cache
            bhat_k = Ub_h[: k + 1]
            out_norm2 = float(outn_h[k])
        lam = _select_lambda_projected(
            regparam, Bk, bhat_k, m=m, basis=U, b=b, delta=delta, eta=eta,
            out_norm2=out_norm2,
        )
        lambda_history.append(lam)
        y = stacked_lstsq(Bk, lam, np.eye(k), bhat_k)
        x = V[:, :k] @ jnp.asarray(y)
        x_history.append(x)
        cb = kwargs.get("callback", None)
        if cb is not None:
            cb(ii, lam=lam)
        if regparam == "dp" and dp_stop:
            # reference quirk: unconditional early stop on the first
            # regularized DP iteration (Hybrid_LSQR.py:85-93)
            break

    info = build_info(x_history, lambda_history, residual_history, its,
                      x_true=x_true, residual_key="relResidual")
    # large A/A^T applies actually dispatched (fused loops execute the
    # traced matvec once per factorization step; Python-side counters
    # cannot observe that, so the solver accounts for it)
    info["matvec_count"] = matvec_count
    return x[:, None], info


def Hybrid_GMRES(A, b, n_iter=100, regparam="gcv", x_true=None, **kwargs):
    """Returns (x, info)."""
    A = as_op(A)
    if A.shape[0] != A.shape[1]:
        raise Exception(
            "Please check the size of the matrx A: it should be square in "
            "order to apply hybrid GMRES"
        )
    b = vec(b)
    delta = kwargs.get("delta", None)
    eta = kwargs.get("eta", 1.01)
    dp_stop = kwargs.get("dp_stop", False)
    _require_delta(regparam, dp_stop, delta)

    m = A.shape[0]
    reorth = kwargs.get("reorth", False)
    # same matvec economy as Hybrid LSQR: with dp_stop the Arnoldi
    # factorization extends in chunks and stops with the solver (reference
    # Hybrid_GMRES.py:58-66 factorizes incrementally and breaks)
    economize = regparam == "dp" and dp_stop
    chunk = int(kwargs.get("gk_chunk", 8))
    if economize:
        from ..krylov import arnoldi_extend, arnoldi_init

        Q, H = arnoldi_init(A, b, n_iter)
        k_done = 0
        Hh = None
    else:
        Q, H = arnoldi(A, b, n_iter, reorth=reorth)
        Hh = host(H)
        k_done = n_iter
    matvec_count = k_done
    dp_cache = None
    beta = float(jnp.linalg.norm(b))
    x = None
    x_history, lambda_history, residual_history = [], [], []
    its = 0

    for ii in range(n_iter):
        its = ii
        k = ii + 1
        while k > k_done:
            nsteps = min(max(chunk, k - k_done), n_iter - k_done)
            Q, H = arnoldi_extend(A, Q, H, k_done, nsteps, reorth=reorth)
            k_done += nsteps
            matvec_count += nsteps
            Hh = None
            dp_cache = None
        if Hh is None:
            Hh = host(H)
        Hk = Hh[: k + 1, :k]
        bhat_k = np.zeros(k + 1)
        bhat_k[0] = beta
        if ii == 0:
            lam = 0.0
        elif regparam == "gcv":
            Us, s, _ = sla.svd(Hk, full_matrices=False)
            lam = gcv_tikhonov_projected(
                np.diag(s), np.eye(k), Us.T @ bhat_k,
                out_norm2=float(np.linalg.norm(bhat_k - Us @ (Us.T @ bhat_k)) ** 2),
            )
        elif regparam == "dp":
            if dp_cache is None:
                dp_cache = _dp_projections(Q, b)
            Qb_h, outn_h = dp_cache
            lam = dp_tikhonov_projected(
                Hk, np.eye(k), Qb_h[: k + 1], float(outn_h[k]),
                delta=delta, eta=eta
            )
        elif regparam == "l_curve":
            Us, s, _ = sla.svd(Hk, full_matrices=False)
            lam = l_curve(np.diag(s), np.eye(k), (Us.T @ bhat_k).reshape(-1, 1))
        else:
            lam = float(regparam)
        lambda_history.append(lam)
        y = stacked_lstsq(Hk, lam, np.eye(k), bhat_k)
        x = Q[:, :k] @ jnp.asarray(y)
        x_history.append(x)
        residual_history.append(float(np.linalg.norm(bhat_k - Hk @ y)))
        if ii > 0 and regparam == "dp" and dp_stop:
            break

    info = build_info(x_history, lambda_history, residual_history, its,
                      x_true=x_true, residual_key="relResidual")
    info["matvec_count"] = matvec_count
    return x[:, None], info

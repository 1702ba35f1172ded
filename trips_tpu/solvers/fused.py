"""Fully-fused GKS / MMGKS: the entire solver is one jitted device program.

The host-driven variants (gks.py/mmgks.py) mirror the reference's numerics
with per-iteration host work on k x k systems. These versions instead
preallocate the basis at its final width K = projection_dim + n_iter and
run the whole iteration in a ``lax.fori_loop`` with *masked* linear algebra:

- columns >= k (the current active width) of V/AV/LV/Q/R are exactly zero;
- padded projected solves pin the inactive block by adding 1 to the
  inactive diagonal of G = R_A^T R_A + lam R_L^T R_L (nonsingular with a
  zero solution there);
- the GCV trace term uses the traced active count, so lam matches the
  equivalent growing-size computation;
- panel factorizations use Householder QR on the padded panel; Q's
  arbitrary inactive columns are neutralized by masking every projection
  (CholeskyQR would preserve zero columns but squares the panel condition
  number, which these ill-posed panels cannot afford).

No host synchronization, no recompilation as the basis grows — one XLA
program per (shape, n_iter) pair. Parameter selection: all four modes
('gcv' | 'dp' | 'l_curve' | 'scalar') run on device in filtered-SVD
coordinates (cancellation-free in f32 — see _filtered_pencil).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..krylov import golub_kahan
from ..operators.weights import (gs_weights, iso_tv_weights,
                                 smoothed_holder_weights)
from ..regparam.device import _dp_newton_filtered, fminbound


def _masked_qr(P, active_mask):
    """Householder QR of a padded panel whose inactive (trailing) columns
    are zero. R's inactive columns come out exactly zero; Q's inactive
    columns are arbitrary orthonormal completions, so every consumer of Q
    must mask projections by ``active_mask`` (CholeskyQR would keep them
    zero but squares the panel's condition number, which these ill-posed
    panels cannot afford)."""
    Q, R = jnp.linalg.qr(P, mode="reduced")
    return Q, R * active_mask[None, :]


def _pin(active_mask):
    return jnp.diag(jnp.where(active_mask, 0.0, 1.0))


def _masked_tikhonov_solve(R_A, R_L, bproj, lam, active_mask):
    G = R_A.T @ R_A + lam * (R_L.T @ R_L) + _pin(active_mask)
    y = jnp.linalg.solve(G, R_A.T @ bproj)
    return y * active_mask


def _filtered_pencil(R_A, R_L, bproj, active):
    """Standard-form reduction of the masked pencil: sv^2 and data
    coefficients of Anew = R_A (R_L + pin)^{-1}.

    All downstream scalar rules (GCV / DP / L-curve) become elementwise
    sums over (sv2, bhat) — evaluated inside Brent/Newton loops with no
    k x k solves. This is both cheaper (O(k) per lam evaluation instead of
    O(k^3)) and float32-robust: the normal-equations solve squares the
    pencil's condition number, and in pure f32 that was enough to
    move the GCV minimizer by orders of magnitude vs the f64 host rule.

    Works for square masked pencils (GKS/MMGKS) and rectangular (k+1, k)
    hybrid factors alike. ``rest2`` is the part of ||bproj||^2 outside the
    range of Anew (exactly the out-of-subspace residual the hybrid
    modified-GCV adds, reference gcv.py:46-47).
    """
    pin = _pin(active)
    Anew = jnp.linalg.solve((R_L + pin).T, R_A.T).T * active[None, :]
    U, S, _ = jnp.linalg.svd(Anew, full_matrices=False)
    bproj = jnp.reshape(bproj, (-1,))
    bhat = U.T @ bproj
    # explicit residual, not ||b||^2 - ||bhat||^2: the difference form is
    # a cancellation of near-equal numbers and pure noise in f32
    rest2 = jnp.sum((bproj - U @ bhat) ** 2)
    return S**2, bhat, rest2


def _gcv_lambda_masked(R_A, R_L, bproj, t_term, active_mask, out_norm2=0.0,
                       projected_only=False):
    """Masked GCV in filtered SVD coordinates; t_term = active count
    (standard) or full row count (modified hybrid variant, reference
    gcv.py:69-72). Identical in exact arithmetic to the reference's
    solve-based num/trace (gcv.py:25-78).

    projected_only=True restricts the numerator to the projected system's
    live filtered directions — the reference's *standard* variant ignores
    the out-of-range residual even when given one (gcv.py:46-47 adds it
    only under variant='modified'), which is what Hybrid GMRES consumes.
    """
    sv2, bhat, rest2 = _filtered_pencil(R_A, R_L, bproj, active_mask)
    bhat2 = bhat**2
    k_active = jnp.sum(active_mask.astype(sv2.dtype))
    # first k_active singular values (descending order) are the live ones
    live = jnp.arange(sv2.shape[0]) < jnp.sum(active_mask)

    def gcv(lam):
        d = sv2 + lam
        if projected_only:
            num = lam**2 * jnp.sum(jnp.where(live, bhat2 / d**2, 0.0))
        else:
            num = lam**2 * jnp.sum(bhat2 / d**2) + rest2 + out_norm2
        # t_term - trace = (t_term - k) + sum_live(1 - sv2/d)
        #                = (t_term - k) + sum_live(lam/d):
        # cancellation-free, where the direct subtraction k - (k - eps)
        # is pure noise in f32 for small lam (it moved the GCV minimizer
        # by orders of magnitude in pure f32)
        den = (t_term - k_active) + jnp.sum(jnp.where(live, lam / d, 0.0))
        return num / den**2

    return fminbound(gcv, 1e-9, 1e2, xtol=1e-12, maxfun=1000)


def _dp_lambda_masked(R_A, R_L, bproj, out_norm2, delta, eta, active):
    """Masked on-device DP for a square projected pencil (GKS/MMGKS path).

    Standard-form transform for general (invertible-on-the-active-block)
    R_L via a pinned solve — Anew = R_A (R_L + pin)^{-1} — then the Newton
    iteration in filtered SVD coordinates. Mirrors the host rule
    (regparam/dp.py:53-99; reference discrepancy_principle.py:33-99): for a
    square pencil testzero = out_norm2 - thresh decides attainability and
    out_norm2 does not enter f (non-explicitProj quirk).
    """
    thresh = (eta * delta) ** 2
    pin = _pin(active)
    Anew = jnp.linalg.solve((R_L + pin).T, R_A.T).T * active[None, :]
    U, S, _ = jnp.linalg.svd(Anew, full_matrices=True)
    sv2 = S**2
    bhat = U.T @ jnp.reshape(bproj, (-1,))
    testzero = out_norm2 - thresh
    return _dp_newton_filtered(sv2, bhat, thresh, testzero)


def _dp_lambda_masked_rect(Bm, bh, delta, eta, k_active):
    """Masked on-device DP for the hybrid (k+1, k) bidiagonal system.

    ``Bm`` is the (K+1, K) padded factor with k_active live columns and
    bh the padded projected data. The host rule's tail term (the component
    of bh outside the active range, discrepancy_principle.py:66-75) is
    recovered as ||bh||^2 - sum of the k_active largest-sv coefficients.
    """
    thresh = (eta * delta) ** 2
    U, S, _ = jnp.linalg.svd(Bm, full_matrices=True)
    sv2 = jnp.concatenate([S**2, jnp.zeros((1,), S.dtype)])
    bhat = U.T @ jnp.reshape(bh, (-1,))
    live = jnp.arange(Bm.shape[1] + 1) < k_active
    tail2 = jnp.sum(bh**2) - jnp.sum(jnp.where(live, bhat[: Bm.shape[1] + 1]
                                               ** 2, 0.0))
    testzero = tail2 - thresh
    return _dp_newton_filtered(sv2, bhat, thresh, testzero)


def _lcurve_lambda_masked(R_A, R_L, bproj, active):
    """Masked on-device L-curve: lam maximizing the plain (non-log)
    curvature of (f, g) = (||R_A x - b||^2, ||R_L x||^2), Brent on
    [1e-9, 2] (reference l_curve.py:171-203). Derivatives are evaluated
    as elementwise filtered-SVD sums — identical in exact arithmetic to
    the reference's repeated (C + lam D) solves, f32-robust:

      f' = 2 lam sum(b^2 s2/d^3)       g' = -2 sum(b^2 s2/d^3)
      f'' = 2 sum(b^2 s2 (s2-2lam)/d^4) g'' = 6 sum(b^2 s2/d^4),  d = s2+lam

    (constants in f drop out of the curvature, so rest2 is irrelevant).
    """
    sv2, bhat, _ = _filtered_pencil(R_A, R_L, bproj, active)
    b2s2 = bhat**2 * sv2

    def neg_curv(lam):
        d = sv2 + lam
        t3 = jnp.sum(b2s2 / d**3)
        t4 = jnp.sum(b2s2 / d**4)
        f1 = 2.0 * lam * t3
        g1 = -2.0 * t3
        f2 = 2.0 * jnp.sum(b2s2 * (sv2 - 2.0 * lam) / d**4)
        g2 = 6.0 * t4
        num = -g1 * f2 + f1 * g2
        den = (g1**2 + f1**2) ** 1.5
        return -num / den

    return fminbound(neg_curv, 1e-9, 2.0, xtol=1e-12, maxfun=1000)


def _resolve_mode(regparam_mode, use_gcv):
    if use_gcv is not None:  # legacy flag from round-1 callers
        return "gcv" if use_gcv else "scalar"
    if regparam_mode not in ("gcv", "dp", "l_curve", "scalar"):
        raise ValueError(
            f"regparam_mode must be 'gcv' | 'dp' | 'l_curve' | 'scalar', "
            f"got {regparam_mode!r}")
    return regparam_mode


def _gks_init(A, b, L, projection_dim, n_iter):
    b = jnp.reshape(b, (-1,))
    m, n = A.shape
    s = L.shape[0]
    K = projection_dim + n_iter
    dtype = b.dtype
    _, _, V0 = golub_kahan(A, b, projection_dim)
    V = jnp.zeros((n, K), dtype).at[:, :projection_dim].set(V0)
    AV = jnp.zeros((m, K), dtype).at[:, :projection_dim].set(A.matmat(V0))
    LV = jnp.zeros((s, K), dtype).at[:, :projection_dim].set(L.matmat(V0))
    return (V, AV, LV, jnp.zeros((n,), dtype),
            jnp.zeros((n_iter,), dtype), jnp.zeros((n_iter,), dtype))


def _gks_body(A, b, L, mode, regparam, delta, eta, projection_dim, K):
    b = jnp.reshape(b, (-1,))
    dtype = b.dtype
    col_idx = jnp.arange(K)

    def body(ii, carry):
        V, AV, LV, x, lams, resids = carry
        k = projection_dim + ii
        active = col_idx < k

        QA, R_A = _masked_qr(AV, active)
        QL, R_L = _masked_qr(LV, active)
        bproj = (QA.T @ b) * active

        if mode == "gcv":
            lam = _gcv_lambda_masked(R_A, R_L, bproj, k.astype(dtype),
                                     active).astype(dtype)
        elif mode == "dp":
            out_norm2 = jnp.sum(b**2) - jnp.sum(bproj**2)
            lam = _dp_lambda_masked(R_A, R_L, bproj, out_norm2, delta, eta,
                                    active).astype(dtype)
        elif mode == "l_curve":
            lam = _lcurve_lambda_masked(R_A, R_L, bproj, active).astype(
                dtype)
        else:
            lam = jnp.asarray(regparam, dtype)
        y = _masked_tikhonov_solve(R_A, R_L, bproj, lam, active)
        x = V @ y

        r = A.rmatvec(AV @ y - b) + lam * L.rmatvec(LV @ y)
        for _ in range(3):
            r = r - V @ (V.T @ r)
        rnorm = jnp.linalg.norm(r)
        vn = r / rnorm

        V = V.at[:, k].set(vn)
        AV = AV.at[:, k].set(A.matvec(vn))
        LV = LV.at[:, k].set(L.matvec(vn))
        lams = lams.at[ii].set(lam)
        resids = resids.at[ii].set(rnorm)
        return (V, AV, LV, x, lams, resids)

    return body


@partial(jax.jit, static_argnames=("projection_dim", "n_iter", "use_gcv",
                                   "regparam_mode"))
def fused_gks(A, b, L, projection_dim=3, n_iter=20, regparam=1.0,
              use_gcv=None, regparam_mode="gcv", delta=0.0, eta=1.01):
    """All-on-device GKS. Returns (x, lambda_history, residual_history).

    regparam_mode: 'gcv' | 'dp' | 'l_curve' | 'scalar' — all four run
    on device with no host sync. 'dp' requires
    ``delta``. ``use_gcv`` is the legacy round-1 flag (True -> 'gcv',
    False -> 'scalar'); ``regparam`` is the fixed lam for 'scalar'.
    """
    mode = _resolve_mode(regparam_mode, use_gcv)
    K = projection_dim + n_iter
    body = _gks_body(A, b, L, mode, regparam, delta, eta, projection_dim, K)
    carry = jax.lax.fori_loop(0, n_iter, body,
                              _gks_init(A, b, L, projection_dim, n_iter))
    return carry[3], carry[4], carry[5]


@partial(jax.jit, static_argnames=("projection_dim", "n_iter", "chunk",
                                   "use_gcv", "regparam_mode"))
def _fused_gks_chunk(A, b, L, carry, i0, chunk, projection_dim=3, n_iter=20,
                     regparam=1.0, use_gcv=None, regparam_mode="gcv",
                     delta=0.0, eta=1.01):
    mode = _resolve_mode(regparam_mode, use_gcv)
    K = projection_dim + n_iter
    body = _gks_body(A, b, L, mode, regparam, delta, eta, projection_dim, K)
    return jax.lax.fori_loop(i0, i0 + chunk, body, carry)


@partial(jax.jit, static_argnames=("projection_dim", "n_iter", "use_gcv",
                                   "regparam_mode", "weight_mode",
                                   "prob_dims"))
def fused_mmgks(A, b, L, pnorm=2.0, qnorm=1.0, epsilon=0.1,
                projection_dim=3, n_iter=20, regparam=1.0, use_gcv=None,
                regparam_mode="gcv", delta=0.0, eta=1.01,
                weight_mode="holder", prob_dims=None):
    """All-on-device MMGKS.

    regparam_mode: 'gcv' | 'dp' | 'l_curve' | 'scalar', all on device.
    GCV/DP see the *weighted* projected data (QA^T (wf b)) while the solve
    and the L-curve use QA^T b, mirroring the host rule (mmgks.py:99-106;
    reference MMGKS.py:96-106). Returns (x, lambda_history,
    residual_history).

    weight_mode: 'holder' (smoothed-Holder, the reference default) |
    'isoTV' | 'GS' — the reference's dynamic-CT modes (MMGKS.py:61-91),
    evaluated on device inside the fused loop. Both dynamic modes require
    ``prob_dims=(nx, ny, nt)`` (static). In 'GS' mode the regularizer is
    replaced by kron(I_nt, D_2d) exactly as the reference rebuilds it
    (MMGKS.py:44-50) — the passed ``L`` is ignored. ``A`` may be any
    registered operator pytree, including ``DynamicBandedOperator`` — the
    whole dynamic reconstruction is then one device program.
    """
    mode = _resolve_mode(regparam_mode, use_gcv)
    if weight_mode not in ("holder", "isoTV", "GS"):
        raise ValueError(
            f"weight_mode must be 'holder' | 'isoTV' | 'GS', got "
            f"{weight_mode!r}")
    if weight_mode in ("isoTV", "GS"):
        if prob_dims is None:
            raise TypeError(
                "For isotropic TV / group sparsity you must enter the "
                "dimensions of the dynamic problem, e.g. "
                "prob_dims=(nx, ny, nt).")
        nxd, nyd, ntd = prob_dims
    L = _mmgks_regularizer(L, weight_mode, prob_dims)
    K = projection_dim + n_iter
    body = _mmgks_body(A, b, L, mode, pnorm, qnorm, epsilon, regparam,
                       delta, eta, weight_mode, prob_dims, projection_dim,
                       K)
    carry = jax.lax.fori_loop(
        0, n_iter, body, _mmgks_init(A, b, L, projection_dim, n_iter))
    return carry[3], carry[4], carry[5]


def _mmgks_regularizer(L, weight_mode, prob_dims):
    if weight_mode != "GS":
        return L
    from ..core.linop import BatchedBlockDiagOperator
    from ..operators.derivatives import FirstDerivative2D

    nxd, nyd, ntd = prob_dims
    return BatchedBlockDiagOperator(FirstDerivative2D(nxd, nyd), ntd)


def _mmgks_init(A, b, L, projection_dim, n_iter):
    b = jnp.reshape(b, (-1,))
    m, n = A.shape
    s = L.shape[0]
    K = projection_dim + n_iter
    dtype = b.dtype
    _, _, V0 = golub_kahan(A, b, projection_dim)
    V = jnp.zeros((n, K), dtype).at[:, :projection_dim].set(V0)
    AV = jnp.zeros((m, K), dtype).at[:, :projection_dim].set(A.matmat(V0))
    LV = jnp.zeros((s, K), dtype).at[:, :projection_dim].set(L.matmat(V0))
    return (V, AV, LV, A.rmatvec(b),
            jnp.zeros((n_iter,), dtype), jnp.zeros((n_iter,), dtype))


def _mmgks_body(A, b, L, mode, pnorm, qnorm, epsilon, regparam, delta, eta,
                weight_mode, prob_dims, projection_dim, K):
    b = jnp.reshape(b, (-1,))
    dtype = b.dtype
    col_idx = jnp.arange(K)
    if weight_mode in ("isoTV", "GS"):
        nxd, nyd, ntd = prob_dims
    Ls2d = L.op if weight_mode == "GS" else None

    def body(ii, carry):
        V, AV, LV, x, lams, resids = carry
        k = projection_dim + ii
        active = col_idx < k

        v = A.matvec(x) - b
        wf = smoothed_holder_weights(v, epsilon, pnorm)
        u = L.matvec(x)
        if weight_mode == "isoTV":
            wr = iso_tv_weights(x, u, nxd, nyd, ntd, epsilon, qnorm)
        elif weight_mode == "GS":
            wr = gs_weights(x, Ls2d.matmat, nxd, nyd, ntd, qnorm)
        else:
            wr = smoothed_holder_weights(u, epsilon, qnorm)

        QA, R_A = _masked_qr(AV * wf[:, None], active)
        QL, R_L = _masked_qr(LV * wr[:, None], active)
        bproj = (QA.T @ (wf * b)) * active
        bsolve = (QA.T @ b) * active

        if mode == "gcv":
            lam = _gcv_lambda_masked(R_A, R_L, bproj, k.astype(dtype),
                                     active).astype(dtype)
        elif mode == "dp":
            wb = wf * b
            out_norm2 = jnp.sum(wb**2) - jnp.sum(bproj**2)
            lam = _dp_lambda_masked(R_A, R_L, bproj, out_norm2, delta, eta,
                                    active).astype(dtype)
        elif mode == "l_curve":
            lam = _lcurve_lambda_masked(R_A, R_L, bsolve, active).astype(
                dtype)
        else:
            lam = jnp.asarray(regparam, dtype)
        y = _masked_tikhonov_solve(R_A, R_L, bsolve, lam, active)
        x = V @ y

        r = A.rmatvec(wf * (AV @ y - b)) + lam * L.rmatvec(wr * (LV @ y))
        for _ in range(2):
            r = r - V @ (V.T @ r)
        rnorm = jnp.linalg.norm(r)
        vn = r / rnorm

        V = V.at[:, k].set(vn)
        AV = AV.at[:, k].set(A.matvec(vn))
        LV = LV.at[:, k].set(L.matvec(vn))
        lams = lams.at[ii].set(lam)
        resids = resids.at[ii].set(rnorm)
        return (V, AV, LV, x, lams, resids)

    return body


@partial(jax.jit, static_argnames=("projection_dim", "n_iter", "chunk",
                                   "use_gcv", "regparam_mode",
                                   "weight_mode", "prob_dims"))
def _fused_mmgks_chunk(A, b, L, carry, i0, chunk, pnorm=2.0, qnorm=1.0,
                       epsilon=0.1, projection_dim=3, n_iter=20,
                       regparam=1.0, use_gcv=None, regparam_mode="gcv",
                       delta=0.0, eta=1.01, weight_mode="holder",
                       prob_dims=None):
    mode = _resolve_mode(regparam_mode, use_gcv)
    L = _mmgks_regularizer(L, weight_mode, prob_dims)
    K = projection_dim + n_iter
    body = _mmgks_body(A, b, L, mode, pnorm, qnorm, epsilon, regparam,
                       delta, eta, weight_mode, prob_dims, projection_dim,
                       K)
    return jax.lax.fori_loop(i0, i0 + chunk, body, carry)


@partial(jax.jit, static_argnames=("n_iter", "use_gcv", "reorth",
                                   "regparam_mode"))
def fused_hybrid_lsqr(A, b, n_iter=50, regparam=1.0, use_gcv=None,
                      reorth=False, regparam_mode="gcv", delta=0.0,
                      eta=1.01):
    """All-on-device Hybrid LSQR: fused Golub-Kahan factorization, then a
    fori_loop sweep over k with masked projected (k+1, k) systems and
    on-device lam selection — modified-GCV (fullsize = m, reference
    Hybrid_LSQR.py:80-84), DP (Newton in filtered SVD coordinates,
    :85-93), L-curve (analytic curvature on the rectangular pencil, :94-98)
    or a fixed scalar. Returns (x, lambda_history).
    """
    mode = _resolve_mode(regparam_mode, use_gcv)
    body, init, start = _hybrid_lsqr_parts(A, b, n_iter, mode, regparam,
                                           delta, eta, reorth)
    x, lams, _ = jax.lax.fori_loop(start, n_iter, body, init)
    return x, lams


def _hybrid_lsqr_parts(A, b, n_iter, mode, regparam, delta, eta, reorth):
    """(body, init_carry, start_iter) of the fused Hybrid LSQR sweep; the
    carry is (x, lambda_history, projected_residual_history) so the info
    adapter (``fused_info``) can scan the same body."""
    b = jnp.reshape(b, (-1,))
    m, n = A.shape
    K = n_iter
    dtype = b.dtype

    U, B, V = golub_kahan(A, b, n_iter, reorth=reorth)
    beta = jnp.linalg.norm(b)
    bhat = jnp.zeros((K + 1,), dtype).at[0].set(beta)
    # DP projects with the *computed* basis (which loses orthogonality
    # without reorth), exactly as the reference passes Q=U to
    # discrepancy_principle (Hybrid_LSQR.py:85-93; host hybrid.py:95-100)
    Ub = U.T @ b if mode == "dp" else bhat
    row_idx = jnp.arange(K + 1)
    col_idx = jnp.arange(K)

    def body(ii, carry):
        x, lams, resids = carry
        k = ii + 1  # active columns (first solve at ii=1, as the reference)
        col_active = col_idx < k
        row_active = row_idx < k + 1
        Bm = B * col_active[None, :] * row_active[:, None]
        # Ub == bhat except in DP mode, where both the selection and the
        # solve use the computed projection (host hybrid.py:95-106)
        bh = Ub * row_active
        R_L = jnp.eye(K, dtype=dtype)
        if mode == "gcv":
            lam = _gcv_lambda_masked(
                Bm, R_L * col_active[None, :], bh,
                jnp.asarray(float(m), dtype), col_active).astype(dtype)
        elif mode == "dp":
            lam = _dp_lambda_masked_rect(Bm, bh, delta, eta, k).astype(
                dtype)
        elif mode == "l_curve":
            lam = _lcurve_lambda_masked(
                Bm, R_L * col_active[None, :], bh, col_active).astype(dtype)
        else:
            lam = jnp.asarray(regparam, dtype)
        y = _masked_tikhonov_solve(Bm, R_L * col_active[None, :], bh, lam,
                                   col_active)
        x = V @ y
        lams = lams.at[ii].set(lam)
        # ||A x - b|| through the projected identity ||B y - bhat||
        # (exact for an orthonormal computed basis)
        resids = resids.at[ii].set(jnp.linalg.norm(B @ y - bhat))
        return (x, lams, resids)

    init = (jnp.zeros((n,), dtype), jnp.zeros((n_iter,), dtype),
            jnp.zeros((n_iter,), dtype))
    return body, init, 1


@partial(jax.jit, static_argnames=("n_iter", "use_gcv", "reorth",
                                   "regparam_mode"))
def fused_hybrid_gmres(A, b, n_iter=50, regparam=1.0, use_gcv=None,
                       reorth=False, regparam_mode="gcv", delta=0.0,
                       eta=1.01):
    """All-on-device Hybrid GMRES: fused Arnoldi factorization of a square
    A, then a fori_loop sweep over k with masked projected (k+1, k)
    Hessenberg systems and on-device lam selection (standard GCV / DP with
    the computed-basis projection / L-curve / scalar — reference
    Hybrid_GMRES.py:23-87; lam = 0 at the first iteration).
    Returns (x, lambda_history).
    """
    mode = _resolve_mode(regparam_mode, use_gcv)
    body, init, start = _hybrid_gmres_parts(A, b, n_iter, mode, regparam,
                                            delta, eta, reorth)
    x, lams, _ = jax.lax.fori_loop(start, n_iter, body, init)
    return x, lams


def _hybrid_gmres_parts(A, b, n_iter, mode, regparam, delta, eta, reorth):
    """(body, init_carry, start_iter) of the fused Hybrid GMRES sweep;
    carry (x, lambda_history, projected_residual_history)."""
    from ..krylov import arnoldi

    b = jnp.reshape(b, (-1,))
    n = A.shape[1]
    K = n_iter
    dtype = b.dtype

    Q, H = arnoldi(A, b, n_iter, reorth=reorth)
    beta = jnp.linalg.norm(b)
    bhat = jnp.zeros((K + 1,), dtype).at[0].set(beta)
    Qb = Q.T @ b if mode == "dp" else bhat
    row_idx = jnp.arange(K + 1)
    col_idx = jnp.arange(K)

    def body(ii, carry):
        x, lams, resids = carry
        k = ii + 1
        col_active = col_idx < k
        row_active = row_idx < k + 1
        Hm = H * col_active[None, :] * row_active[:, None]
        bh = Qb * row_active
        R_L = jnp.eye(K, dtype=dtype)
        if mode == "gcv":
            bh_g = bhat * row_active
            lam = _gcv_lambda_masked(
                Hm, R_L * col_active[None, :], bh_g,
                jnp.sum(col_active.astype(dtype)), col_active,
                projected_only=True).astype(dtype)
        elif mode == "dp":
            lam = _dp_lambda_masked_rect(Hm, bh, delta, eta, k).astype(
                dtype)
        elif mode == "l_curve":
            bh_l = bhat * row_active
            lam = _lcurve_lambda_masked(
                Hm, R_L * col_active[None, :], bh_l, col_active).astype(
                dtype)
        else:
            lam = jnp.asarray(regparam, dtype)
        lam = jnp.where(ii == 0, jnp.asarray(0.0, dtype), lam)
        bsolve = (Qb if mode == "dp" else bhat) * row_active
        y = _masked_tikhonov_solve(Hm, R_L * col_active[None, :], bsolve,
                                   lam, col_active)
        x = Q[:, :K] @ y
        lams = lams.at[ii].set(lam)
        resids = resids.at[ii].set(jnp.linalg.norm(H @ y - bhat))
        return (x, lams, resids)

    init = (jnp.zeros((n,), dtype), jnp.zeros((n_iter,), dtype),
            jnp.zeros((n_iter,), dtype))
    return body, init, 0

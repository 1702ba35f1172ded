"""End-to-end solver tests on a 1D deblurring problem (the reference's
demo_1D_deblurring configuration, scaled down) plus trajectory-parity tests
against a NumPy oracle that mirrors the reference Hybrid LSQR loop."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.optimize as sop

from trips_tpu.core import DenseOperator, IdentityOperator
from trips_tpu.operators import Blur1D, FirstDerivative1D, first_derivative_matrix
from trips_tpu.solvers import (
    CGLS,
    GKS,
    GMRES,
    Arnoldi_Tikhonov,
    Golub_Kahan_Tikhonov,
    Hybrid_GMRES,
    Hybrid_LSQR,
    MMGKS,
    Tikhonov,
    tGSVD_sol,
    tSVD_sol,
)

from oracles import golub_kahan_np


def curve0(n):
    """Reference gen_xtrue 'curve0' (Deblurring1D.py:158-165)."""
    h = np.pi / n
    grid = -np.pi / 2 + np.arange(0.5, n, 1) * h
    x1 = 2 * np.exp(-6 * (grid - 0.8) ** 2)
    x2 = 1 * np.exp(-2 * (grid + 0.5) ** 2)
    return x1 + x2


@pytest.fixture(scope="module")
def deblur1d():
    n = 100
    rng = np.random.default_rng(42)
    op = Blur1D(n, 5.0)
    A = np.asarray(op.mat)
    x_true = curve0(n)
    b_true = A @ x_true
    e = rng.standard_normal(n)
    sig = 0.02 * np.linalg.norm(b_true) / np.linalg.norm(e)
    b = b_true + sig * e
    delta = np.linalg.norm(sig * e)
    return dict(op=op, A=A, x_true=x_true, b=b, delta=delta, n=n)


def relerr(x, x_true):
    x = np.asarray(x).reshape(-1)
    return np.linalg.norm(x - x_true) / np.linalg.norm(x_true)


def test_tikhonov_gcv(deblur1d):
    d = deblur1d
    x, lam = Tikhonov(d["A"], d["b"], np.eye(d["n"]))
    assert lam > 0
    assert relerr(x, d["x_true"]) < 0.2
    # matches the direct normal-equations solve at the same lam
    x0 = sla.solve(d["A"].T @ d["A"] + lam * np.eye(d["n"]), d["A"].T @ d["b"])
    np.testing.assert_allclose(np.asarray(x).reshape(-1), x0, atol=1e-8)


def test_tikhonov_dp(deblur1d):
    d = deblur1d
    x, lam = Tikhonov(d["A"], d["b"], np.eye(d["n"]), regparam="dp", delta=d["delta"])
    assert lam > 0
    x_lam = sla.solve(d["A"].T @ d["A"] + lam * np.eye(d["n"]), d["A"].T @ d["b"])
    assert np.linalg.norm(d["A"] @ x_lam - d["b"]) == pytest.approx(
        1.01 * d["delta"], rel=1e-4
    )


def test_tikhonov_general_L(deblur1d):
    d = deblur1d
    L = first_derivative_matrix(d["n"]).toarray()
    x, lam = Tikhonov(d["A"], d["b"], L, regparam="dp", delta=d["delta"])
    assert relerr(x, d["x_true"]) < 0.2


def test_tsvd(deblur1d):
    d = deblur1d
    x, k = tSVD_sol(d["A"], d["b"], regparam="dp", delta=d["delta"])
    assert 0 < k < d["n"]
    assert relerr(x, d["x_true"]) < 0.25
    x2, k2 = tSVD_sol(d["A"], d["b"], regparam="gcv")
    assert relerr(x2, d["x_true"]) < 0.25


def test_tgsvd(deblur1d):
    d = deblur1d
    # the reference demo zero-pads L to square for the GSVD
    L = np.vstack([first_derivative_matrix(d["n"]).toarray(), np.zeros((1, d["n"]))])
    x, k = tGSVD_sol(d["A"], L, d["b"], regparam="gcv")
    assert relerr(x, d["x_true"]) < 0.3


def test_arnoldi_tikhonov(deblur1d):
    d = deblur1d
    for rp in ["gcv", "dp", 0.01]:
        x, lam = Arnoldi_Tikhonov(d["A"], d["b"], n_iter=8, regparam=rp, delta=d["delta"])
        assert relerr(x, d["x_true"]) < 0.25, rp


def test_gk_tikhonov(deblur1d):
    d = deblur1d
    for rp in ["gcv", "dp"]:
        x, lam = Golub_Kahan_Tikhonov(d["A"], d["b"], n_iter=3, regparam=rp, delta=d["delta"])
        assert relerr(x, d["x_true"]) < 0.3, rp


def test_gmres(deblur1d):
    d = deblur1d
    x = GMRES(d["A"], d["b"], n_iter=5)
    # semiconvergence: a few GMRES iterations regularize
    assert relerr(x, d["x_true"]) < 0.35


def test_cgls(deblur1d):
    d = deblur1d
    x, info = CGLS(d["A"], d["b"], np.zeros(d["n"]), 15, 1e-9, x_true=d["x_true"])
    assert info["its"] >= 1
    assert len(info["relError"]) == len(info["xHistory"])
    assert min(info["relError"]) < 0.2


def test_hybrid_lsqr_all_regparams(deblur1d):
    d = deblur1d
    # the plain-curvature L-curve criterion is qualitatively weaker (as in
    # the reference); it gets a looser bound
    for rp, bound in [("gcv", 0.25), ("dp", 0.25), ("l_curve", 0.8), (0.01, 0.25)]:
        x, info = Hybrid_LSQR(
            d["A"], d["b"], n_iter=12, regparam=rp, delta=d["delta"], x_true=d["x_true"]
        )
        assert relerr(x, d["x_true"]) < bound, rp
        assert len(info["regParam_history"]) >= 1


def test_hybrid_gmres_all_regparams(deblur1d):
    d = deblur1d
    for rp, bound in [("gcv", 0.3), ("dp", 0.3), ("l_curve", 0.8)]:
        x, info = Hybrid_GMRES(
            d["A"], d["b"], n_iter=12, regparam=rp, delta=d["delta"], x_true=d["x_true"]
        )
        assert relerr(x, d["x_true"]) < bound, rp


def test_gks(deblur1d):
    d = deblur1d
    L = FirstDerivative1D(d["n"])
    for rp in ["gcv", "dp"]:
        x, info = GKS(
            d["A"], d["b"], L, projection_dim=3, n_iter=10, regparam=rp,
            delta=d["delta"], x_true=d["x_true"],
        )
        assert relerr(x, d["x_true"]) < 0.25, rp
    # identity-L branch (SVD path)
    x, info = GKS(
        d["A"], d["b"], IdentityOperator(d["n"]), projection_dim=3, n_iter=8,
        regparam="gcv", x_true=d["x_true"],
    )
    assert relerr(x, d["x_true"]) < 0.25


def test_mmgks(deblur1d):
    d = deblur1d
    L = FirstDerivative1D(d["n"])
    x, info = MMGKS(
        d["A"], d["b"], L, pnorm=2, qnorm=1, projection_dim=3, n_iter=10,
        regparam="gcv", x_true=d["x_true"],
    )
    assert relerr(x, d["x_true"]) < 0.25
    assert len(info["regParam_history"]) == 10


def test_mmgks_scalar_lambda(deblur1d):
    d = deblur1d
    L = FirstDerivative1D(d["n"])
    x, info = MMGKS(
        d["A"], d["b"], L, pnorm=2, qnorm=1, projection_dim=3, n_iter=8,
        regparam=0.05, x_true=d["x_true"],
    )
    assert relerr(x, d["x_true"]) < 0.3


# ---------------- trajectory parity vs a literal reference mirror ----------


def hybrid_lsqr_oracle(A, b, n_iter, m):
    """NumPy mirror of Hybrid_LSQR with GCV (Hybrid_LSQR.py:64-107), coded
    from the reference formulas independently of the library internals."""
    beta = np.linalg.norm(b)
    U = (b / beta).reshape(-1, 1)
    B = np.empty(1)
    V = np.empty((len(b), 1))
    lams, xs = [], []
    bhat = np.array([beta])
    for ii in range(n_iter):
        # golub_kahan_update (decompositions.py:230-255)
        k = B.shape[0] if B.ndim == 2 else 1
        utemp = U[:, -1]
        if k == 1:
            v = A.T @ utemp
        else:
            v = A.T @ utemp - B[k - 1, k - 2] * V[:, k - 2]
        alpha = np.linalg.norm(v)
        v = v / alpha
        u = A @ v - alpha * utemp
        beta_k = np.linalg.norm(u)
        u = u / beta_k
        U = np.hstack([U, u.reshape(-1, 1)])
        V = v.reshape(-1, 1) if k == 1 else np.hstack([V, v.reshape(-1, 1)])
        t1 = np.zeros(k); t1[-1] = alpha
        t2 = np.zeros(k); t2[-1] = beta_k
        if k == 1:
            B = np.array([t1, t2])
        else:
            B = np.vstack([np.hstack([B, t1.reshape(-1, 1)]), t2.reshape(1, -1)])
        bhat = np.append(bhat, 0)
        if ii == 0:
            continue
        Q_A, sv, _ = sla.svd(B, full_matrices=False)
        R_A = np.diag(sv)
        R_L = np.eye(B.shape[1])

        def gcv_func(lam):
            G = R_A.T @ R_A + lam * R_L.T @ R_L
            z = sla.solve(G, R_A.T @ (Q_A.T @ bhat))
            num = np.linalg.norm(R_A @ z - Q_A.T @ bhat) ** 2
            num += np.linalg.norm(bhat - Q_A @ (Q_A.T @ bhat)) ** 2
            tr = m - np.trace(R_A @ sla.solve(G, R_A.T))
            return num / tr**2

        lam = float(sop.fminbound(gcv_func, 1e-9, 1e2, xtol=1e-12, maxfun=1000, disp=0))
        lams.append(lam)
        y, *_ = np.linalg.lstsq(
            np.vstack([B, np.sqrt(lam) * np.eye(B.shape[1])]),
            np.concatenate([bhat, np.zeros(B.shape[1])]),
            rcond=None,
        )
        xs.append(V @ y)
    return xs, lams


def test_hybrid_lsqr_parity_with_reference_mirror(deblur1d):
    d = deblur1d
    n_iter = 8
    xs0, lams0 = hybrid_lsqr_oracle(d["A"], d["b"], n_iter, d["A"].shape[0])
    x, info = Hybrid_LSQR(d["A"], d["b"], n_iter=n_iter, regparam="gcv")
    lams = info["regParam_history"]
    np.testing.assert_allclose(lams, lams0, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(x).reshape(-1), xs0[-1], rtol=1e-5, atol=1e-8
    )


def test_hybrid_lsqr_dp_stop_matvec_economy(deblur1d):
    """dp_stop factorizes in chunks and stops at the DP iteration
    (reference Hybrid_LSQR.py:85-93 stops the factorization there too):
    a stop at iteration k must cost O(k) matvecs, not
    O(n_iter). The solver accounts dispatched A/A^T applies in
    info['matvec_count'] (fused loops are opaque to Python counters)."""
    d = deblur1d
    x_full, info_full = Hybrid_LSQR(
        d["A"], d["b"], n_iter=60, regparam="dp", delta=d["delta"])
    assert info_full["matvec_count"] == 2 * 60

    x_stop, info_stop = Hybrid_LSQR(
        d["A"], d["b"], n_iter=60, regparam="dp", delta=d["delta"],
        dp_stop=True, gk_chunk=8)
    # reference quirk: unconditional stop at the first regularized
    # iteration (k = 2) -> one 8-step chunk
    assert info_stop["matvec_count"] == 2 * 8
    assert info_stop["its"] == 1
    # the economized factorization is the same recurrence: iterate at the
    # stop matches the full-factorization iterate at that k
    np.testing.assert_allclose(
        np.asarray(x_stop).ravel(),
        np.asarray(info_full["xHistory"][0]).ravel(), rtol=1e-6, atol=1e-9)


def test_hybrid_gmres_dp_stop_matvec_economy(deblur1d):
    """Same economy for Hybrid GMRES (reference Hybrid_GMRES.py:58-66
    factorizes incrementally and breaks at the DP iteration)."""
    d = deblur1d
    x_full, info_full = Hybrid_GMRES(
        d["A"], d["b"], n_iter=40, regparam="dp", delta=d["delta"])
    assert info_full["matvec_count"] == 40
    x_stop, info_stop = Hybrid_GMRES(
        d["A"], d["b"], n_iter=40, regparam="dp", delta=d["delta"],
        dp_stop=True, gk_chunk=8)
    assert info_stop["matvec_count"] == 8
    assert info_stop["its"] == 1
    np.testing.assert_allclose(
        np.asarray(x_stop).ravel(),
        np.asarray(info_full["xHistory"][1]).ravel(), rtol=1e-6, atol=1e-9)


def test_direct_dense_guard(deblur1d):
    """Direct solvers refuse to densify beyond DENSE_MAX_ELEMENTS
    (Tikhonov GCV used to materialize np.eye(m) and
    densify A unconditionally; a 21720x65536 operator would be 11 GB)."""
    from trips_tpu.solvers.direct import DENSE_MAX_ELEMENTS
    d = deblur1d

    class FakeBig:
        shape = (30_000, 30_000)

    with pytest.raises(ValueError, match="direct-solver limit"):
        Tikhonov(FakeBig(), d["b"], np.eye(d["n"]))
    with pytest.raises(ValueError, match="direct-solver limit"):
        tSVD_sol(FakeBig(), d["b"])
    with pytest.raises(ValueError, match="direct-solver limit"):
        tGSVD_sol(FakeBig(), np.eye(d["n"]), d["b"])
    # dense_max kwarg overrides (small problem, tiny limit -> raises;
    # generous limit -> solves)
    with pytest.raises(ValueError, match="direct-solver limit"):
        Tikhonov(d["A"], d["b"], np.eye(d["n"]), dense_max=10)
    x, lam = Tikhonov(d["A"], d["b"], np.eye(d["n"]),
                      dense_max=DENSE_MAX_ELEMENTS)
    assert lam > 0

"""On-device parameter search vs the scipy-backed host rules."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize as sop

from trips_tpu.regparam.device import dp_lambda, fminbound, gcv_lambda
from trips_tpu.regparam.dp import dp_tikhonov_projected
from trips_tpu.regparam.gcv import gcv_tikhonov_projected


@pytest.mark.parametrize(
    "func,lo,hi",
    [
        (lambda x: (x - 0.337) ** 2, 0.0, 2.0),
        (lambda x: jnp.sin(x) + 0.1 * x, 1e-9, 6.0),
        (lambda x: jnp.log(x) + 1.0 / x, 1e-3, 50.0),
        (lambda x: (x - 1e-6) ** 2 / (x + 1e-9), 1e-9, 1e2),
    ],
)
def test_fminbound_matches_scipy(func, lo, hi):
    x_dev = float(fminbound(func, lo, hi, xtol=1e-12, maxfun=1000))
    x_sp = float(
        sop.fminbound(lambda x: float(func(jnp.asarray(x))), lo, hi,
                      xtol=1e-12, maxfun=1000, disp=0)
    )
    assert x_dev == pytest.approx(x_sp, rel=1e-6, abs=1e-9)


def projected(rng, k=10):
    R_A = np.triu(rng.standard_normal((k, k))) + np.diag(np.logspace(0, -4, k))
    R_L = np.eye(k)
    bproj = rng.standard_normal(k)
    return R_A, R_L, bproj


def test_gcv_device_matches_host(rng):
    R_A, R_L, bproj = projected(rng)
    lam_host = gcv_tikhonov_projected(R_A, R_L, bproj)
    lam_dev = float(gcv_lambda(jnp.asarray(R_A), jnp.asarray(R_L), jnp.asarray(bproj)))
    assert lam_dev == pytest.approx(lam_host, rel=1e-5, abs=1e-10)


def test_gcv_device_modified_matches_host(rng):
    R_A, R_L, bproj = projected(rng)
    lam_host = gcv_tikhonov_projected(R_A, R_L, bproj, out_norm2=3.0,
                                      t_term=500.0, variant="modified")
    lam_dev = float(
        gcv_lambda(jnp.asarray(R_A), jnp.asarray(R_L), jnp.asarray(bproj),
                   out_norm2=3.0, t_term=500.0, variant="modified")
    )
    assert lam_dev == pytest.approx(lam_host, rel=1e-5, abs=1e-10)


def test_dp_device_matches_host(rng):
    k = 12
    B = np.zeros((k + 1, k))
    B[np.arange(k), np.arange(k)] = np.logspace(0, -2, k)
    B[np.arange(1, k + 1), np.arange(k)] = 0.3
    bproj = rng.standard_normal(k + 1)
    delta = 0.3 * np.linalg.norm(bproj)
    lam_host = dp_tikhonov_projected(B, np.eye(k), bproj, 0.0, delta=delta)
    lam_dev = float(dp_lambda(jnp.asarray(B), jnp.asarray(bproj), delta))
    assert lam_dev == pytest.approx(lam_host, rel=1e-6, abs=1e-12)


def test_dp_device_unattainable(rng):
    """Irreducible residual above eta*delta -> testzero >= 0 -> lam = 0
    (same semantics as the host rule and the reference)."""
    k = 6
    B = np.eye(k + 1)[:, :k]
    bproj = np.ones(k + 1)
    lam = float(dp_lambda(jnp.asarray(B), jnp.asarray(bproj), delta=1e-6))
    assert lam == 0.0


def test_device_tsvd_tgsvd_selection_matches_host(rng):
    """Device discrete truncation searches == host rules:
    gcv/dp x tsvd/tgsvd on full SVD/GSVD spectra."""
    from trips_tpu.regparam import (discrepancy_principle,
                                    generalized_crossvalidation)
    from trips_tpu.regparam.device import (dp_tgsvd_k, dp_tsvd_k,
                                           gcv_tgsvd_k, gcv_tsvd_k)
    from trips_tpu.utils.gsvd import gsvd

    for seed in range(4):
        r = np.random.default_rng(seed)
        m, n = 24, 18
        # ill-posed spectrum + noisy data
        U0, _ = np.linalg.qr(r.standard_normal((m, m)))
        V0, _ = np.linalg.qr(r.standard_normal((n, n)))
        S0 = np.geomspace(1, 1e-6, n)
        A = U0[:, :n] * S0 @ V0.T
        x = r.standard_normal(n)
        b = (A @ x + 1e-3 * r.standard_normal(m)).reshape(-1, 1)
        delta = 1e-3 * np.sqrt(m)

        U, S, VT = np.linalg.svd(A)
        bhat = jnp.asarray((U.T @ b).reshape(-1))
        k_host = generalized_crossvalidation(U, S, VT, b, gcvtype="tsvd")
        assert int(gcv_tsvd_k(bhat, n)) == k_host
        k_host = discrepancy_principle(U, S, VT, b, dptype="tsvd",
                                       delta=delta)
        assert int(dp_tsvd_k(bhat, n, delta)) == k_host

        # square L: the CSD construction needs rows(L) >= cols (m >= n >= p)
        L = np.eye(n) - np.diag(np.ones(n - 1), 1)
        Ug, _, X, C, Sg = gsvd(A, L)
        bh_g = jnp.asarray((Ug.T @ b).reshape(-1))
        k_host = generalized_crossvalidation(Ug, Sg, X, b, gcvtype="tgsvd")
        assert int(gcv_tgsvd_k(bh_g, X.shape[1], L.shape[0])) == k_host
        k_host = discrepancy_principle(Ug, C, X, b, dptype="tgsvd",
                                       delta=delta)
        assert int(dp_tgsvd_k(bh_g, X.shape[1], delta)) == k_host

    # saturation edges: huge delta
    assert int(dp_tsvd_k(bhat, n, 1e9)) == discrepancy_principle(
        U, S, VT, b, dptype="tsvd", delta=1e9)
    assert int(dp_tgsvd_k(bh_g, X.shape[1], 1e9)) == discrepancy_principle(
        Ug, C, X, b, dptype="tgsvd", delta=1e9)

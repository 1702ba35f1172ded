"""Test problems: demo-config integration tests (the reference's de-facto
test suite, SURVEY.md §2.8/§6) run end-to-end on synthetic data."""
import jax.numpy as jnp
import numpy as np
import pytest

from trips_tpu.core import IdentityOperator
from trips_tpu.operators import FirstDerivative2D, SpaceTimeDerivative
from trips_tpu.problems import (
    Deblurring1D,
    Deblurring2D,
    Tomography,
    generate_synthetic_dynamic,
)
from trips_tpu.problems.projector import fan_beam_matrix
from trips_tpu.solvers import GKS, MMGKS, Hybrid_LSQR, tSVD_sol
from trips_tpu.sparse import EllOperator


def relerr(x, x_true):
    x = np.asarray(x).reshape(-1)
    x_true = np.asarray(x_true).reshape(-1)
    return np.linalg.norm(x - x_true) / np.linalg.norm(x_true)


def test_deblurring1d_demo_config():
    """demo_1D_deblurring scaled down: n=100, Gaussian PSF, 2% noise."""
    np.random.seed(0)
    n = 100
    prob = Deblurring1D()
    A = prob.forward_Op_1D(parameter=5, nx=n)
    x_true = prob.gen_xtrue(n, "curve0")
    b_true = prob.gen_data(x_true, parameter=5)
    b, delta = prob.add_noise(b_true, "Gaussian", 0.02)
    # anti-crime data carries model error beyond the additive noise, so the
    # DP threshold must use the total discrepancy (else DP is unattainable
    # and returns lam = 0, as in the reference)
    delta_total = float(
        np.linalg.norm(np.asarray(b).reshape(-1) - np.asarray(A @ jnp.asarray(x_true)))
    )
    # reorth=True keeps the GK basis orthogonal so the projected residual
    # (which DP thresholds against) tracks the true attainable residual
    x, info = Hybrid_LSQR(A, b, n_iter=15, regparam="dp", delta=delta_total,
                          reorth=True)
    assert relerr(x, x_true) < 0.2
    x_gcv, _ = Hybrid_LSQR(A, b, n_iter=15, regparam="gcv")
    assert relerr(x_gcv, x_true) < 0.1
    # all ground-truth signals generate
    for sig in ["sigma", "piecewise", "curve0", "curve1", "curve2", "curve3"]:
        xt = prob.gen_xtrue(n, sig)
        assert np.asarray(xt).reshape(-1).shape == (n,)


def test_deblurring1d_anti_crime():
    """CommitCrime=False data differs from the solver operator's forward."""
    n = 60
    prob = Deblurring1D()
    A = prob.forward_Op_1D(parameter=4, nx=n)
    x = prob.gen_xtrue(n, "curve0")
    b_nocrime = prob.gen_data(x, parameter=4)
    b_crime = np.asarray(A @ jnp.asarray(x.reshape(-1))).reshape(-1, 1)
    assert not np.allclose(b_nocrime, b_crime)
    # but they should be close (same blur, different boundary handling)
    assert np.linalg.norm(b_nocrime - b_crime) / np.linalg.norm(b_crime) < 0.2


def test_deblurring2d_demo_config():
    """demo_2D_Deblurring_small_scale scaled down: 24x24 'H' image."""
    np.random.seed(0)
    n = 24
    prob = Deblurring2D()
    A = prob.forward_Op([3, 3], (1, 1), n, n)
    x_true = prob.gen_true("h_im", nx=n, ny=n)
    b_true = prob.gen_data(x_true.reshape(-1, 1))
    b, delta = prob.add_noise(b_true, "Gaussian", 0.01)
    x, info = Hybrid_LSQR(A, b.reshape(-1), n_iter=20, regparam="dp", delta=float(delta))
    assert relerr(x, x_true) < 0.35
    L = FirstDerivative2D(n, n)
    x2, _ = MMGKS(A, b.reshape(-1), L, pnorm=2, qnorm=1, projection_dim=3,
                  n_iter=12, regparam="gcv")
    assert relerr(x2, x_true) < 0.35


def test_tomography_demo_config():
    """demo_Tomo_small_scale: 32x32, 30 views, tectonic, 1% noise."""
    np.random.seed(0)
    n = 32
    views = 30
    tomo = Tomography(CommitCrime=False)
    x_true, nx, ny = tomo.gen_true("tectonic", nx=n, ny=n)
    OP, b, p, q, A = tomo.gen_data(x_true, nx, ny, views)
    b_noisy, delta = tomo.add_noise(b, "Gaussian", 0.01)
    b_vec = b_noisy.reshape(-1)
    # TSVD on the dense matrix
    x_tsvd, k = tSVD_sol(A.toarray(), b_vec, regparam="dp", delta=float(delta))
    assert relerr(x_tsvd, x_true) < 0.6
    # GKS with 2D derivative
    L = FirstDerivative2D(nx, ny)
    x_gks, info = GKS(OP, b_vec, L, projection_dim=3, n_iter=15, regparam="gcv",
                      x_true=x_true)
    assert relerr(x_gks, x_true) < 0.45
    assert min(info["relError"]) < 0.45


def test_tomography_anti_crime_mismatch():
    tomo = Tomography(CommitCrime=False)
    tomo.define_A(16, 16, 10)
    d = (tomo.A - tomo.A_mis)
    assert abs(d).max() > 0  # mismatched operator differs
    assert abs(d).max() < 1e-4  # ... by a tiny perturbation


def test_dynamic_synthetic_mmgks():
    """Dynamic CT pipeline offline: block-diag operator + spacetime TV."""
    A, b, AA, B, nx, ny, nt, delta, x_true = generate_synthetic_dynamic(
        nx=16, nt=4, views=8, noise_level=0.01
    )
    op = EllOperator.from_scipy(A, dtype=np.float64)
    L = SpaceTimeDerivative(nx, ny, nt)
    x, info = MMGKS(op, b, L, pnorm=2, qnorm=1, projection_dim=4, n_iter=12,
                    regparam="gcv", x_true=x_true)
    assert relerr(x, x_true) < 0.6
    # isoTV weights mode with the centered dynamic TV operator
    from trips_tpu.operators import CenteredSpaceTimeDerivative

    Ltv = CenteredSpaceTimeDerivative(nx, ny, nt)
    x2, _ = MMGKS(op, b, Ltv, pnorm=2, qnorm=1, projection_dim=4, n_iter=8,
                  regparam="gcv", isoTV="isoTV", prob_dims=(nx, ny, nt))
    assert relerr(x2, x_true) < 0.8
    # GS mode (rebuilds L internally)
    x3, _ = MMGKS(op, b, None, pnorm=2, qnorm=1, projection_dim=4, n_iter=8,
                  regparam="gcv", GS="GS", prob_dims=(nx, ny, nt))
    assert relerr(x3, x_true) < 0.8


def test_native_projector_matches_numpy():
    """C++ Siddon builder vs the vectorized NumPy implementation."""
    import trips_tpu.native as nat
    from trips_tpu.problems import projector as pj

    if nat.load() is None:
        pytest.skip("native toolchain unavailable")
    nx = 32
    # avoid exactly axis-aligned rays on pixel boundaries: tie-breaking for
    # those measure-zero rays is unspecified (ASTRA has the same ambiguity)
    angles = np.linspace(0, np.pi, 12, endpoint=False) + 0.0123
    p = int(np.sqrt(2) * nx)
    so, od = 3 * nx, nx
    d = (so + od) / so
    A_native = nat.fan_beam_csr_native(nx, nx, angles, p, d, so, od)
    Ap_native = nat.parallel_beam_csr_native(nx, nx, angles, nx, 1.0)
    # force the numpy fallback
    saved = (nat._lib, nat._tried)
    nat._lib, nat._tried = None, True
    try:
        A_np = pj.fan_beam_matrix(nx, angles=angles)
        Ap_np = pj.parallel_beam_matrix(nx, angles, model="line")
    finally:
        nat._lib, nat._tried = saved
    assert abs(A_native - A_np).max() < 1e-10
    assert abs(Ap_native - Ap_np).max() < 1e-10


def test_device_operator_prefers_banded_with_geometry():
    """prefer='banded' with fan geometry metadata returns the bucketed
    banded pack (exact matrix); without ``prefer`` the exact-class
    default format is used."""
    from trips_tpu.problems import tomography
    from trips_tpu.problems.tomography import device_sparse_operator
    from trips_tpu.sparse import BucketedBandedProjector, EllOperator

    nx, views = 32, 8
    angles = np.linspace(0, np.pi, views, endpoint=False)
    A = fan_beam_matrix(nx, angles=angles).astype(np.float32)
    op = device_sparse_operator(A, nx=nx, angles=angles,
                                prefer="banded")
    assert isinstance(op, BucketedBandedProjector)
    d = abs(op.to_scipy() - A.astype(np.float64))
    assert (d.max() if d.nnz else 0.0) == 0.0
    # exact-class default, the same on every platform
    op2 = device_sparse_operator(A, nx=nx, angles=angles)
    assert type(op2).__name__ == {
        "ell": "EllOperator", "bsr": "BsrOperator",
        "banded": "BucketedBandedProjector"}[tomography.DEFAULT_FORMAT]
    # solver end-to-end through the banded wrapper
    from trips_tpu.solvers import GKS
    from trips_tpu.operators import FirstDerivative2D

    from trips_tpu.problems.phantoms import shepp_logan

    xt = np.asarray(shepp_logan(nx)).reshape(-1)
    b = A @ xt
    x, info = GKS(op, b, FirstDerivative2D(nx, nx), projection_dim=3,
                  n_iter=10, regparam="gcv", x_true=xt)
    x2, info2 = GKS(EllOperator.from_scipy(A), b,
                    FirstDerivative2D(nx, nx), projection_dim=3,
                    n_iter=10, regparam="gcv", x_true=xt)
    # format parity: same solve through the exact banded pack and ELL
    assert (np.linalg.norm(np.asarray(x) - np.asarray(x2))
            / np.linalg.norm(np.asarray(x2))) < 1e-3


def test_device_sparse_operator_quantized_dtypes(rng):
    """device_sparse_operator accepts the quantized-class dtypes: bf16 /
    int8 select the bucketed pack with the matching storage, f32 stays
    exact."""
    import jax.numpy as jnp

    from trips_tpu.problems.projector import fan_beam_matrix
    from trips_tpu.problems.tomography import device_sparse_operator
    from trips_tpu.sparse.banded_buckets import BucketedBandedProjector

    nx, views = 32, 12
    angles = np.linspace(0, np.pi, views, endpoint=False)
    A = fan_beam_matrix(nx, angles=angles).astype(np.float32)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    for dt, wdtype, tol in ((np.float32, jnp.float32, 1e-5),
                            (jnp.bfloat16, jnp.bfloat16, 1e-2),
                            ("int8", jnp.int8, 1e-2)):
        op = device_sparse_operator(A, nx=nx, angles=angles, dtype=dt,
                                    prefer="banded")
        assert isinstance(op, BucketedBandedProjector)
        assert op.stacks[0][0].dtype == wdtype
        got = np.asarray(op.matvec(jnp.asarray(x)))
        rel = np.linalg.norm(got - A @ x) / np.linalg.norm(A @ x)
        assert rel < tol, (dt, rel)

"""Quantified deliberate deviations from the reference.

Each documented divergence gets a test against a *literal* NumPy mirror of
the reference's buggy code path, pinning the direction and magnitude of
the difference. PARITY.md's Deviations section links here.
"""
import jax.numpy as jnp
import numpy as np

from trips_tpu.core import DenseOperator
from trips_tpu.krylov import golub_kahan
from trips_tpu.operators import Blur1D
from trips_tpu.operators.framelet import analysis_matrix, construct_filters
from trips_tpu.problems import Deblurring1D
from trips_tpu.solvers import GKS


def _identity_problem(n=60, seed=11):
    rng = np.random.default_rng(seed)
    # DenseOperator (exact A^T adjoint), NOT Blur1D: Blur1D.rmatvec
    # deliberately mirrors the reference's reversed-PSF pseudo-adjoint
    # (Deblurring1D.py:59-62), which this mirror does not model
    A = np.asarray(Blur1D(n, 3.0).mat, dtype=float)
    op = DenseOperator(jnp.asarray(A))
    g = np.linspace(-1, 1, n)
    x_true = np.exp(-8 * (g - 0.3) ** 2)
    b_true = A @ x_true
    e = rng.standard_normal(n)
    b = b_true + 0.01 * np.linalg.norm(b_true) / np.linalg.norm(e) * e
    return op, A, x_true, b


def _ref_gks_identity_mirror(A, b, projection_dim, n_iter, lam):
    """Literal NumPy mirror of the reference GKS identity-L iteration
    (GKS.py:44-96): SVD of AV, projected Tikhonov in the *rotated*
    coordinates z, then x = V z WITHOUT rotating back by W (the bug at
    :74-76), normal-equations residual expansion with 3x reorth."""
    _, _, Vj = golub_kahan(DenseOperator(jnp.asarray(A)), jnp.asarray(b),
                           projection_dim)
    V = np.asarray(Vj, dtype=float)
    AV = A @ V
    x = None
    for _ in range(n_iter):
        k = V.shape[1]
        Qa, s, Wt = np.linalg.svd(AV, full_matrices=False)
        bproj = Qa.T @ b
        y = np.linalg.lstsq(
            np.vstack([np.diag(s), np.sqrt(lam) * np.eye(k)]),
            np.concatenate([bproj, np.zeros(k)]), rcond=None)[0]
        x = V @ y                                   # <- missing W rotation
        r = A.T @ (AV @ y - b) + lam * (V @ y)      # L = I
        for _ in range(3):
            r = r - V @ (V.T @ r)
        vn = r / np.linalg.norm(r)
        V = np.column_stack([V, vn])
        AV = np.column_stack([AV, A @ vn])
    return x


def test_gks_identity_rotation_deviation():
    """strict_reference=True reproduces the reference's unrotated
    identity-L iterate to roundoff; the default (rotated) fix reconstructs
    while the literal path scrambles (>= 3x the relative error)."""
    op, A, x_true, b = _identity_problem()
    from trips_tpu.core import IdentityOperator

    L = IdentityOperator(len(b))
    lam = 0.05
    x_ref = _ref_gks_identity_mirror(A, b, 3, 6, lam)
    x_strict, _ = GKS(op, b, L, projection_dim=3, n_iter=6, regparam=lam,
                      strict_reference=True)
    np.testing.assert_allclose(np.asarray(x_strict).ravel(), x_ref,
                               rtol=1e-6, atol=1e-9)
    x_fix, _ = GKS(op, b, L, projection_dim=3, n_iter=6, regparam=lam)
    err_fix = np.linalg.norm(np.asarray(x_fix).ravel() - x_true) \
        / np.linalg.norm(x_true)
    err_ref = np.linalg.norm(x_ref - x_true) / np.linalg.norm(x_true)
    assert err_fix < 0.2, err_fix
    assert err_ref > 3 * err_fix, (err_ref, err_fix)


def _ref_analysis_mirror(n, level, l, w):
    """Literal mirror of create_analysis_operator_rec (operators.py:85-99):
    the level == l base case drops the accumulated low-pass ``w``."""
    H0, H1, H2 = construct_filters(level, n)
    if level == l:
        return np.vstack([H0, H1, H2])              # <- ignores w
    W1 = _ref_analysis_mirror(n, level + 1, l, H0)
    stack = np.vstack([W1, H1, H2])
    return stack if np.isscalar(w) else stack @ w


def test_framelet_composition_deviation():
    """l=1: ours is bit-identical to the reference construction. l>=2:
    ours restores the tight frame (||W^T W - I|| ~ 0) while the literal
    reference composition breaks it by O(1)."""
    n = 32
    np.testing.assert_allclose(analysis_matrix(n, 1),
                               _ref_analysis_mirror(n, 1, 1, 1), atol=1e-14)
    for l in (2, 3):
        W_ours = analysis_matrix(n, l)
        gram = W_ours.T @ W_ours
        assert np.abs(gram - np.eye(n)).max() < 1e-12, l
        W_ref = _ref_analysis_mirror(n, 1, l, 1)
        assert W_ref.shape == W_ours.shape
        dev = np.abs(W_ref.T @ W_ref - np.eye(n)).max()
        assert dev > 0.1, dev  # the reference's frame is not tight


def test_laplace_noise_deviation():
    """The reference's Laplace branch draws ONE scalar located at
    n (np.random.laplace(self.grid_points), Deblurring1D.py:213): the
    'noise' is a constant offset. Our fix draws a proper vector with the
    same normalization; delta stays ||added noise||."""
    n = 200
    np.random.seed(3)
    prob = Deblurring1D()
    prob.forward_Op_1D(30, n)
    x = prob.gen_xtrue(n, "curve0")
    b_true = prob.gen_data(x)

    # literal mirror of the reference branch
    np.random.seed(4)
    e_ref = np.random.laplace(n)                    # scalar, mean ~ n
    sig_ref = 0.02 * np.linalg.norm(b_true) / np.linalg.norm(e_ref)
    pert_ref = (b_true + sig_ref * e_ref) - b_true
    assert np.std(pert_ref) < 1e-12                 # constant shift
    assert abs(np.mean(pert_ref)) > 0

    np.random.seed(4)
    b_meas, delta = prob.add_noise(b_true, "Laplace", 0.02)
    pert = np.asarray(b_meas) - np.asarray(b_true)
    assert np.std(pert) > 0                         # actual noise
    np.testing.assert_allclose(np.linalg.norm(pert),
                               0.02 * np.linalg.norm(b_true), rtol=1e-12)
    np.testing.assert_allclose(delta, np.linalg.norm(pert), rtol=1e-12)

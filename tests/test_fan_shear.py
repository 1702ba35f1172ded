"""Shear-rotate fan projector: adjointness, Siddon proximity, recon parity.

Mirrors the validated shear-stack parallel tests (test_shear_projector.py);
the reference oracle is the exact-Siddon fan matrix (ASTRA 'line_fanflat'
equivalent, trips/test_problems/Tomography.py:49-68).
"""
import jax.numpy as jnp
import numpy as np

from trips_tpu.krylov import cgls_history
from trips_tpu.operators.fan_shear import ShearFanProjector
from trips_tpu.problems.projector import fan_beam_matrix


def test_adjoint_exact(rng):
    for nx, views, p in [(32, 8, None), (16, 5, 31), (24, 7, None)]:
        op = ShearFanProjector(nx, views=views, det_count=p)
        x = rng.standard_normal(op.shape[1])
        y = rng.standard_normal(op.shape[0])
        lhs = float(np.asarray(op.matvec(jnp.asarray(x))) @ y)
        rhs = float(x @ np.asarray(op.rmatvec(jnp.asarray(y))))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_close_to_siddon_matrix(rng):
    """Per-view sinograms track the exact-Siddon fan matrix on a smooth
    image: the models differ only by their (pixel-scale) footprints."""
    nx, views = 32, 8
    A = fan_beam_matrix(nx, views=views)
    op = ShearFanProjector(nx, views=views)
    p = op.det_count
    yy, xx = np.mgrid[0:nx, 0:nx]
    x = np.exp(-(((xx - 20.3) ** 2 + (yy - 9.7) ** 2) / 18.0)).reshape(-1)
    ref = (A @ x).reshape(views, p)
    got = np.asarray(op.matvec(jnp.asarray(x))).reshape(views, p)
    for a in range(views):
        corr = ref[a] @ got[a] / (
            np.linalg.norm(ref[a]) * np.linalg.norm(got[a]))
        assert corr > 0.995, (a, corr)
        rel = np.linalg.norm(ref[a] - got[a]) / np.linalg.norm(ref[a])
        assert rel < 0.08, (a, rel)


def test_cgls_reconstruction_parity(rng):
    """Semiconvergence minima match the exact-matrix reconstruction at 2%
    noise (data generated with the Siddon matrix — anti-crime for the shear
    model)."""
    from trips_tpu.core.linop import DenseOperator
    from trips_tpu.problems.phantoms import grains

    nx, views, noise = 64, 20, 0.02
    A = fan_beam_matrix(nx, views=views)
    op = ShearFanProjector(nx, views=views)
    xt = grains(nx, seed=0).reshape(-1)
    b_true = A @ xt
    e = rng.standard_normal(len(b_true))
    e *= noise * np.linalg.norm(b_true) / np.linalg.norm(e)
    b = jnp.asarray(b_true + e)
    Aop = DenseOperator(jnp.asarray(A.toarray()))
    _, _, xs_ref, _ = cgls_history(Aop, b, jnp.zeros(nx * nx), 40, 0.0)
    _, _, xs_sh, _ = cgls_history(op, b, jnp.zeros(nx * nx), 40, 0.0)

    def errs(xs):
        return [float(np.linalg.norm(np.asarray(x) - xt)
                      / np.linalg.norm(xt)) for x in xs]

    e_ref, e_sh = errs(xs_ref), errs(xs_sh)
    assert min(e_sh) < 1.2 * min(e_ref)
    assert abs(int(np.argmin(e_sh)) - int(np.argmin(e_ref))) <= 3


def test_matmat_consistent(rng):
    op = ShearFanProjector(16, views=5)
    X = rng.standard_normal((op.shape[1], 3))
    Y = np.asarray(op.matmat(jnp.asarray(X)))
    for k in range(3):
        np.testing.assert_allclose(
            Y[:, k], np.asarray(op.matvec(jnp.asarray(X[:, k]))), atol=1e-12)


def test_nondefault_geometry(rng):
    """Custom source/detector distances and detector grid still adjoint and
    close to the matching Siddon matrix."""
    nx, views = 24, 6
    kw = dict(det_count=40, det_width=1.1, source_origin=2.5 * nx,
              origin_det=1.5 * nx)
    A = fan_beam_matrix(nx, views=views, **kw)
    op = ShearFanProjector(nx, views=views, **kw)
    x = rng.standard_normal(op.shape[1])
    y = rng.standard_normal(op.shape[0])
    lhs = float(np.asarray(op.matvec(jnp.asarray(x))) @ y)
    rhs = float(x @ np.asarray(op.rmatvec(jnp.asarray(y))))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
    yy, xx = np.mgrid[0:nx, 0:nx]
    sm = np.exp(-(((xx - 14.0) ** 2 + (yy - 8.0) ** 2) / 12.0)).reshape(-1)
    r = A @ sm
    g = np.asarray(op.matvec(jnp.asarray(sm)))
    assert np.linalg.norm(r - g) / np.linalg.norm(r) < 0.08


def test_normal_matvec_fallback_matches_pair(rng):
    """The normal apply cgls_normal uses for this operator is exactly
    rmatvec(matvec(x)); G carries one column per detector, no padding."""
    from trips_tpu.krylov.cgls import _normal_apply

    op = ShearFanProjector(24, views=5)
    x = rng.standard_normal(op.shape[1])
    a = np.asarray(_normal_apply(op)(jnp.asarray(x)))
    b = np.asarray(op.rmatvec(op.matvec(jnp.asarray(x))))
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert op.G.shape[2] == op.det_count

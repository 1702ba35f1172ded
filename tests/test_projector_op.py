"""On-the-fly (matrix-free) projectors vs the stored-matrix oracles."""
import jax.numpy as jnp
import numpy as np

from trips_tpu.operators import OnTheFlyFanProjector, OnTheFlyParallelProjector
from trips_tpu.problems.projector import fan_beam_matrix, parallel_beam_matrix


def test_parallel_joseph_exact(rng):
    for nx, nang in [(32, 12), (17, 7)]:
        angles = np.linspace(0, np.pi, nang, endpoint=False) + 0.0123
        A = parallel_beam_matrix(nx, angles, model="linear")
        op = OnTheFlyParallelProjector(nx, angles)
        x = rng.standard_normal(nx * nx)
        u = rng.standard_normal(A.shape[0])
        np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), A @ x, atol=1e-11)
        np.testing.assert_allclose(np.asarray(op.rmatvec(jnp.asarray(u))), A.T @ u, atol=1e-11)


def test_fan_line_exact(rng):
    nx = 32
    angles = np.linspace(0, np.pi, 12, endpoint=False) + 0.0123
    A = fan_beam_matrix(nx, angles=angles)
    op = OnTheFlyFanProjector(nx, angles=angles, dtype=jnp.float64)
    x = rng.standard_normal(nx * nx)
    u = rng.standard_normal(A.shape[0])
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), A @ x, atol=1e-10)
    np.testing.assert_allclose(np.asarray(op.rmatvec(jnp.asarray(u))), A.T @ u, atol=1e-10)


def test_fan_axis_aligned_angles(rng):
    """Exactly axis-aligned fans (0, pi/2) hit the degenerate-slope paths.
    With an odd detector count (nx=8: p=11) the central ray runs along a
    pixel boundary; it belongs to one pixel, as in the matrix builder."""
    angles = np.array([0.0, np.pi / 2, np.pi / 4])
    for nx in (16, 8):
        A = fan_beam_matrix(nx, angles=angles)
        op = OnTheFlyFanProjector(nx, angles=angles, dtype=jnp.float64)
        x = rng.standard_normal(nx * nx)
        u = rng.standard_normal(A.shape[0])
        np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                                   A @ x, atol=1e-10)
        np.testing.assert_allclose(np.asarray(op.rmatvec(jnp.asarray(u))),
                                   A.T @ u, atol=1e-10)


def test_fan_in_cgls(rng):
    """The on-the-fly operator drives the fused CGLS loop."""
    from trips_tpu.krylov import cgls
    from trips_tpu.problems.phantoms import shepp_logan

    nx = 32
    op = OnTheFlyFanProjector(nx, views=40, dtype=jnp.float64)
    x_true = shepp_logan(nx).reshape(-1)
    b = op.matvec(jnp.asarray(x_true))
    x, k = cgls(op, b, jnp.zeros(nx * nx, jnp.float64), 150, 1e-10)
    err = np.linalg.norm(np.asarray(x) - x_true) / np.linalg.norm(x_true)
    assert err < 0.2

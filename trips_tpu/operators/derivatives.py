"""Derivative regularization operators — structured, matrix-free, jittable.

The reference materializes these as scipy.sparse kron products
(``trips/utilities/operators.py:24-45``); here the same maps are pure
shift/subtract patterns on reshaped images, which XLA fuses into the
surrounding elementwise work — no sparse storage, no gathers.

Conventions match the reference exactly (forward difference with sign
``x_i - x_{i+1}``, from ``L = I - superdiag`` at ``operators.py:24-28``):

- 1D: (n-1, n),   row i: x[i] - x[i+1]
- 2D (square images, reference kron layout ``operators.py:30-36``):
  [ kron(I_n, D_n) ; kron(D_n, I_n) ]  on x = vec(X) with X (n, n) C-order
- spacetime (``operators.py:39-45``):
  [ kron(I_nt, D2d) ; kron(D_nt, I_{nx*ny}) ]

``to_scipy_sparse()`` reproduces the reference's sparse matrices for tests.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.linop import LinearOperator, register_op


def _fwd_diff(x):
    """(n,) -> (n-1,): x[i] - x[i+1]."""
    return x[:-1] - x[1:]


def _fwd_diff_adj(y, n):
    """adjoint of _fwd_diff: (n-1,) -> (n,)."""
    return jnp.concatenate([y, jnp.zeros((1,), y.dtype)]) - jnp.concatenate(
        [jnp.zeros((1,), y.dtype), y]
    )


class FirstDerivative1D(LinearOperator):
    """Reference: gen_first_derivative_operator (operators.py:24-28)."""

    def __init__(self, n):
        self.shape = (n - 1, n)

    def matvec(self, x):
        return _fwd_diff(x)

    def rmatvec(self, y):
        return _fwd_diff_adj(y, self.shape[1])


register_op(FirstDerivative1D, [], ["shape"])


class FirstDerivative2D(LinearOperator):
    """Reference: gen_first_derivative_operator_2D (operators.py:30-36).

    The reference kron layout assumes square images (it builds
    ``kron(I_nx, D_nx)`` over blocks whose length is actually ny); we keep
    the mathematically consistent general form — derivative along each image
    axis — which coincides with the reference for nx == ny (all demo
    configs).

    Row order: [per-row differences (axis 1); per-column differences (axis 0)].
    """

    def __init__(self, nx, ny):
        self.nx, self.ny = nx, ny
        self.shape = (nx * (ny - 1) + (nx - 1) * ny, nx * ny)

    def matvec(self, x):
        X = x.reshape(self.nx, self.ny)
        d1 = X[:, :-1] - X[:, 1:]  # within-row (kron(I, D))
        d0 = X[:-1, :] - X[1:, :]  # across rows (kron(D, I))
        return jnp.concatenate([d1.reshape(-1), d0.reshape(-1)])

    def rmatvec(self, y):
        nx, ny = self.nx, self.ny
        n1 = nx * (ny - 1)
        Y1 = y[:n1].reshape(nx, ny - 1)
        Y0 = y[n1:].reshape(nx - 1, ny)
        z = jnp.zeros((nx, ny), y.dtype)
        z = z.at[:, :-1].add(Y1)
        z = z.at[:, 1:].add(-Y1)
        z = z.at[:-1, :].add(Y0)
        z = z.at[1:, :].add(-Y0)
        return z.reshape(-1)


register_op(FirstDerivative2D, [], ["nx", "ny", "shape"])


class SpaceTimeDerivative(LinearOperator):
    """Anisotropic space+time TV operator for dynamic CT.

    Reference: gen_spacetime_derivative_operator (operators.py:39-45):
    ``[kron(I_nt, D_spatial); kron(D_nt, I_{nx*ny})]``. Here the nt frames
    form a batch axis (vmapped spatial derivative) and the time part is a
    frame-difference — the only cross-frame coupling, which becomes a
    nearest-neighbor halo when the time axis is sharded over the mesh.
    """

    def __init__(self, nx, ny, nt):
        self.nx, self.ny, self.nt = nx, ny, nt
        self.spatial = FirstDerivative2D(nx, ny)
        s = self.spatial.shape[0]
        self.shape = (nt * s + (nt - 1) * nx * ny, nt * nx * ny)

    def matvec(self, x):
        nx, ny, nt = self.nx, self.ny, self.nt
        X = x.reshape(nt, nx * ny)
        sp = jax.vmap(self.spatial.matvec)(X).reshape(-1)
        tm = (X[:-1] - X[1:]).reshape(-1)
        return jnp.concatenate([sp, tm])

    def rmatvec(self, y):
        nx, ny, nt = self.nx, self.ny, self.nt
        s = self.spatial.shape[0]
        Ysp = y[: nt * s].reshape(nt, s)
        Ytm = y[nt * s :].reshape(nt - 1, nx * ny)
        out = jax.vmap(self.spatial.rmatvec)(Ysp)
        out = out.at[:-1].add(Ytm).at[1:].add(-Ytm)
        return out.reshape(-1)


register_op(SpaceTimeDerivative, ["spatial"], ["nx", "ny", "nt", "shape"])


class CenteredSpaceTimeDerivative(LinearOperator):
    """Dynamic TV operator with pylops-style centered stencils.

    Reference: the dynamic isoTV pipeline stacks
    ``spatial_derivative_operator`` (kron(I_t, centered 2D derivative),
    ``operators_old.py:47-52``) over ``time_derivative_operator``
    (kron(centered D_t, I), ``operators_old.py:54-60``) — total shape
    (3*nx*ny*nt, nx*ny*nt). Row layout: frame-major [d/dx; d/dy] blocks,
    then the time block.
    """

    def __init__(self, nx, ny, nt):
        from .weights import CenteredDerivative2D

        self.nx, self.ny, self.nt = nx, ny, nt
        self.spatial = CenteredDerivative2D(nx, ny)
        self.shape = (3 * nx * ny * nt, nx * ny * nt)

    def _time_centered(self, X):
        # X (nt, p): 0.5*(X[t+1] - X[t-1]), zero first/last rows
        out = jnp.zeros_like(X)
        return out.at[1:-1].set(0.5 * (X[2:] - X[:-2]))

    def matvec(self, x):
        nx, ny, nt = self.nx, self.ny, self.nt
        p = nx * ny
        X = x.reshape(nt, p)
        sp = jax.vmap(self.spatial.matvec)(X).reshape(-1)
        tm = self._time_centered(X).reshape(-1)
        return jnp.concatenate([sp, tm])

    def rmatvec(self, y):
        nx, ny, nt = self.nx, self.ny, self.nt
        p = nx * ny
        Ysp = y[: 2 * p * nt].reshape(nt, 2 * p)
        Ytm = y[2 * p * nt :].reshape(nt, p)
        out = jax.vmap(self.spatial.rmatvec)(Ysp)
        out = out.at[2:].add(0.5 * Ytm[1:-1]).at[:-2].add(-0.5 * Ytm[1:-1])
        return out.reshape(-1)


register_op(CenteredSpaceTimeDerivative, ["spatial"], ["nx", "ny", "nt", "shape"])


# -- scipy mirrors for tests / export ------------------------------------

def first_derivative_matrix(n):
    from scipy import sparse

    D = sparse.diags(np.ones(n - 1), offsets=1)
    return (sparse.identity(n) - D).tocsr()[:-1, :]


def first_derivative_2d_matrix(nx, ny):
    from scipy import sparse

    return sparse.vstack(
        [
            sparse.kron(sparse.identity(nx), first_derivative_matrix(ny)),
            sparse.kron(first_derivative_matrix(nx), sparse.identity(ny)),
        ]
    ).tocsr()


def spacetime_derivative_matrix(nx, ny, nt):
    from scipy import sparse

    D2 = first_derivative_2d_matrix(nx, ny)
    return sparse.vstack(
        [
            sparse.kron(sparse.identity(nt), D2),
            sparse.kron(first_derivative_matrix(nt), sparse.identity(nx * ny)),
        ]
    ).tocsr()

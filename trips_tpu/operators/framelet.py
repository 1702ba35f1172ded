"""Piecewise-linear tight-frame (framelet) analysis operator.

Reference: ``trips/utilities/operators.py:50-113`` builds the filter bank
(H0, H1, H2) as sparse banded matrices with reflected boundary corrections,
stacks them recursively over levels, and applies the 2D analysis operator as
``(W_n @ X @ W_m^H).flatten(order='F')`` wrapped in a pylops
FunctionOperator.

W_n ((2l+1)n, n) is materialized densely once — the 2D apply is two dense
matmuls per direction.

Deviation (deliberate): the reference recursion
(``create_analysis_operator_rec``, operators.py:85-99) fails to compose the
deepest level with the accumulated low-pass filter (the ``* w`` factor is
skipped in the ``level == l`` branch), which breaks the tight-frame property
W^T W = I for l >= 2. We compose correctly — [H0_l...H0_1; H1_l H0_{l-1}...;
...; H1_1; H2_1] — which is identical for l = 1 and restores
``W.T @ W == I`` for all levels.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.linop import LinearOperator, register_op


def construct_filters(level, n):
    """Level-``level`` banded filters (reference construct_H, operators.py:50-82)."""
    from scipy import sparse

    l = level
    e = np.ones(n)
    H0 = (
        sparse.spdiags(e, -l, n, n) + sparse.spdiags(2 * e, 0, n, n) + sparse.spdiags(e, l, n, n)
    ).tolil()
    H1 = (sparse.spdiags(-e, -l, n, n) + sparse.spdiags(e, l, n, n)).tolil()
    H2 = (
        sparse.spdiags(-e, -l, n, n) + sparse.spdiags(2 * e, 0, n, n) + sparse.spdiags(-e, l, n, n)
    ).tolil()
    for j in range(l):
        H0[j, l - j - 1] += 1
        H0[-j - 1, -l + j] += 1
        H1[j, l - j - 1] -= 1
        H1[-j - 1, -l + j] += 1
        H2[j, l - j - 1] -= 1
        H2[-j - 1, -l + j] -= 1
    return (
        (H0 / 4).toarray(),
        (H1 * (np.sqrt(2) / 4)).toarray(),
        (H2 / 4).toarray(),
    )


def analysis_matrix(n, l):
    """Stacked multi-level analysis operator W ((2l+1)n, n), tight frame."""
    lowpass = np.eye(n)
    high_rows = []
    for level in range(1, l + 1):
        H0, H1, H2 = construct_filters(level, n)
        high_rows.append(np.vstack([H1 @ lowpass, H2 @ lowpass]))
        lowpass = H0 @ lowpass
    return np.vstack([lowpass] + high_rows[::-1])


class FrameletOperator(LinearOperator):
    """2D framelet analysis operator (reference create_framelet_operator,
    operators.py:102-113): forward (W_n @ X @ W_m^T).vec(F-order),
    adjoint (W_n^T @ Y @ W_m).vec(F-order)."""

    def __init__(self, n, m, l):
        self.n, self.m, self.l = n, m, l
        self.Wn = jnp.asarray(analysis_matrix(n, l))
        self.Wm = jnp.asarray(analysis_matrix(m, l))
        self.shape = (n * (2 * l + 1) * m * (2 * l + 1), n * m)

    def _f_reshape(self, x, rows, cols):
        # numpy reshape(order='F') equivalent
        return x.reshape(cols, rows).T

    def matvec(self, x):
        X = self._f_reshape(x, self.n, self.m)
        Y = self.Wn @ X @ self.Wm.T
        return Y.T.reshape(-1)  # vec in F-order

    def rmatvec(self, y):
        rn = self.n * (2 * self.l + 1)
        rm = self.m * (2 * self.l + 1)
        Y = self._f_reshape(y, rn, rm)
        X = self.Wn.T @ Y @ self.Wm
        return X.T.reshape(-1)

    def matmat(self, X):
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    def rmatmat(self, Y):
        return jax.vmap(self.rmatvec, in_axes=1, out_axes=1)(Y)


register_op(FrameletOperator, ["Wn", "Wm"], ["n", "m", "l", "shape"])

"""Padded ELL sparse operator.

Device replacement for the reference's ``scipy.sparse`` CSR/CSC storage
(e.g. the dynamic-CT matrices loaded at ``trips/utilities/io.py:132-134``).
Rows are padded to a common nonzeros-per-row width so every array is
statically shaped and XLA-friendly; the transpose table is materialized at
construction so the adjoint apply (A^T u, the second big matvec in every
Krylov iteration — see ``trips/utilities/decompositions.py:177-183``) is the
same kernel on swapped tables, per the BASELINE "transpose partition" design.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import round_up
from ..core.linop import LinearOperator, register_op


def _csr_to_ell(A, width_multiple: int = 1):
    """Convert scipy CSR to padded (vals, cols) ELL tables (numpy)."""
    A = A.tocsr()
    A.sum_duplicates()
    m, _ = A.shape
    counts = np.diff(A.indptr)
    w = int(counts.max()) if m else 0
    w = max(round_up(max(w, 1), width_multiple), 1)
    vals = np.zeros((m, w), dtype=A.dtype)
    cols = np.zeros((m, w), dtype=np.int32)
    # vectorized fill: position of each nnz within its row
    ptr = A.indptr
    idx = np.arange(A.nnz) - np.repeat(ptr[:-1], counts)
    rows = np.repeat(np.arange(m), counts)
    vals[rows, idx] = A.data
    cols[rows, idx] = A.indices
    return vals, cols


class EllOperator(LinearOperator):
    """Sparse operator in padded ELL form with a materialized transpose."""

    def __init__(self, vals, cols, vals_t, cols_t, shape, nnz=None):
        self.vals = jnp.asarray(vals)
        self.cols = jnp.asarray(cols)
        self.vals_t = jnp.asarray(vals_t)
        self.cols_t = jnp.asarray(cols_t)
        self.shape = tuple(shape)
        self.nnz = nnz if nnz is not None else int(np.count_nonzero(vals))

    @classmethod
    def from_scipy(cls, A, dtype=None):
        from scipy import sparse as sp

        if dtype is not None and not np.issubdtype(np.dtype(dtype),
                                                   np.floating):
            # a cast to an integer type truncates the weights
            raise ValueError(f"ELL stores exact float values; {dtype} is "
                             "a quantized storage of the BSR or banded "
                             "formats")
        A = sp.csr_matrix(A)
        if dtype is not None:
            A = A.astype(dtype)
        vals, cols = _csr_to_ell(A)
        vals_t, cols_t = _csr_to_ell(A.T.tocsr())
        return cls(vals, cols, vals_t, cols_t, A.shape, nnz=A.nnz)

    @classmethod
    def from_dense(cls, M, dtype=None):
        from scipy import sparse as sp

        return cls.from_scipy(sp.csr_matrix(np.asarray(M)), dtype=dtype)

    def to_scipy(self):
        from scipy import sparse as sp

        m, n = self.shape
        vals = np.asarray(self.vals)
        cols = np.asarray(self.cols)
        rows = np.repeat(np.arange(m), vals.shape[1])
        mask = vals.ravel() != 0
        return sp.csr_matrix(
            (vals.ravel()[mask], (rows[mask], cols.ravel()[mask])), shape=(m, n)
        )

    # -- apply -----------------------------------------------------------
    def matvec(self, x):
        return _ell_matvec(self.vals, self.cols, x)

    def rmatvec(self, y):
        return _ell_matvec(self.vals_t, self.cols_t, y)

    def matmat(self, X):
        return _ell_matmat(self.vals, self.cols, X)

    def rmatmat(self, Y):
        return _ell_matmat(self.vals_t, self.cols_t, Y)


register_op(EllOperator, ["vals", "cols", "vals_t", "cols_t"], ["shape", "nnz"])


def _ell_matvec(vals, cols, x):
    # (m, w) gather of x then row-reduce; one fused XLA gather+FMA.
    return jnp.sum(vals * x[cols], axis=1)


def _ell_matmat(vals, cols, X, slot_chunk: int = 8):
    """y = A @ X for tall-skinny X without materializing (m, w, k).

    Scans over nnz-slot chunks; each step is a (m, c, k) gather + contraction,
    keeping peak memory at m*slot_chunk*k.
    """
    m, w = vals.shape
    k = X.shape[1]
    w_pad = round_up(w, slot_chunk)
    if w_pad != w:
        vals = jnp.pad(vals, ((0, 0), (0, w_pad - w)))
        cols = jnp.pad(cols, ((0, 0), (0, w_pad - w)))
    vals_c = vals.reshape(m, w_pad // slot_chunk, slot_chunk).transpose(1, 0, 2)
    cols_c = cols.reshape(m, w_pad // slot_chunk, slot_chunk).transpose(1, 0, 2)

    def step(acc, vc):
        v, c = vc
        acc = acc + jnp.einsum("mw,mwk->mk", v, X[c])
        return acc, None

    y0 = jnp.zeros((m, k), dtype=jnp.result_type(vals.dtype, X.dtype))
    y, _ = jax.lax.scan(step, y0, (vals_c, cols_c))
    return y

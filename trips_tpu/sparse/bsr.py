"""Block-sparse (BSR) operator with small dense blocks.

Instead of scalar gathers, the matrix is tiled into ``br x bc`` dense blocks
(default 16 x 128 — tomography projectors pack much denser with short-row
blocks) and only nonzero blocks are stored. Every apply is a stream of small
dense contractions, and the nnz/s ceiling is memory bandwidth on the block
stream.

The adjoint apply reuses the *forward* block stream with a transposed
per-block contraction, scatter-accumulated into the output: no
materialized transpose partition is needed on a single device. In
the sharded setting each chip still contracts its local row-partition and
partial sums are psum'd — the BASELINE "transpose partition" collapses to
the same stream.

Replaces the reference's scipy CSR storage + matvec (ASTRA ``OpTomo``
applies, ``trips/test_problems/Tomography.py:73-88``; dynamic CT matrices,
``trips/utilities/io.py:132-134``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.linop import LinearOperator, register_op


def _acc_dtype(a, b):
    """Accumulation dtype: promote inputs, never below float32."""
    d = jnp.promote_types(a, b)
    return jnp.promote_types(d, jnp.float32)


def _block_precision(block_dtype):
    """True-f32 multiplies for f32/f64 blocks; native bf16 passes otherwise
    (HIGHEST would upcast bf16 and forfeit the bandwidth win)."""
    if block_dtype in (jnp.bfloat16, jnp.float16):
        return jax.lax.Precision.DEFAULT
    return jax.lax.Precision.HIGHEST


def _build_bsr(A, br, bc=None):
    """scipy sparse -> (blocks, brow, bcol, block_rowptr, mb, nbk) numpy.

    Vectorized direct construction (scipy's ``tobsr`` expands through COO
    and is ~100x slower at these block sizes).
    """
    bc = bc if bc is not None else br
    coo = A.tocoo()
    m, n = A.shape
    mb = -(-m // br)
    nbk = -(-n // bc)
    bid = (coo.row // br).astype(np.int64) * nbk + coo.col // bc
    uniq = np.unique(bid)
    nb = len(uniq)
    blocks = np.zeros((nb, br, bc), dtype=A.dtype)
    local = np.searchsorted(uniq, bid)
    blocks[local, coo.row % br, coo.col % bc] = coo.data
    brow = (uniq // nbk).astype(np.int32)
    bcol = (uniq % nbk).astype(np.int32)
    counts = np.bincount(brow, minlength=mb)
    rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return blocks, brow, bcol, rowptr, mb, nbk


class BsrOperator(LinearOperator):
    """Row-major block-sparse operator (single stored partition).

    ``block_dtype=jnp.int8`` selects per-block absmax int8 quantization:
    blocks are stored as int8 with one f32 scale per block (HBM stream
    halves again vs bf16; the stream is the bottleneck on the stored-matrix
    path). The apply upcasts each block in-register and folds the scale into
    the per-block result, so accumulation stays f32. Entry-wise error is
    bounded by blockmax/254 (plus the bf16 rounding of the gathered x in
    ``_einsum_blocks``, ~2^-8 relative) — the same ~8-bit mantissa budget as
    bf16, absolute rather than relative.

    The apply is the XLA einsum + segment-sum form.
    """

    def __init__(self, blocks, brow, bcol, rowptr, shape, block_shape, nnz,
                 quant_scale=None):
        self.blocks = jnp.asarray(blocks)
        self.brow = jnp.asarray(brow)
        self.bcol = jnp.asarray(bcol)
        self.rowptr = jnp.asarray(rowptr)
        self.shape = tuple(shape)
        self.block_shape = tuple(block_shape)
        self.nnz = nnz
        self.quant_scale = (None if quant_scale is None
                            else jnp.asarray(quant_scale))

    @classmethod
    def from_scipy(cls, A, bs: int = None, dtype=None, block_dtype=None,
                   block_shape=None):
        from scipy import sparse as sp

        if block_shape is not None:
            br, bc = block_shape
        elif bs is not None:
            br, bc = bs, bs
        else:
            br, bc = 16, 128
        A = sp.csr_matrix(A)
        if dtype is not None:
            A = A.astype(dtype)
        nnz = A.nnz
        blocks, brow, bcol, rowptr, _, _ = _build_bsr(A, br, bc)
        quant_scale = None
        if block_dtype is not None and jnp.dtype(block_dtype) == jnp.int8:
            absmax = np.abs(blocks).max(axis=(1, 2))
            quant_scale = (absmax / 127.0).astype(np.float32)
            safe = np.where(quant_scale > 0, quant_scale, 1.0)
            blocks = np.rint(blocks / safe[:, None, None]).astype(np.int8)
        elif block_dtype is not None:
            blocks = blocks.astype(block_dtype)
        return cls(blocks, brow, bcol, rowptr, A.shape, (br, bc), nnz,
                   quant_scale=quant_scale)

    @property
    def dtype(self):
        """Computation dtype, not storage dtype.

        int8-quantized (and bf16) blocks are storage formats: every apply
        accumulates in f32 and the operator behaves as an f32 linear map.
        Without this override the generic pytree-leaf rule would report int8,
        and ``todense()`` would build an int8 identity / cast the result back
        to int8 — silently zeroing the matrix.
        """
        if self.quant_scale is not None:
            return jnp.dtype(jnp.float32)
        d = jnp.dtype(self.blocks.dtype)
        if d == jnp.bfloat16 or d == jnp.float16:
            return jnp.dtype(jnp.float32)
        return d

    @property
    def stored_density(self):
        """nnz / stored block capacity — the bandwidth utilization factor."""
        br, bc = self.block_shape
        return self.nnz / max(self.blocks.shape[0] * br * bc, 1)

    @property
    def stored_bytes(self):
        """Bytes streamed from HBM per apply: blocks + per-block quant scales."""
        nbytes = self.blocks.size * self.blocks.dtype.itemsize
        if self.quant_scale is not None:
            nbytes += self.quant_scale.size * self.quant_scale.dtype.itemsize
        return nbytes

    def _einsum_blocks(self, spec, gathered, acc):
        """Per-block contraction; int8-quantized blocks upcast in-register
        and fold the per-block scale into the (small) result."""
        blocks = self.blocks
        if self.quant_scale is not None:
            blocks = blocks.astype(jnp.bfloat16)
            gathered = gathered.astype(jnp.bfloat16)
            prod = jnp.einsum(spec, blocks, gathered,
                              preferred_element_type=acc,
                              precision=jax.lax.Precision.DEFAULT)
            scale = self.quant_scale.astype(acc)
            return prod * scale.reshape((-1,) + (1,) * (prod.ndim - 1))
        return jnp.einsum(spec, blocks, gathered,
                          preferred_element_type=acc,
                          precision=_block_precision(blocks.dtype))

    def _apply(self, x, transpose):
        br, bc = self.block_shape
        m_out = self.shape[1] if transpose else self.shape[0]
        acc = _acc_dtype(
            x.dtype if self.quant_scale is not None else self.blocks.dtype,
            x.dtype)
        if transpose:
            xp = jnp.pad(x, (0, (-x.shape[0]) % br))
            xb = xp.reshape(-1, br)
            prod = self._einsum_blocks("nij,ni->nj", xb[self.brow], acc)
            seg, width = self.bcol, bc
        else:
            xp = jnp.pad(x, (0, (-x.shape[0]) % bc))
            xb = xp.reshape(-1, bc)
            prod = self._einsum_blocks("nij,nj->ni", xb[self.bcol], acc)
            seg, width = self.brow, br
        nb_out = -(-m_out // width)
        y = jax.ops.segment_sum(prod, seg, num_segments=nb_out)
        # never downcast the f32 accumulator to an integer input dtype
        out_dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else acc
        return y.reshape(-1)[:m_out].astype(out_dtype)

    def _apply_mat(self, X, transpose):
        br, bc = self.block_shape
        m_out = self.shape[1] if transpose else self.shape[0]
        acc = _acc_dtype(
            X.dtype if self.quant_scale is not None else self.blocks.dtype,
            X.dtype)
        k = X.shape[1]
        if transpose:
            Xp = jnp.pad(X, ((0, (-X.shape[0]) % br), (0, 0)))
            Xb = Xp.reshape(-1, br, k)
            prod = self._einsum_blocks("nij,nik->njk", Xb[self.brow], acc)
            seg, width = self.bcol, bc
        else:
            Xp = jnp.pad(X, ((0, (-X.shape[0]) % bc), (0, 0)))
            Xb = Xp.reshape(-1, bc, k)
            prod = self._einsum_blocks("nij,njk->nik", Xb[self.bcol], acc)
            seg, width = self.brow, br
        nb_out = -(-m_out // width)
        Y = jax.ops.segment_sum(prod, seg, num_segments=nb_out)
        out_dtype = X.dtype if jnp.issubdtype(X.dtype, jnp.floating) else acc
        return Y.reshape(-1, k)[:m_out].astype(out_dtype)

    # -- public applies ---------------------------------------------------
    def matvec(self, x):
        return self._apply(x, transpose=False)

    def rmatvec(self, y):
        return self._apply(y, transpose=True)

    def matmat(self, X):
        return self._apply_mat(X, transpose=False)

    def rmatmat(self, Y):
        return self._apply_mat(Y, transpose=True)


register_op(
    BsrOperator,
    ["blocks", "brow", "bcol", "rowptr", "quant_scale"],
    ["shape", "block_shape", "nnz"],
)

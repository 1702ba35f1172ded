"""Blur (deconvolution) forward operators.

Reference semantics:
- 1D: ``scipy.ndimage.convolve1d(x, PSF, mode=bc)`` with a *full-length*
  Gaussian/defocus PSF (``trips/test_problems/Deblurring1D.py:51-82``);
  adjoint applies the reversed PSF.
- 2D: ``scipy.ndimage.convolve(X, PSF, mode='reflect')`` with a small
  Gaussian PSF (``trips/test_problems/Deblurring2D.py:48-73``); adjoint
  applies the 180-degree-flipped PSF under the same boundary condition.

Implementations:
- 1D: the PSF is full-length, so the operator is materialized once as an
  (n, n) dense matrix (exact scipy semantics by construction) — a single
  matmul per apply.
- 2D: symmetric-pad + ``lax.conv_general_dilated`` (correlation with the
  flipped kernel == convolution), matching scipy's 'reflect' (a.k.a.
  symmetric) boundary and even-kernel centering; verified against scipy in
  tests.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.linop import DenseOperator, LinearOperator, register_op


# -- PSFs ---------------------------------------------------------------

def gauss_psf_1d(n, parameter):
    """Reference Gauss1D (Deblurring1D.py:63-69): full-length normalized."""
    x = np.arange(-np.fix(n / 2), np.ceil(n / 2))
    psf = np.exp(-0.5 * (x**2) / (parameter**2))
    psf /= psf.sum()
    center = int(np.argmax(psf))
    return psf, center


def defocus_psf_1d(n, parameter):
    """Reference Defocus1D (Deblurring1D.py:70-82)."""
    center = int(np.fix(n / 2))
    if parameter == 0:
        psf = np.zeros(n)
        psf[center] = 1.0
    else:
        psf = np.ones(n) / (np.pi * parameter**2)
        mask = (np.arange(1, n + 1) - center) ** 2 > parameter**2
        psf[mask] = 0
        psf = psf / psf.sum()
    return psf, center


def gauss_psf_2d(dim, spread):
    """Reference Gauss (Deblurring2D.py:48-64)."""
    m, n = dim
    s1, s2 = (spread, spread) if np.isscalar(spread) else (spread[0], spread[1])
    x = np.arange(-np.fix(n / 2), np.ceil(n / 2))
    y = np.arange(-np.fix(m / 2), np.ceil(m / 2))
    X, Y = np.meshgrid(x, y)
    psf = np.exp(-0.5 * ((X**2) / (s1**2) + (Y**2) / (s2**2)))
    psf /= psf.sum()
    mm, nn = np.where(psf == psf.max())
    return psf, np.array([mm[0], nn[0]], dtype=int)


# -- 1D blur ------------------------------------------------------------

def _convolve1d_matrix(psf, n, mode):
    """Materialize scipy.ndimage.convolve1d(·, psf, mode) as a dense matrix."""
    from scipy.ndimage import convolve1d

    M = convolve1d(np.eye(n), psf, mode=mode, axis=0)
    # columns of M are convolve1d(e_j); operator acts as M.T? convolve1d is
    # linear in its input, applied axis=0 column-by-column: M[:, j] = A e_j,
    # so M itself is the matrix.
    return M


class Blur1D(DenseOperator):
    """Reference forward_Op_1D (Deblurring1D.py:93-102), materialized densely.

    The reference's adjoint is convolution with the reversed PSF
    (Deblurring1D.py:59-62), which for full-length PSFs is not the exact
    transpose of the forward matrix under boundary handling; we mirror the
    reference by materializing both applications.
    """

    def __init__(self, n, parameter=None, boundary_condition="reflect", psf=None):
        if psf is None:
            psf, _ = gauss_psf_1d(n, parameter)
        self.psf = np.asarray(psf)
        self.boundary_condition = boundary_condition
        fwd = _convolve1d_matrix(self.psf, n, boundary_condition)
        super().__init__(jnp.asarray(fwd))
        self._adj = jnp.asarray(_convolve1d_matrix(self.psf[::-1], n, boundary_condition))

    def rmatvec(self, y):
        return self._adj @ y

    def rmatmat(self, Y):
        return self._adj @ Y


def _blur1d_flatten(op):
    return (op.mat, op._adj), (op.shape, op.boundary_condition, tuple(op.psf))


def _blur1d_unflatten(aux, children):
    op = object.__new__(Blur1D)
    op.mat, op._adj = children
    op.shape, op.boundary_condition, psf = aux
    op.psf = np.asarray(psf)
    return op


jax.tree_util.register_pytree_node(Blur1D, _blur1d_flatten, _blur1d_unflatten)


# -- 2D blur ------------------------------------------------------------

def _conv2d_reflect(X, psf):
    """scipy.ndimage.convolve(X, psf, mode='reflect') in XLA.

    scipy's convolve flips the kernel and centers it at
    ((p-1)//2, (q-1)//2) of the *flipped* kernel... equivalently the output
    at pixel i uses inputs i - j + c with c = p // 2 for even sizes.
    Implemented as symmetric pad + VALID correlation with the flipped
    kernel; the pad split encodes the centering (verified vs scipy).
    """
    p, q = psf.shape
    # scipy.ndimage.convolve: origin=0 means output o = sum_j I[o + c - j] W[j]
    # with c = p//2. Correlation with flipped W: o = sum_k I[o + k - (p-1-c)] Wf[k]
    lo0, hi0 = p - 1 - p // 2, p // 2
    lo1, hi1 = q - 1 - q // 2, q // 2
    Xp = jnp.pad(X, ((lo0, hi0), (lo1, hi1)), mode="symmetric")
    out = jax.lax.conv_general_dilated(
        Xp[None, None, :, :],
        jnp.flip(psf, (0, 1))[None, None, :, :],
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return out[0, 0]


class Blur2D(LinearOperator):
    """Reference forward_Op (Deblurring2D.py:66-73)."""

    def __init__(self, dim, spread, nx, ny, psf=None):
        if psf is None:
            psf, _ = gauss_psf_2d(dim, spread)
        self.psf = jnp.asarray(psf)
        self.nx, self.ny = nx, ny
        self.shape = (nx * ny, nx * ny)

    def matvec(self, x):
        X = x.reshape(self.nx, self.ny)
        return _conv2d_reflect(X, self.psf).reshape(-1)

    def rmatvec(self, y):
        Y = y.reshape(self.nx, self.ny)
        return _conv2d_reflect(Y, jnp.flip(self.psf, (0, 1))).reshape(-1)

    def matmat(self, X):
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    def rmatmat(self, Y):
        return jax.vmap(self.rmatvec, in_axes=1, out_axes=1)(Y)


register_op(Blur2D, ["psf"], ["nx", "ny", "shape"])

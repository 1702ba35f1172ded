"""Golub-Kahan bidiagonalization — fused device loop.

Reference semantics: ``trips/utilities/decompositions.py:118-205`` (batch) and
``:230-255`` (incremental update used by Hybrid LSQR). The reference grows
U/V/alphas/betas with ``np.pad`` per iteration; here bases are preallocated at
``n_iter`` width and written via dynamic-update-slice inside a ``lax.fori_loop``
so the whole factorization is one XLA computation: per iteration exactly one
``A^T u`` and one ``A v`` (the hot SpMVs), plus two norms.

Returns the same (U, S, V) triplet: U (m, k+1), S (k+1, k) lower-bidiagonal,
V (n, k). There is no reorthogonalization, matching the reference.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("n_iter", "reorth"))
def golub_kahan(A, b, n_iter: int, reorth: bool = False):
    """reorth=True adds one full classical Gram-Schmidt reorthogonalization
    per step (not in the reference — its GK loses orthogonality once Ritz
    values converge, which silently corrupts DP/out-of-subspace estimates in
    the hybrid solvers; see decompositions.py:118-205)."""
    m, n = A.shape
    b = jnp.reshape(b, (-1,))
    dtype = b.dtype

    U = jnp.zeros((m, n_iter + 1), dtype)
    V = jnp.zeros((n, n_iter), dtype)
    alphas = jnp.zeros((n_iter,), dtype)
    betas = jnp.zeros((n_iter,), dtype)

    U = U.at[:, 0].set(b / jnp.linalg.norm(b))

    def body(k, carry):
        U, V, alphas, betas = carry
        u_k = jax.lax.dynamic_slice_in_dim(U, k, 1, axis=1)[:, 0]
        v_prev = jnp.where(
            k > 0,
            jax.lax.dynamic_slice_in_dim(V, jnp.maximum(k - 1, 0), 1, axis=1)[:, 0],
            jnp.zeros((n,), dtype),
        )
        beta_prev = jnp.where(k > 0, betas[jnp.maximum(k - 1, 0)], 0.0)

        v = A.rmatvec(u_k) - beta_prev * v_prev
        if reorth:
            # unused columns of V are zero, so the full product is safe
            v = v - V @ (V.T @ v)
        alpha = jnp.linalg.norm(v)
        v = v / alpha

        u = A.matvec(v) - alpha * u_k
        if reorth:
            u = u - U @ (U.T @ u)
        beta = jnp.linalg.norm(u)
        u = u / beta

        U = jax.lax.dynamic_update_slice_in_dim(U, u[:, None], k + 1, axis=1)
        V = jax.lax.dynamic_update_slice_in_dim(V, v[:, None], k, axis=1)
        alphas = alphas.at[k].set(alpha)
        betas = betas.at[k].set(beta)
        return (U, V, alphas, betas)

    U, V, alphas, betas = jax.lax.fori_loop(0, n_iter, body, (U, V, alphas, betas), unroll=4)

    S = jnp.zeros((n_iter + 1, n_iter), dtype)
    ar = jnp.arange(n_iter)
    S = S.at[ar, ar].set(alphas)
    S = S.at[ar + 1, ar].set(betas)
    return U, S, V


def gk_init(A, b, n_iter: int):
    """Preallocated GK state for ``golub_kahan_extend``: padded (U, V,
    alphas, betas) with only U[:, 0] = b/||b|| filled."""
    m, n = A.shape
    b = jnp.reshape(b, (-1,))
    dtype = b.dtype
    U = jnp.zeros((m, n_iter + 1), dtype).at[:, 0].set(
        b / jnp.linalg.norm(b))
    V = jnp.zeros((n, n_iter), dtype)
    return U, V, jnp.zeros((n_iter,), dtype), jnp.zeros((n_iter,), dtype)


@partial(jax.jit, static_argnames=("reorth",))
def golub_kahan_extend(A, U, V, alphas, betas, k0, n_steps,
                       reorth: bool = False):
    """Resume the fused GK factorization at step ``k0`` for ``n_steps``
    more steps (both traced — one compilation covers every chunk).

    This is the matvec-economy primitive for Hybrid LSQR's dp_stop
   : the reference factorizes incrementally and stops
    at the DP iteration (Hybrid_LSQR.py:85-93), paying 2 matvecs per
    completed step only; chunked extension reproduces that O(k) cost with
    O(k / chunk) device dispatches instead of O(k) host round-trips.
    """
    m, n = U.shape[0], V.shape[0]
    dtype = U.dtype

    def body(k, carry):
        U, V, alphas, betas = carry
        u_k = jax.lax.dynamic_slice_in_dim(U, k, 1, axis=1)[:, 0]
        v_prev = jnp.where(
            k > 0,
            jax.lax.dynamic_slice_in_dim(
                V, jnp.maximum(k - 1, 0), 1, axis=1)[:, 0],
            jnp.zeros((n,), dtype),
        )
        beta_prev = jnp.where(k > 0, betas[jnp.maximum(k - 1, 0)], 0.0)
        v = A.rmatvec(u_k) - beta_prev * v_prev
        if reorth:
            v = v - V @ (V.T @ v)
        alpha = jnp.linalg.norm(v)
        v = v / alpha
        u = A.matvec(v) - alpha * u_k
        if reorth:
            u = u - U @ (U.T @ u)
        beta = jnp.linalg.norm(u)
        u = u / beta
        U = jax.lax.dynamic_update_slice_in_dim(U, u[:, None], k + 1, axis=1)
        V = jax.lax.dynamic_update_slice_in_dim(V, v[:, None], k, axis=1)
        alphas = alphas.at[k].set(alpha)
        betas = betas.at[k].set(beta)
        return (U, V, alphas, betas)

    return jax.lax.fori_loop(k0, k0 + n_steps, body,
                             (U, V, alphas, betas))

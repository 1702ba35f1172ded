"""Reference-parity ``(x, info)`` adapters for the fused solvers.

The fused solvers return bare ``(x, lambda_history[, residual_history])``
tuples; the reference's solvers return ``(x, info)`` with ``xHistory``,
``regParam``, ``regParam_history``, ``relError``, ``Residual``, ``its``
(``trips/solvers/GKS.py:97-105``, ``Hybrid_LSQR.py:108-113``). These
wrappers scan the SAME fused device bodies (identical trajectories — the
loop is ``lax.scan`` instead of ``lax.fori_loop``, stacking the iterate),
so the README migration table's device path is drop-in: one device program,
no host round-trips, reference info keys.

``x_true`` (optional) adds the per-iteration ``relError`` history computed
on device, mirroring the reference's quality telemetry
(``CGLS.py:78-81``-style)."""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .fused import (
    _gks_body,
    _gks_init,
    _hybrid_gmres_parts,
    _hybrid_lsqr_parts,
    _mmgks_body,
    _mmgks_init,
    _mmgks_regularizer,
    _resolve_mode,
)


def _scan_history(body, init, start, n_iter, x_of):
    def step(carry, ii):
        carry = body(ii, carry)
        return carry, x_of(carry)

    carry, xh = jax.lax.scan(step, init, jnp.arange(start, n_iter))
    return carry, xh


def _info(xh, lams, resids, b, n_done, x_true, rel_residual=False):
    """``Residual`` carries each solver's REFERENCE meaning: for
    GKS/MMGKS the reorthogonalized normal-equations gradient norm
    (``trips/solvers/GKS.py:85-88``), for the hybrids the projected
    ``||A x - b||``. ``relResidual`` (hybrids only, where Residual is a
    true data residual) divides by ``||b||``. All histories are aligned
    per performed solve: index i of every array belongs to the same
    iteration."""
    info = {
        "xHistory": xh,
        "regParam": lams[-1],
        "regParam_history": lams,
        "Residual": resids,
        "its": n_done,
    }
    if rel_residual:
        info["relResidual"] = resids / jnp.linalg.norm(
            jnp.reshape(b, (-1,)))
    if x_true is not None:
        xt = jnp.reshape(x_true, (-1,))
        info["relError"] = (jnp.linalg.norm(xh - xt[None, :], axis=1)
                            / jnp.linalg.norm(xt))
    return info


@partial(jax.jit, static_argnames=("projection_dim", "n_iter",
                                   "regparam_mode"))
def fused_gks_info(A, b, L, projection_dim=3, n_iter=20, regparam=1.0,
                   regparam_mode="gcv", delta=0.0, eta=1.01, x_true=None):
    """:func:`~trips_tpu.solvers.fused.fused_gks` with reference info."""
    mode = _resolve_mode(regparam_mode, None)
    K = projection_dim + n_iter
    body = _gks_body(A, b, L, mode, regparam, delta, eta, projection_dim,
                     K)
    carry, xh = _scan_history(
        body, _gks_init(A, b, L, projection_dim, n_iter), 0, n_iter,
        lambda c: c[3])
    return carry[3], _info(xh, carry[4], carry[5], b, n_iter, x_true)


@partial(jax.jit, static_argnames=("projection_dim", "n_iter",
                                   "regparam_mode", "weight_mode",
                                   "prob_dims"))
def fused_mmgks_info(A, b, L, pnorm=2.0, qnorm=1.0, epsilon=0.1,
                     projection_dim=3, n_iter=20, regparam=1.0,
                     regparam_mode="gcv", delta=0.0, eta=1.01,
                     weight_mode="holder", prob_dims=None, x_true=None):
    """:func:`~trips_tpu.solvers.fused.fused_mmgks` with reference info."""
    mode = _resolve_mode(regparam_mode, None)
    L = _mmgks_regularizer(L, weight_mode, prob_dims)
    K = projection_dim + n_iter
    body = _mmgks_body(A, b, L, mode, pnorm, qnorm, epsilon, regparam,
                       delta, eta, weight_mode, prob_dims, projection_dim,
                       K)
    carry, xh = _scan_history(
        body, _mmgks_init(A, b, L, projection_dim, n_iter), 0, n_iter,
        lambda c: c[3])
    return carry[3], _info(xh, carry[4], carry[5], b, n_iter, x_true)


@partial(jax.jit, static_argnames=("n_iter", "reorth", "regparam_mode"))
def fused_hybrid_lsqr_info(A, b, n_iter=50, regparam=1.0, reorth=False,
                           regparam_mode="gcv", delta=0.0, eta=1.01,
                           x_true=None):
    """:func:`~trips_tpu.solvers.fused.fused_hybrid_lsqr` with reference
    info. ``xHistory`` has one row per solve (the reference's first solve
    happens at iteration 1, Hybrid_LSQR.py:77-78)."""
    mode = _resolve_mode(regparam_mode, None)
    body, init, start = _hybrid_lsqr_parts(A, b, n_iter, mode, regparam,
                                           delta, eta, reorth)
    carry, xh = _scan_history(body, init, start, n_iter, lambda c: c[0])
    # slice off the never-written leading entries so every history index
    # refers to the same performed solve
    lams, resids = carry[1][start:], carry[2][start:]
    return carry[0], _info(xh, lams, resids, b, n_iter - start, x_true,
                           rel_residual=True)


@partial(jax.jit, static_argnames=("n_iter", "reorth", "regparam_mode"))
def fused_hybrid_gmres_info(A, b, n_iter=50, regparam=1.0, reorth=False,
                            regparam_mode="gcv", delta=0.0, eta=1.01,
                            x_true=None):
    """:func:`~trips_tpu.solvers.fused.fused_hybrid_gmres` with reference
    info."""
    mode = _resolve_mode(regparam_mode, None)
    body, init, start = _hybrid_gmres_parts(A, b, n_iter, mode, regparam,
                                            delta, eta, reorth)
    carry, xh = _scan_history(body, init, start, n_iter, lambda c: c[0])
    return carry[0], _info(xh, carry[1][start:], carry[2][start:], b,
                           n_iter - start, x_true, rel_residual=True)

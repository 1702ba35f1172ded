"""Checkpointable fused solver loops.

The fused solvers (``fused.py``) run all ``n_iter`` iterations in one XLA
program — a 100-iteration STEMPO-scale solve that dies restarts from zero.
These drivers run the SAME traced iteration body in chunks of ``chunk``
iterations (the ``golub_kahan_extend`` pattern generalized): the state
pytree surfaces between chunks, a :class:`~trips_tpu.utils.checkpoint.
CheckpointCallback` persists it, and ``resume_state`` restarts from the
last checkpoint reproducing the uninterrupted run bit-for-bit (the chunked
program is identical for every chunk, so the op sequence — hence f32
rounding — is unchanged; pinned by tests/test_checkpoint_fused.py).

The reference has no checkpointing at all (SURVEY.md §5.4); this exists for
long multi-device runs.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..utils.checkpoint import load_state
from .fused import (_fused_gks_chunk, _fused_mmgks_chunk, _gks_init,
                    _mmgks_init, _mmgks_regularizer)

_GKS_FIELDS = ("V", "AV", "LV", "x", "lams", "resids")


def _carry_to_state(carry, ii):
    state = {k: np.asarray(v) for k, v in zip(_GKS_FIELDS, carry)}
    state["ii"] = int(ii)
    return state


def _state_to_carry(state):
    return tuple(jnp.asarray(state[k]) for k in _GKS_FIELDS), int(
        state["ii"])


def _run_chunked(chunk_fn, init_fn, n_iter, chunk, callback, resume_state):
    if resume_state is not None:
        if isinstance(resume_state, str):
            resume_state = load_state(resume_state)
        carry, start = _state_to_carry(resume_state)
    else:
        carry, start = init_fn(), 0
    ii = start
    while ii < n_iter:
        c = min(chunk, n_iter - ii)
        carry = chunk_fn(carry, jnp.asarray(ii, jnp.int32), c)
        ii += c
        if callback is not None:
            callback(ii, **_carry_to_state(carry, ii))
    return carry


def fused_gks_checkpointed(A, b, L, projection_dim=3, n_iter=20,
                           regparam=1.0, regparam_mode="gcv", delta=0.0,
                           eta=1.01, chunk=10, callback=None,
                           resume_state=None):
    """Chunked :func:`~trips_tpu.solvers.fused.fused_gks`. ``callback(it,
    **state)`` fires after every chunk (pass a ``CheckpointCallback`` with
    ``every=1`` to persist each chunk); ``resume_state`` is a state dict or
    an ``.npz`` path from a previous run. Returns (x, lams, resids)."""
    carry = _run_chunked(
        lambda carry, i0, c: _fused_gks_chunk(
            A, b, L, carry, i0, c, projection_dim=projection_dim,
            n_iter=n_iter, regparam=regparam, regparam_mode=regparam_mode,
            delta=delta, eta=eta),
        lambda: _gks_init(A, b, L, projection_dim, n_iter),
        n_iter, chunk, callback, resume_state)
    return carry[3], carry[4], carry[5]


def fused_mmgks_checkpointed(A, b, L, pnorm=2.0, qnorm=1.0, epsilon=0.1,
                             projection_dim=3, n_iter=20, regparam=1.0,
                             regparam_mode="gcv", delta=0.0, eta=1.01,
                             weight_mode="holder", prob_dims=None,
                             chunk=10, callback=None, resume_state=None):
    """Chunked :func:`~trips_tpu.solvers.fused.fused_mmgks` (all weight
    modes, incl. isoTV/GS dynamic). Returns (x, lams, resids)."""
    Lr = _mmgks_regularizer(L, weight_mode, prob_dims)
    carry = _run_chunked(
        lambda carry, i0, c: _fused_mmgks_chunk(
            A, b, L, carry, i0, c, pnorm=pnorm, qnorm=qnorm,
            epsilon=epsilon, projection_dim=projection_dim, n_iter=n_iter,
            regparam=regparam, regparam_mode=regparam_mode, delta=delta,
            eta=eta, weight_mode=weight_mode, prob_dims=prob_dims),
        lambda: _mmgks_init(A, b, Lr, projection_dim, n_iter),
        n_iter, chunk, callback, resume_state)
    return carry[3], carry[4], carry[5]


_CGN_FIELDS = ("x", "t", "p", "gamma", "norms_t0", "k", "done")


def cgls_normal_checkpointed(A, b, x0, max_iter, tol=0.0, chunk=25,
                             callback=None, resume_state=None):
    """Chunked :func:`~trips_tpu.krylov.cgls_normal`: runs the identical
    CG-on-normal-equations recurrence ``chunk`` iterations per program,
    surfacing the :class:`CGNState` between chunks. Returns (x, k)."""
    from ..krylov.cgls import CGNState, _cgn_chunk, _cgn_init

    if resume_state is not None:
        if isinstance(resume_state, str):
            resume_state = load_state(resume_state)
        s = CGNState(**{k: jnp.asarray(resume_state[k])
                        for k in _CGN_FIELDS})
    else:
        s = _cgn_init(A, b, jnp.reshape(x0, (-1,)))
    while int(s.k) < max_iter and not bool(s.done):
        k_end = min(int(s.k) + chunk, max_iter)
        s = _cgn_chunk(A, tol, s, jnp.asarray(k_end, jnp.int32))
        if callback is not None:
            state = {f: np.asarray(getattr(s, f)) for f in _CGN_FIELDS}
            callback(int(s.k), **state)
    return s.x, s.k

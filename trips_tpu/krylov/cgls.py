"""CGLS — conjugate gradient on the normal equations, fused device loop.

Mirrors the recurrence and stopping rule of the reference
(``trips/solvers/CGLS.py:16-86``): per iteration one ``A p`` and one
``A^T r`` (the hot SpMVs), scalar recurrences, stop when
``||A^T r|| <= tol * ||A^T r_0||`` or ``tol * ||x|| >= 1`` or k == max_iter.

The whole loop runs on device in a single ``lax.while_loop``; the scalar dot
products become ``psum``s under ``shard_map`` when the operator is sharded.
History is not accumulated inside the fused loop (the reference keeps a full
``xHistory``); the solver wrapper offers a scanned variant that records
per-iteration solutions when requested.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class CGLSState(NamedTuple):
    x: jax.Array
    r: jax.Array
    p: jax.Array
    gamma: jax.Array
    norms_t0: jax.Array
    xmax: jax.Array
    k: jax.Array
    done: jax.Array


def _init(A, b, x0):
    x = jnp.reshape(x0, (-1,))
    b = jnp.reshape(b, (-1,))
    r = b - A.matvec(x)
    t = A.rmatvec(r)
    norms_t0 = jnp.linalg.norm(t)
    return CGLSState(
        x=x,
        r=r,
        p=t,
        gamma=norms_t0**2,
        norms_t0=norms_t0,
        xmax=jnp.linalg.norm(x),
        k=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), jnp.bool_),
    )


def _step(A, tol, s: CGLSState) -> CGLSState:
    w = A.matvec(s.p)
    delta = jnp.linalg.norm(w) ** 2
    delta = jnp.where(delta == 0, jnp.finfo(s.x.dtype).eps, delta)
    beta = s.gamma / delta
    x = s.x + beta * s.p
    r = s.r - beta * w
    t = A.rmatvec(r)
    norm_t = jnp.linalg.norm(t)
    gamma = norm_t**2
    p = t + (gamma / s.gamma) * s.p
    norm_x = jnp.linalg.norm(x)
    done = jnp.logical_or(norm_t <= s.norms_t0 * tol, norm_x * tol >= 1)
    return CGLSState(
        x=x,
        r=r,
        p=p,
        gamma=gamma,
        norms_t0=s.norms_t0,
        xmax=jnp.maximum(s.xmax, norm_x),
        k=s.k + 1,
        done=done,
    )


@partial(jax.jit, static_argnames=("max_iter",))
def cgls(A, b, x0, max_iter: int, tol):
    """Fused CGLS; returns (x, k_iterations)."""
    s0 = _init(A, b, x0)

    def cond(s):
        return jnp.logical_and(s.k < max_iter, jnp.logical_not(s.done))

    s = jax.lax.while_loop(cond, lambda s: _step(A, tol, s), s0)
    return s.x, s.k


@partial(jax.jit, static_argnames=("iters",))
def cgls_fixed(A, b, x0, iters: int):
    """Fixed-iteration CGLS as an unrolled scan (no stopping test).

    On remote/pipelined backends the data-dependent ``while_loop`` pays a
    per-iteration scheduling cost; a scan with ``unroll=4`` runs ~2x faster
    for the same recurrence (bit-identical iterates). Use when the iteration
    count is predetermined (benchmarks, fixed-budget solves).
    """
    s0 = _init(A, b, x0)

    def f(s, _):
        return _step(A, 0.0, s), None

    s, _ = jax.lax.scan(f, s0, None, length=iters, unroll=4)
    return s.x, s.k


class CGNState(NamedTuple):
    x: jax.Array
    t: jax.Array
    p: jax.Array
    gamma: jax.Array
    norms_t0: jax.Array
    k: jax.Array
    done: jax.Array


def _normal_apply(A):
    if hasattr(A, "normal_matvec"):
        return A.normal_matvec
    return lambda v: A.rmatvec(A.matvec(v))


def _cgn_init(A, b, x0):
    x = jnp.reshape(x0, (-1,))
    b = jnp.reshape(b, (-1,))
    t = A.rmatvec(b) - _normal_apply(A)(x)
    norms_t0 = jnp.linalg.norm(t)
    return CGNState(x=x, t=t, p=t, gamma=norms_t0**2, norms_t0=norms_t0,
                    k=jnp.zeros((), jnp.int32),
                    done=jnp.zeros((), jnp.bool_))


def _cgn_step(A, tol, s: CGNState) -> CGNState:
    q = _normal_apply(A)(s.p)
    delta = jnp.vdot(s.p, q)
    # delta == p.(A^T A p) is >= 0 in exact arithmetic, but a quantized
    # (bf16) fused normal apply can round it to a small negative near
    # convergence; a negative delta would flip the step sign and stall or
    # diverge the iteration, so treat it as converged instead.
    bad = delta <= 0
    delta = jnp.where(bad, jnp.finfo(s.x.dtype).eps, delta)
    beta = jnp.where(bad, 0.0, s.gamma / delta)
    x = s.x + beta * s.p
    t = s.t - beta * q
    norm_t = jnp.linalg.norm(t)
    gamma = norm_t**2
    p = t + (gamma / s.gamma) * s.p
    done = jnp.logical_or(norm_t <= s.norms_t0 * tol, bad)
    return CGNState(x=x, t=t, p=p, gamma=gamma, norms_t0=s.norms_t0,
                    k=s.k + 1, done=done)


@partial(jax.jit, static_argnames=("max_iter",))
def cgls_normal(A, b, x0, max_iter: int, tol=0.0):
    """CG on the normal equations A^T A x = A^T b with a *fused* normal
    apply: one ``A.normal_matvec`` per iteration instead of separate
    ``A p`` and ``A^T r``. Mathematically the same iterates as ``cgls``
    (identical Krylov recurrence; ``delta = p.(A^T A p) == ||Ap||^2``);
    numerically they differ only in f32 roundoff.

    Operators exposing ``normal_matvec`` (e.g. ``BatchedBlockDiagOperator``)
    use it; others fall back to ``rmatvec(matvec(p))``. Returns (x, k)."""
    s0 = _cgn_init(A, b, x0)

    def cond(s):
        return jnp.logical_and(s.k < max_iter, jnp.logical_not(s.done))

    s = jax.lax.while_loop(cond, lambda s: _cgn_step(A, tol, s), s0)
    return s.x, s.k


@jax.jit
def _cgn_chunk(A, tol, s: CGNState, k_end) -> CGNState:
    """Run the cgls_normal recurrence up to iteration ``k_end`` (traced):
    the chunked-execution primitive behind
    ``solvers.checkpointed.cgls_normal_checkpointed`` — identical body ops
    to ``cgls_normal``, so chunking does not change f32 rounding."""

    def cond(s):
        return jnp.logical_and(s.k < k_end, jnp.logical_not(s.done))

    return jax.lax.while_loop(cond, lambda s: _cgn_step(A, tol, s), s)


@partial(jax.jit, static_argnames=("iters",))
def cgls_normal_fixed(A, b, x0, iters: int):
    """Fixed-iteration scan-unrolled variant of ``cgls_normal``."""
    s0 = _cgn_init(A, b, x0)

    def f(s, _):
        return _cgn_step(A, 0.0, s), None

    s, _ = jax.lax.scan(f, s0, None, length=iters, unroll=4)
    return s.x, s.k


@partial(jax.jit, static_argnames=("max_iter",))
def cgls_history(A, b, x0, max_iter: int, tol):
    """Scanned CGLS recording per-iteration solutions and diagnostics.

    Matches the reference's bookkeeping (``CGLS.py:66-80``): once the stopping
    rule fires, subsequent entries repeat the converged iterate.
    """
    s0 = _init(A, b, x0)

    def step(s, _):
        s_next = _step(A, tol, s)
        active = jnp.logical_and(s.k < max_iter, jnp.logical_not(s.done))
        s_keep = jax.tree_util.tree_map(
            lambda new, old: jnp.where(active, new, old), s_next, s
        )
        rel_step = jnp.linalg.norm(s_keep.x - s.x) / jnp.linalg.norm(s_keep.x)
        return s_keep, (s_keep.x, rel_step)

    s, (xs, rel_steps) = jax.lax.scan(step, s0, None, length=max_iter)
    return s.x, s.k, xs, rel_steps

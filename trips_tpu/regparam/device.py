"""On-device regularization-parameter search (jit-compatible).

The host rules (gcv.py/dp.py) mirror the reference through scipy; these
versions run the same searches inside jit so fused solver loops never leave
the device (SURVEY.md §2.10 "on-device parameter search"):

- ``fminbound``: Brent's bounded scalar minimization with the same
  bracketing/tolerances as ``scipy.optimize.fminbound`` (golden section +
  successive parabolic interpolation), as a ``lax.while_loop``.
- ``gcv_lambda``: Tikhonov-GCV on a projected pencil (R_A, R_L, bproj).
- ``dp_lambda``: discrepancy-principle Newton on beta = 1/lam in filtered
  SVD coordinates.

All operate on small replicated projected systems (k x k).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

def _golden_mean():
    """Golden-section constant, computed at TRACE time.

    Not a module-level jnp constant: that would initialize the XLA
    backend at import, which breaks multi-process use
    (jax.distributed.initialize must precede any backend access —
    tests/multihost_worker.py). Not a Python float either: in a pure-f32
    session the f32-sqrt value is one ulp BELOW the rounded f64 value,
    and the fused-GKS f32 GCV trajectory pinned by
    tests/test_fused.py::test_fused_f32_robustness is sensitive to that
    ulp. Tracing jnp.sqrt reproduces the historical bits in every dtype
    config."""
    return 0.5 * (3.0 - jnp.sqrt(jnp.asarray(5.0)))


def fminbound(func, x1, x2, xtol=1e-12, maxfun=1000):
    """Jittable bounded Brent minimizer (scipy.optimize.fminbound semantics).

    ``func`` must be a traceable scalar function.
    """
    _GOLDEN_MEAN = _golden_mean()
    sqrt_eps = jnp.sqrt(jnp.asarray(2.2e-16))
    a0, b0 = jnp.asarray(x1, jnp.float64 if jax.config.jax_enable_x64 else jnp.float32), jnp.asarray(x2)
    fulc0 = a0 + _GOLDEN_MEAN * (b0 - a0)
    xf0 = fulc0
    fx0 = func(xf0)

    # state: a, b, fulc, nfc, xf, fulc_f, nfc_f, fx, rat, e, num
    state0 = dict(
        a=a0, b=b0, fulc=fulc0, nfc=fulc0, xf=xf0,
        ffulc=fx0, fnfc=fx0, fx=fx0,
        rat=jnp.zeros_like(fulc0), e=jnp.zeros_like(fulc0),
        num=jnp.asarray(1, jnp.int32),
    )

    def cond(s):
        xm = 0.5 * (s["a"] + s["b"])
        tol1 = sqrt_eps * jnp.abs(s["xf"]) + xtol / 3.0
        tol2 = 2.0 * tol1
        return jnp.logical_and(
            jnp.abs(s["xf"] - xm) > (tol2 - 0.5 * (s["b"] - s["a"])),
            s["num"] < maxfun,
        )

    def body(s):
        a, b = s["a"], s["b"]
        xf, fx = s["xf"], s["fx"]
        fulc, nfc = s["fulc"], s["nfc"]
        ffulc, fnfc = s["ffulc"], s["fnfc"]
        rat, e = s["rat"], s["e"]
        xm = 0.5 * (a + b)
        tol1 = sqrt_eps * jnp.abs(xf) + xtol / 3.0
        tol2 = 2.0 * tol1

        # parabolic fit attempt
        r_ = (xf - nfc) * (fx - ffulc)
        q_ = (xf - fulc) * (fx - fnfc)
        p_ = (xf - fulc) * q_ - (xf - nfc) * r_
        q2 = 2.0 * (q_ - r_)
        p_ = jnp.where(q2 > 0, -p_, p_)
        q2 = jnp.abs(q2)
        r_old = e
        e_par = rat
        ok_par = jnp.logical_and(
            jnp.abs(e) > tol1,
            jnp.logical_and(
                jnp.abs(p_) < jnp.abs(0.5 * q2 * r_old),
                jnp.logical_and(p_ > q2 * (a - xf), p_ < q2 * (b - xf)),
            ),
        )
        rat_par = jnp.where(q2 != 0, p_ / q2, 0.0)
        x_par = xf + rat_par
        si_x = jnp.sign(xm - xf) + (xm == xf)
        rat_par = jnp.where(
            jnp.logical_or((x_par - a) < tol2, (b - x_par) < tol2),
            tol1 * si_x,
            rat_par,
        )

        # golden section step
        e_gold = jnp.where(xf >= xm, a - xf, b - xf)
        rat_gold = _GOLDEN_MEAN * e_gold

        e_new = jnp.where(ok_par, e_par, e_gold)
        rat_new = jnp.where(ok_par, rat_par, rat_gold)

        si = jnp.sign(rat_new) + (rat_new == 0)
        x = xf + si * jnp.maximum(jnp.abs(rat_new), tol1)
        fu = func(x)

        better = fu <= fx
        a_n = jnp.where(better, jnp.where(x >= xf, xf, a), jnp.where(x < xf, x, a))
        b_n = jnp.where(better, jnp.where(x >= xf, b, xf), jnp.where(x < xf, b, x))

        # bookkeeping of the two next-best points
        fulc_b, ffulc_b = nfc, fnfc
        nfc_b, fnfc_b = xf, fx
        xf_b, fx_b = x, fu

        cond2 = jnp.logical_or(fu <= fnfc, nfc == xf)
        cond3 = jnp.logical_or(fu <= ffulc, jnp.logical_or(fulc == xf, fulc == nfc))
        fulc_w = jnp.where(cond2, nfc, jnp.where(cond3, x, fulc))
        ffulc_w = jnp.where(cond2, fnfc, jnp.where(cond3, fu, ffulc))
        nfc_w = jnp.where(cond2, x, nfc)
        fnfc_w = jnp.where(cond2, fu, fnfc)

        return dict(
            a=a_n, b=b_n,
            fulc=jnp.where(better, fulc_b, fulc_w),
            nfc=jnp.where(better, nfc_b, nfc_w),
            xf=jnp.where(better, xf_b, xf),
            ffulc=jnp.where(better, ffulc_b, ffulc_w),
            fnfc=jnp.where(better, fnfc_b, fnfc_w),
            fx=jnp.where(better, fx_b, fx),
            rat=rat_new, e=e_new,
            num=s["num"] + 1,
        )

    s = jax.lax.while_loop(cond, body, state0)
    return s["xf"]


def _gcv_value(lam, R_A, R_L, bproj, out_norm2, t_term, modified):
    G = R_A.T @ R_A + lam * (R_L.T @ R_L)
    rhs = R_A.T @ bproj
    z = jnp.linalg.solve(G, rhs)
    num = jnp.sum((R_A @ z - bproj) ** 2)
    num = jnp.where(modified, num + out_norm2, num)
    trace = jnp.trace(R_A @ jnp.linalg.solve(G, R_A.T))
    return num / (t_term - trace) ** 2


@partial(jax.jit, static_argnames=("variant",))
def gcv_lambda(R_A, R_L, bproj, out_norm2=0.0, t_term=None, variant="standard"):
    """On-device Tikhonov-GCV (same search domain/tolerances as the host
    rule: lam in [1e-9, 1e2], xtol 1e-12, maxfun 1000)."""
    bproj = jnp.reshape(bproj, (-1,))
    modified = variant == "modified"
    if t_term is None:
        t_term = float(R_A.shape[0])
    f = lambda lam: _gcv_value(lam, R_A, R_L, bproj, out_norm2, t_term, modified)
    return fminbound(f, 1e-9, 1e2, xtol=1e-12, maxfun=1000)


def _lcurve_curvature(lam, R_A, R_L, bproj, pin):
    """Plain (non-log) curvature of (||R_A x - b||^2, ||R_L x||^2), the
    reference's parametrization (l_curve.py:23-88,171-188). ``pin`` adds 1
    to the inactive diagonal (0 for unmasked use)."""
    C = R_A.T @ R_A
    D = R_L.T @ R_L
    lhs = C + lam * D + pin
    x = jnp.linalg.solve(lhs, R_A.T @ bproj)
    dx = -jnp.linalg.solve(lhs, D @ x)
    inv4 = jnp.linalg.solve(lhs, D @ x)
    d2x = 2.0 * jnp.linalg.solve(lhs, D @ dx - D @ inv4)

    def term(M, c, x, dx, d2x):
        r = M @ x - c
        Mdx = M @ dx
        first = 2.0 * jnp.vdot(r, Mdx)
        second = 2.0 * (jnp.vdot(Mdx, Mdx) + jnp.vdot(r, M @ d2x))
        return first, second

    f1, f2 = term(R_A, bproj, x, dx, d2x)
    g1, g2 = term(R_L, jnp.zeros((R_L.shape[0],), x.dtype), x, dx, d2x)
    num = -g1 * f2 + f1 * g2
    den = (g1**2 + f1**2) ** 1.5
    return num / den


@jax.jit
def lcurve_lambda(R_A, R_L, bproj):
    """On-device L-curve: lam maximizing the analytic curvature, bounded
    Brent on [1e-9, 2] (same domain/tolerances as the host rule)."""
    bproj = jnp.reshape(bproj, (-1,))
    pin = jnp.zeros((R_A.shape[1], R_A.shape[1]), bproj.dtype)
    f = lambda lam: -_lcurve_curvature(lam, R_A, R_L, bproj, pin)
    return fminbound(f, 1e-9, 2.0, xtol=1e-12, maxfun=1000)


def _dp_newton_filtered(sv2, bhat, thresh, testzero):
    """Newton on beta = 1/lam in filtered SVD coordinates (mirrors
    dp.py:_dp_newton / reference discrepancy_principle.py:76-99).
    Returns 0 when the threshold is unattainable (testzero >= 0).

    float32-robust: f' is evaluated in the cancellation-free analytic form
    -2 sum(sv2 * (filt*bhat)^2 * filt) — the reference's difference form
    2/beta * z(w - z) underflows to 0 in f32 when beta*sv2 << 1 (w == z to
    machine precision), which turns the first Newton step into inf/NaN —
    and any non-finite or non-positive step stalls at the last good
    beta instead of propagating."""

    def newton(_):
        def body(s):
            beta, _, it = s
            filt = 1.0 / (sv2 * beta + 1.0)
            zbeta = filt * bhat
            f = jnp.sum(zbeta**2) - thresh
            fp = -2.0 * jnp.sum(sv2 * zbeta**2 * filt)
            beta_new = beta - f / fp
            ok = jnp.isfinite(beta_new) & (beta_new > 0)
            beta_new = jnp.where(ok, beta_new, beta)
            done = (jnp.abs(beta_new - beta) < 1e-12 * beta) | ~ok
            return (beta_new, done, it + 1)

        def cond(s):
            _, done, it = s
            return jnp.logical_and(~done, it < 100)

        beta, _, _ = jax.lax.while_loop(
            cond, body, (jnp.asarray(1e-8, bhat.dtype), jnp.asarray(False), 0))
        return 1.0 / beta

    return jax.lax.cond(testzero >= 0,
                        lambda _: jnp.asarray(0.0, bhat.dtype), newton, None)


@jax.jit
def dp_lambda(B, bproj, delta, eta=1.01):
    """On-device DP for the standard-form projected system (L = I)."""
    thresh = (eta * delta) ** 2
    U, S, _ = jnp.linalg.svd(B, full_matrices=True)
    mA, nA = B.shape
    sv2 = jnp.concatenate([S**2, jnp.zeros(max(mA - nA, 0), S.dtype)])
    bhat = U.T @ jnp.reshape(bproj, (-1,))
    tail2 = jnp.sum(bhat[nA:] ** 2) if mA > nA else jnp.asarray(0.0, bhat.dtype)
    testzero = tail2 - thresh
    return _dp_newton_filtered(sv2, bhat, thresh, testzero)


# ---- discrete truncation-index selection (tsvd/tgsvd), device twins ------
#
# Vectorized mirrors of the host discrete searches (regparam/gcv.py:95-121,
# regparam/dp.py:133-158; reference gcv.py:96-122,
# discrepancy_principle.py:100-128): the reference's python loops become
# reversed cumulative sums + argmin/argmax, so truncation solvers can pick k
# inside a jitted program.


def _suffix_sums(bhat, n):
    """rev[i] = sum of |bhat_j|^2 for j in [n-1-i, n): the residual energy
    released by zeroing the smallest i+1 retained coefficients."""
    c = bhat[:n] ** 2
    return jnp.cumsum(c[::-1]), jnp.sum(bhat[n:] ** 2)


@partial(jax.jit, static_argnames=("n",))
def gcv_tsvd_k(bhat, n):
    """GCV truncation index for TSVD: k minimizing
    (residual energy past k + out-of-range tail) / (m - k)^2 over
    k = n-1 .. 0 (host gcv.py:95-104; reference gcv.py:96-109).
    ``bhat = U^T b`` with U the full (m, m) left-singular basis."""
    bhat = jnp.reshape(bhat, (-1,))
    m = bhat.shape[0]
    rev, tail = _suffix_sums(bhat, n)
    i = jnp.arange(n)
    vals = (rev + tail) / (m - (n - (i + 1))) ** 2
    return n - (jnp.argmin(vals) + 1)


@partial(jax.jit, static_argnames=("n", "p"))
def gcv_tgsvd_k(bhat, n, p):
    """GCV truncation index for TGSVD: progressive zeroing of |bhat|^2 from
    index n-1 downward, denominator (p - i - 1)^2 (host gcv.py:106-121;
    reference gcv.py:110-122, including the inf at the zero denominator)."""
    bhat = jnp.reshape(bhat, (-1,))
    rev, _ = _suffix_sums(bhat, n)
    total = jnp.sum(bhat[:n] ** 2)
    i = jnp.arange(n)
    den = (p - i - 1.0) ** 2
    vals = jnp.where(den != 0, (total - rev) / den, jnp.inf)
    return jnp.argmin(vals)


@partial(jax.jit, static_argnames=("n",))
def dp_tsvd_k(bhat, n, delta, eta=1.01):
    """DP truncation index for TSVD: walk k = n-1 .. 0 while the truncated
    residual stays below (eta*delta)^2; stop at the first violation (host
    dp.py:133-146; reference discrepancy_principle.py:100-114). Returns n
    when even the first step violates."""
    bhat = jnp.reshape(bhat, (-1,))
    thresh = (eta * delta) ** 2
    rev, tail = _suffix_sums(bhat, n)
    ok = rev + tail - thresh >= 0  # dp_val >= 0 -> the walk breaks here
    lead = jnp.where(jnp.any(ok), jnp.argmax(ok), n)  # consecutive passes
    return n - lead


@partial(jax.jit, static_argnames=("n",))
def dp_tgsvd_k(bhat, n, delta, eta=1.01):
    """DP truncation index for TGSVD: progressive zeroing while the running
    energy stays >= (eta*delta)^2; alpha = last passing index (host
    dp.py:148-158; reference discrepancy_principle.py:115-128)."""
    bhat = jnp.reshape(bhat, (-1,))
    thresh = (eta * delta) ** 2
    rev, _ = _suffix_sums(bhat, n)
    total = jnp.sum(bhat[:n] ** 2)
    fail = (total - rev) - thresh < 0
    lead = jnp.where(jnp.any(fail), jnp.argmax(fail), n)
    return jnp.where(lead == 0, n, lead - 1)

"""Smoke run of the CT and deblurring main path on an NVIDIA GPU.

Drives ``problems.*`` -> ``device_sparse_operator`` -> ``krylov.*`` /
``solvers.*`` / ``solvers.fused.*`` at the sizes of the reference's large
demos, in one process, and checks every result against a scipy/NumPy
oracle or a recorded CPU float64 value. Any failed check raises, the
process exits non-zero and the final ``ok`` line is not printed.

    python chip_smoke.py           # phases device, tomo256x60, deblur256,
                                   # dynamic560 (one GPU)
    python chip_smoke.py --four    # phases device, four (four GPUs)
    python chip_smoke.py --reference
        # CPU float64 run of the solver calls whose errors are pinned in
        # REFERENCE below; prints those errors and nothing else

The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0

# Relative errors to x_true of the same calls on the CPU backend with x64,
# from `JAX_PLATFORMS=cpu python chip_smoke.py --reference` (run on the
# GPU host's CPU). The GPU run computes in float32 and must land within
# SOLVER_RTOL of each: the solvers are stable, so f32 roundoff moves the
# reconstruction error by far less than 10%, while a wrong operator,
# precision or regularization parameter moves it by more.
REFERENCE = {
    "tomo256x60/GKS_dp": 0.11883594583549012,
    "tomo256x60/fused_gks_gcv": 0.1101259021889156,
    "tomo256x60/fused_mmgks_gcv": 0.1266837142068899,
    "deblur256/fused_mmgks_gcv": 0.09323217925101324,
}
SOLVER_RTOL = 0.10
# Exact-class applies against scipy in float64. True f32 products with f32
# storage give ~1e-6 relative; a TF32 product (10-bit mantissa) gives ~1e-3.
APPLY_RTOL = 1e-5
# |<Ax,y> - <x,A^T y>| / (|Ax| |y|): the same f32 budget as the applies.
ADJ_TOL = 1e-5
# CGLS semiconvergence: the f32 device recurrence against the f64 scipy
# one. Its smallest error must agree within 2% and occur within 2
# iterations (f32 loses Krylov orthogonality slowly over 100 iterations).
CGLS_MIN_RTOL = 0.02
CGLS_ARGMIN_TOL = 2
# Mesh against one device: the same f32 operations summed in another order
# (per-shard partial sums, then a psum), so x agrees to f32 roundoff grown
# over 20 Krylov steps.
MESH_X_RTOL = 1e-3
# Hybrid LSQR's GCV function is flat near its minimum (lambda is far below
# the projected system's squared singular values), so two f32 runs, on one
# card or on four, may return lambdas a factor of a few apart: the banded
# adjoint's scatter-add sums in another order from run to run. Each lambda
# is held to being a GCV minimizer instead: its float64 GCV value within
# GCV_RTOL of the float64 minimum, 10x the f32 resolution of G's
# evaluation on the device.
GCV_RTOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def relerr(x, x_true):
    return rel(x, x_true)


def timed(fn, *args, **kw):
    """(result, seconds of the second call): the first call compiles."""
    import jax

    jax.block_until_ready(fn(*args, **kw))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


def stored_bytes(op):
    import jax

    return sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(op))


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def check_applies(phase, op, A, rng):
    """matvec/rmatvec vs scipy in float64, and adjointness."""
    import jax.numpy as jnp

    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    y = rng.standard_normal(A.shape[0]).astype(np.float32)
    Ax = np.asarray(op.matvec(jnp.asarray(x)), np.float64)
    Aty = np.asarray(op.rmatvec(jnp.asarray(y)), np.float64)
    e_fwd = rel(Ax, A @ x.astype(np.float64))
    e_adj = rel(Aty, A.T @ y.astype(np.float64))
    gap = abs(Ax @ y - x @ Aty) / (np.linalg.norm(Ax) * np.linalg.norm(y))
    say(phase, f"matvec rel err {e_fwd:.3e}, rmatvec rel err {e_adj:.3e}, "
               f"adjointness gap {gap:.3e} (limits {APPLY_RTOL:g}, "
               f"{ADJ_TOL:g})")
    check(e_fwd <= APPLY_RTOL, f"{phase}: matvec rel err {e_fwd}")
    check(e_adj <= APPLY_RTOL, f"{phase}: rmatvec rel err {e_adj}")
    check(gap <= ADJ_TOL, f"{phase}: adjointness gap {gap}")


def scipy_cgls_errors(A, b, x_true, iters):
    """f64 CGLS recurrence (trips/solvers/CGLS.py:57-83) on scipy CSR."""
    x = np.zeros(A.shape[1])
    r = b.copy()
    s = A.T @ r
    p = s.copy()
    gamma = s @ s
    errs = []
    for _ in range(iters):
        q = A @ p
        alpha = gamma / (q @ q)
        x += alpha * p
        r -= alpha * q
        s = A.T @ r
        gamma_new = s @ s
        p = s + (gamma_new / gamma) * p
        gamma = gamma_new
        errs.append(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))
    return np.asarray(errs)


# -- problem builders (shared by the GPU phases and --reference) ----------

def build_tomo(nx=256, views=60):
    """Reference demo_Tomo_large_scale: fan beam, no inverse crime, grains
    phantom, 1% Gaussian noise."""
    from trips_tpu.problems import Tomography

    np.random.seed(SEED)
    prob = Tomography(CommitCrime=False)
    x_true, _, _ = prob.gen_true("grains", nx=nx, ny=nx, phantom_seed=SEED)
    OP, b_true, _, _, A = prob.gen_data(x_true, nx, nx, views)
    b, delta = prob.add_noise(b_true, "Gaussian", 0.01)
    return OP, A, np.asarray(b).reshape(-1), float(delta), \
        np.asarray(x_true).reshape(-1)


def tomo_solvers(OP, b, delta, x_true, nx, n_iter=30):
    """{name: (rel err, seconds after compile)} for the solver calls."""
    import jax.numpy as jnp

    from trips_tpu.operators import FirstDerivative2D
    from trips_tpu.solvers import GKS
    from trips_tpu.solvers.fused import fused_gks, fused_mmgks

    L = FirstDerivative2D(nx, nx)
    bj = jnp.asarray(b, OP.dtype)
    out = {}
    (x, _), t = timed(GKS, OP, b, L, projection_dim=3, n_iter=n_iter,
                      regparam="dp", delta=delta)
    out["GKS_dp"] = (relerr(x, x_true), t)
    (x, _, _), t = timed(fused_gks, OP, bj, L, projection_dim=3,
                         n_iter=n_iter, regparam_mode="gcv")
    out["fused_gks_gcv"] = (relerr(x, x_true), t)
    (x, _, _), t = timed(fused_mmgks, OP, bj, L, pnorm=2.0, qnorm=1.0,
                         projection_dim=3, n_iter=n_iter,
                         regparam_mode="gcv")
    out["fused_mmgks_gcv"] = (relerr(x, x_true), t)
    return out


def build_deblur(n=256):
    """Reference demo_2D_Deblurring_large_scale: (9, 9) Gaussian PSF with
    spread (3, 3), 'H' image, 1% Gaussian noise, no inverse crime."""
    from trips_tpu.problems import Deblurring2D

    np.random.seed(SEED)
    prob = Deblurring2D()
    op = prob.forward_Op([9, 9], (3, 3), n, n)
    x_true = prob.gen_true("h_im", nx=n, ny=n)
    b_true = prob.gen_data(x_true.reshape(-1, 1))
    b, _ = prob.add_noise(b_true, "Gaussian", 0.01)
    return op, np.asarray(b).reshape(-1), np.asarray(x_true).reshape(-1)


def deblur_solver(op, b, x_true, n, n_iter=30):
    import jax
    import jax.numpy as jnp

    from trips_tpu.operators import FirstDerivative2D
    from trips_tpu.solvers.fused import fused_mmgks

    dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    (x, _, _), t = timed(fused_mmgks, op, jnp.asarray(b, dt),
                         FirstDerivative2D(n, n), pnorm=2.0, qnorm=1.0,
                         projection_dim=3, n_iter=n_iter,
                         regparam_mode="gcv")
    return relerr(x, x_true), t


# -- phases -----------------------------------------------------------------

def phase_device(four):
    import jax

    devs = jax.devices()
    need = 4 if four else 1
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX found "
              f"{[d.platform for d in devs]}", file=sys.stderr)
        sys.exit(2)
    from trips_tpu.config import enable_compile_cache

    cache = enable_compile_cache()
    import jaxlib

    cards = nvidia_smi()
    say("device", f"device_kind {devs[0].device_kind}, count {len(devs)}, "
                  f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    say("device", f"compile cache {cache}")
    for line in cards:
        print(line, flush=True)
    return cards[0]


def phase_tomo(card, nx=256, views=60, cgls_iters=100, n_iter=30):
    import jax.numpy as jnp

    from trips_tpu.krylov import cgls, cgls_history

    ph = f"tomo{nx}x{views}"
    t0 = time.perf_counter()
    OP, A, b, delta, x_true = build_tomo(nx, views)
    say(ph, f"built {A.shape[0]}x{A.shape[1]}, {A.nnz} nnz in "
            f"{time.perf_counter() - t0:.1f} s; operator "
            f"{type(OP).__name__}, {stored_bytes(OP)} stored bytes")
    check_applies(ph, OP, A, np.random.default_rng(SEED))

    bj = jnp.asarray(b, jnp.float32)
    x0 = jnp.zeros(A.shape[1], jnp.float32)
    _, _, xs, _ = cgls_history(OP, bj, x0, cgls_iters, 0.0)
    xt = jnp.asarray(x_true, jnp.float32)
    e_dev = np.asarray(jnp.linalg.norm(xs - xt[None], axis=1)
                       / jnp.linalg.norm(xt))
    e_ref = scipy_cgls_errors(A, b, x_true, cgls_iters)
    k_dev, k_ref = int(np.argmin(e_dev)), int(np.argmin(e_ref))
    d_min = abs(e_dev[k_dev] - e_ref[k_ref]) / e_ref[k_ref]
    say(ph, f"cgls {cgls_iters} it: min rel err {e_dev[k_dev]:.5f} at "
            f"it {k_dev + 1}; scipy f64 {e_ref[k_ref]:.5f} at it "
            f"{k_ref + 1}")
    check(np.isfinite(e_dev).all(), f"{ph}: non-finite CGLS iterate")
    check(d_min <= CGLS_MIN_RTOL, f"{ph}: CGLS min error off by {d_min}")
    check(abs(k_dev - k_ref) <= CGLS_ARGMIN_TOL,
          f"{ph}: CGLS argmin {k_dev} vs {k_ref}")
    (_, k), t = timed(cgls, OP, bj, x0, cgls_iters, 0.0)
    say(ph, f"cgls {int(k)} it fused: {t * 1e3:.2f} ms after compile "
            f"({card})")

    for name, (err, t) in tomo_solvers(OP, b, delta, x_true, nx,
                                       n_iter).items():
        ref = REFERENCE.get(f"{ph}/{name}")
        say(ph, f"{name} {n_iter} it: rel err {err:.5f} (CPU x64 {ref}); "
                f"{t * 1e3:.1f} ms after compile ({card})")
        check(np.isfinite(err), f"{ph}: {name} not finite")
        if ref is not None:
            check(abs(err - ref) <= SOLVER_RTOL * ref,
                  f"{ph}: {name} rel err {err} vs CPU x64 {ref}")


def phase_deblur(card, n=256, n_iter=30):
    import jax.numpy as jnp
    from scipy.ndimage import convolve

    ph = f"deblur{n}"
    op, b, x_true = build_deblur(n)
    psf = np.asarray(op.psf, np.float64)
    rng = np.random.default_rng(SEED)
    X = rng.standard_normal((n, n)).astype(np.float32)
    got = np.asarray(op.matvec(jnp.asarray(X.reshape(-1))))
    got_t = np.asarray(op.rmatvec(jnp.asarray(X.reshape(-1))))
    e_fwd = rel(got, convolve(X.astype(np.float64), psf, mode="reflect"))
    e_adj = rel(got_t, convolve(X.astype(np.float64), psf[::-1, ::-1],
                                mode="reflect"))
    say(ph, f"blur apply rel err {e_fwd:.3e}, adjoint apply rel err "
            f"{e_adj:.3e} vs scipy.ndimage.convolve (limit {APPLY_RTOL:g})")
    check(e_fwd <= APPLY_RTOL, f"{ph}: blur apply rel err {e_fwd}")
    check(e_adj <= APPLY_RTOL, f"{ph}: blur adjoint rel err {e_adj}")
    err, t = deblur_solver(op, b, x_true, n, n_iter)
    ref = REFERENCE.get(f"{ph}/fused_mmgks_gcv")
    say(ph, f"fused_mmgks_gcv {n_iter} it (derivative L): rel err "
            f"{err:.5f} (CPU x64 {ref}); {t * 1e3:.1f} ms after compile "
            f"({card})")
    check(np.isfinite(err), f"{ph}: fused_mmgks not finite")
    if ref is not None:
        check(abs(err - ref) <= SOLVER_RTOL * ref,
              f"{ph}: fused_mmgks rel err {err} vs CPU x64 {ref}")


def build_dynamic(nx=560, nt=8, views=11):
    """Dynamic CT at STEMPO-simulation frame size: 11 frame-varying fan
    views per frame (generate_stempo's simulation default)."""
    from trips_tpu.problems import generate_synthetic_dynamic

    return generate_synthetic_dynamic(nx=nx, nt=nt, views=views,
                                      noise_level=0.01, seed=SEED,
                                      return_angles=True)


def phase_dynamic(card, nx=560, nt=8, views=11, n_iter=20):
    import jax
    import jax.numpy as jnp

    from trips_tpu.operators import CenteredSpaceTimeDerivative
    from trips_tpu.problems import device_sparse_operator
    from trips_tpu.solvers.fused_info import fused_mmgks_info

    ph = f"dynamic{nx}"
    t0 = time.perf_counter()
    A, b, _, _, nx, ny, nt, _, x_true, _ = build_dynamic(nx, nt, views)
    op = device_sparse_operator(A)
    say(ph, f"built {A.shape[0]}x{A.shape[1]}, {A.nnz} nnz, {nt} frames in "
            f"{time.perf_counter() - t0:.1f} s; operator "
            f"{type(op).__name__}, {stored_bytes(op)} stored bytes")
    check_applies(ph, op, A, np.random.default_rng(SEED))
    # fused_mmgks_info runs fused_mmgks's loop body and also returns the
    # per-iteration relative error
    _, info = fused_mmgks_info(
        op, jnp.asarray(b, jnp.float32), CenteredSpaceTimeDerivative(
            nx, ny, nt), pnorm=2.0, qnorm=1.0, projection_dim=3,
        n_iter=n_iter, regparam_mode="gcv", weight_mode="isoTV",
        prob_dims=(nx, ny, nt), x_true=jnp.asarray(x_true, jnp.float32))
    errs = np.asarray(info["relError"])
    t0 = time.perf_counter()
    jax.block_until_ready(fused_mmgks_info(
        op, jnp.asarray(b, jnp.float32), CenteredSpaceTimeDerivative(
            nx, ny, nt), pnorm=2.0, qnorm=1.0, projection_dim=3,
        n_iter=n_iter, regparam_mode="gcv", weight_mode="isoTV",
        prob_dims=(nx, ny, nt), x_true=jnp.asarray(x_true, jnp.float32)))
    t = time.perf_counter() - t0
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    say(ph, f"fused_mmgks isoTV {n_iter} it: rel err {errs[0]:.5f} -> "
            f"{errs[-1]:.5f}; {t:.3f} s after compile; peak_bytes_in_use "
            f"{peak} ({card})")
    check(np.isfinite(errs).all(), f"{ph}: non-finite MMGKS iterate")
    check(errs[-1] < errs[0], f"{ph}: MMGKS error did not fall {errs}")


def gcv_function(B, beta, m):
    """fused_hybrid_lsqr's modified GCV function of its last projected
    system (all n_iter columns of the (n_iter+1, n_iter) bidiagonal B
    active; numerator and denominator as ``solvers.fused
    ._gcv_lambda_masked``), in float64 on the host."""
    B = np.asarray(B, np.float64)
    bh = np.zeros(B.shape[0])
    bh[0] = beta
    U, s, _ = np.linalg.svd(B, full_matrices=False)
    c = U.T @ bh
    rest2 = np.sum((bh - U @ c) ** 2)
    s2 = s ** 2
    k = B.shape[1]

    def G(lam):
        d = s2 + lam
        return ((lam ** 2 * np.sum(c ** 2 / d ** 2) + rest2)
                / ((m - k) + np.sum(lam / d)) ** 2)

    return G, s2


def check_gcv_minimizers(ph, B, beta, m, lams):
    """Each lambda in ``lams`` is a minimizer of the float64 GCV function
    to GCV_RTOL; prints the curve's spread between them."""
    from scipy.optimize import fminbound

    G, s2 = gcv_function(B, beta, m)
    grid = np.logspace(-9, 2, 2201)
    cands = np.concatenate([grid, [fminbound(G, 1e-9, 1e2, xtol=1e-12)]])
    vals = np.array([G(v) for v in cands])
    lam_star, g_star = cands[np.argmin(vals)], vals.min()
    lo, hi = min(lams), max(lams)
    inside = [G(v) for v in np.logspace(np.log10(lo), np.log10(hi), 101)]
    say(ph, f"GCV (float64, one-card bidiagonal): argmin {lam_star:.4e}, "
            f"smallest squared singular value {s2.min():.4e}; G varies by "
            f"{(max(inside) - min(inside)) / g_star:.3e} relative over "
            f"[{lo:.4e}, {hi:.4e}]")
    for lam in sorted(set(lams)):
        gap = G(lam) / g_star - 1.0
        say(ph, f"lambda {lam:.4e}: G(lambda)/min G - 1 = {gap:.3e} "
                f"(limit {GCV_RTOL:g})")
        check(gap <= GCV_RTOL, f"{ph}: lambda {lam} is not a GCV "
                               f"minimizer ({gap})")


def phase_four(card, nx=560, nt=8, views=11, n_iter=20):
    """(time x angles)-sharded dynamic banded operator on a 2x2 mesh
    against the same format with no mesh on one device."""
    import jax
    import jax.numpy as jnp

    from trips_tpu.krylov import cgls_normal, golub_kahan
    from trips_tpu.parallel import ShardedDynamicBandedOperator, make_mesh
    from trips_tpu.solvers.fused import fused_hybrid_lsqr
    from trips_tpu.sparse import DynamicBandedOperator

    ph = "four"
    devs = jax.devices()[:4]
    A, b, AA, _, nx, _, nt, _, x_true, angles = build_dynamic(nx, nt, views)
    with jax.default_device(devs[0]):
        one = DynamicBandedOperator.from_frames(AA, nx, angles)
        b1 = jnp.asarray(b, jnp.float32)
    mesh = make_mesh({"time": 2, "angles": 2}, devices=devs)
    four = ShardedDynamicBandedOperator.from_dynamic(one, mesh)
    for name in ("W_rows", "W_cols"):
        held = {s.device for s in getattr(four, name).addressable_shards}
        say(ph, f"{name} shards on {sorted(d.id for d in held)}")
        check(len(held) == 4, f"{ph}: {name} on {len(held)} devices")
    x0 = jnp.zeros(A.shape[1], jnp.float32)
    (x1, k1), t1 = timed(cgls_normal, one, b1, x0, n_iter, 0.0)
    (x4, k4), t4 = timed(cgls_normal, four, b1, x0, n_iter, 0.0)
    d = rel(x4, x1)
    say(ph, f"cgls_normal {n_iter} it: rel diff {d:.3e}; "
            f"{t1 / int(k1) * 1e3:.3f} ms/it on 1 card, "
            f"{t4 / int(k4) * 1e3:.3f} ms/it on 4 ({card})")
    check(d <= MESH_X_RTOL, f"{ph}: cgls_normal mesh vs single {d}")
    (xh1, lam1), th1 = timed(fused_hybrid_lsqr, one, b1, n_iter=n_iter,
                             regparam_mode="gcv")
    (xh4, lam4), th4 = timed(fused_hybrid_lsqr, four, b1, n_iter=n_iter,
                             regparam_mode="gcv")
    dh = rel(xh4, xh1)
    say(ph, f"fused_hybrid_lsqr gcv {n_iter} it: x rel diff {dh:.3e}, "
            f"final lambda {float(lam4[-1]):.4e} vs {float(lam1[-1]):.4e}; "
            f"{th1 / n_iter * 1e3:.3f} "
            f"ms/it on 1 card, {th4 / n_iter * 1e3:.3f} ms/it on 4 ({card})")
    check(dh <= MESH_X_RTOL, f"{ph}: hybrid lsqr mesh vs single {dh}")
    # repeated runs in this process: does either lambda repeat bitwise?
    reps = {"1 card": one, "4 cards": four}
    for where, op in reps.items():
        got = [float(fused_hybrid_lsqr(op, b1, n_iter=n_iter,
                                       regparam_mode="gcv")[1][-1])
               for _ in range(3)]
        reps[where] = got
        say(ph, f"final lambda, 3 more runs on {where}: "
                + ", ".join(f"{v:.6e}" for v in got))
    _, B1, _ = golub_kahan(one, b1, n_iter)
    check_gcv_minimizers(ph, B1, float(jnp.linalg.norm(b1)), one.shape[0],
                         [float(lam1[-1]), float(lam4[-1])]
                         + reps["1 card"] + reps["4 cards"])


def reference():
    """CPU float64 errors for REFERENCE (no checks, no ok line)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    if jax.devices()[0].platform != "cpu":
        sys.exit("--reference runs on the CPU backend: set JAX_PLATFORMS=cpu")
    out = {}
    OP, _, b, delta, x_true = build_tomo()
    for name, (err, _) in tomo_solvers(OP, b, delta, x_true, 256).items():
        out[f"tomo256x60/{name}"] = err
    op, b, x_true = build_deblur()
    out["deblur256/fused_mmgks_gcv"] = deblur_solver(op, b, x_true, 256)[0]
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    ap.add_argument("--reference", action="store_true",
                    help="print the CPU float64 solver errors")
    args = ap.parse_args()
    if args.reference:
        reference()
        return
    import jax

    card = phase_device(args.four)
    if args.four:
        phase_four(card)
    else:
        phase_tomo(card)
        phase_deblur(card)
        phase_dynamic(card)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()

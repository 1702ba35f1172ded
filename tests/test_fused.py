"""Fused all-on-device GKS/MMGKS vs the host-driven reference-parity
implementations."""
import jax.numpy as jnp
import numpy as np

from trips_tpu.core import DenseOperator
from trips_tpu.operators import Blur1D, FirstDerivative1D
from trips_tpu.solvers import GKS, MMGKS
from trips_tpu.solvers.fused import fused_gks, fused_mmgks


def problem():
    n = 80
    rng = np.random.default_rng(7)
    op = Blur1D(n, 4.0)
    A = np.asarray(op.mat)
    h = np.pi / n
    g = -np.pi / 2 + np.arange(0.5, n, 1) * h
    x_true = 2 * np.exp(-6 * (g - 0.8) ** 2) + np.exp(-2 * (g + 0.5) ** 2)
    b_true = A @ x_true
    e = rng.standard_normal(n)
    b = b_true + 0.02 * np.linalg.norm(b_true) / np.linalg.norm(e) * e
    return op, A, x_true, b


def test_fused_gks_matches_host():
    op, A, x_true, b = problem()
    n = len(b)
    L = FirstDerivative1D(n)
    x_host, info = GKS(op, b, L, projection_dim=3, n_iter=8, regparam="gcv")
    x_dev, lams, resids = fused_gks(op, jnp.asarray(b), L, projection_dim=3,
                                    n_iter=8, use_gcv=True)
    # the GCV surface is flat near its minimum, so lam trajectories can
    # differ in the flat region while the solutions stay close (the fused
    # rule evaluates the identical GCV function in filtered-SVD form)
    np.testing.assert_allclose(
        np.asarray(x_dev), np.asarray(x_host).reshape(-1), atol=2e-4
    )
    assert np.all(np.asarray(lams) >= 1e-9) and np.all(np.asarray(lams) <= 1e2)


def test_fused_gks_scalar_lambda():
    op, A, x_true, b = problem()
    n = len(b)
    L = FirstDerivative1D(n)
    x_host, info = GKS(op, b, L, projection_dim=3, n_iter=6, regparam=0.05)
    x_dev, lams, _ = fused_gks(op, jnp.asarray(b), L, projection_dim=3,
                               n_iter=6, regparam=0.05, use_gcv=False)
    np.testing.assert_allclose(
        np.asarray(x_dev), np.asarray(x_host).reshape(-1), rtol=1e-5, atol=1e-8
    )


def test_fused_mmgks_matches_host():
    op, A, x_true, b = problem()
    n = len(b)
    L = FirstDerivative1D(n)
    x_host, info = MMGKS(op, b, L, pnorm=2, qnorm=1, projection_dim=3,
                         n_iter=8, regparam="gcv")
    x_dev, lams, _ = fused_mmgks(op, jnp.asarray(b), L, pnorm=2.0, qnorm=1.0,
                                 projection_dim=3, n_iter=8, use_gcv=True)
    np.testing.assert_allclose(
        np.asarray(x_dev), np.asarray(x_host).reshape(-1), atol=1e-4
    )


def test_fused_gks_reconstruction_quality():
    op, A, x_true, b = problem()
    L = FirstDerivative1D(len(b))
    x_dev, lams, _ = fused_gks(op, jnp.asarray(b), L, projection_dim=3,
                               n_iter=10, use_gcv=True)
    err = np.linalg.norm(np.asarray(x_dev) - x_true) / np.linalg.norm(x_true)
    assert err < 0.1


def test_fused_hybrid_lsqr_matches_host():
    from trips_tpu.solvers import Hybrid_LSQR
    from trips_tpu.solvers.fused import fused_hybrid_lsqr

    op, A, x_true, b = problem()
    x_host, info = Hybrid_LSQR(op, b, n_iter=10, regparam="gcv")
    x_dev, lams = fused_hybrid_lsqr(op, jnp.asarray(b), n_iter=10, use_gcv=True)
    np.testing.assert_allclose(
        np.asarray(x_dev), np.asarray(x_host).reshape(-1), atol=1e-5
    )


def test_fused_hybrid_lsqr_scalar():
    from trips_tpu.solvers import Hybrid_LSQR
    from trips_tpu.solvers.fused import fused_hybrid_lsqr

    op, A, x_true, b = problem()
    x_host, info = Hybrid_LSQR(op, b, n_iter=10, regparam=0.01)
    x_dev, lams = fused_hybrid_lsqr(op, jnp.asarray(b), n_iter=10,
                                    regparam=0.01, use_gcv=False)
    np.testing.assert_allclose(
        np.asarray(x_dev), np.asarray(x_host).reshape(-1), atol=1e-6
    )


# ---- on-device DP / L-curve in the fused solvers ----

def problem_with_delta():
    op, A, x_true, b = problem()
    b_true = A @ x_true
    delta = float(np.linalg.norm(b - b_true))
    return op, A, x_true, b, delta


def test_fused_gks_dp_matches_host():
    op, A, x_true, b, delta = problem_with_delta()
    L = FirstDerivative1D(len(b))
    x_host, info = GKS(op, b, L, projection_dim=3, n_iter=8, regparam="dp",
                       delta=delta)
    x_dev, lams, _ = fused_gks(op, jnp.asarray(b), L, projection_dim=3,
                               n_iter=8, regparam_mode="dp", delta=delta)
    np.testing.assert_allclose(
        np.asarray(lams), np.asarray(info["regParam_history"]),
        rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(x_dev), np.asarray(x_host).reshape(-1), atol=1e-5)


def test_fused_gks_lcurve_matches_host():
    op, A, x_true, b, delta = problem_with_delta()
    L = FirstDerivative1D(len(b))
    x_host, info = GKS(op, b, L, projection_dim=3, n_iter=6,
                       regparam="l_curve")
    x_dev, lams, _ = fused_gks(op, jnp.asarray(b), L, projection_dim=3,
                               n_iter=6, regparam_mode="l_curve")
    np.testing.assert_allclose(
        np.asarray(lams), np.asarray(info["regParam_history"]),
        rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(x_dev), np.asarray(x_host).reshape(-1), atol=1e-4)


def test_fused_mmgks_dp_matches_host():
    op, A, x_true, b, delta = problem_with_delta()
    L = FirstDerivative1D(len(b))
    x_host, info = MMGKS(op, b, L, pnorm=2, qnorm=1, projection_dim=3,
                         n_iter=8, regparam="dp", delta=delta)
    x_dev, lams, _ = fused_mmgks(op, jnp.asarray(b), L, pnorm=2.0,
                                 qnorm=1.0, projection_dim=3, n_iter=8,
                                 regparam_mode="dp", delta=delta)
    np.testing.assert_allclose(
        np.asarray(lams), np.asarray(info["regParam_history"]),
        rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(x_dev), np.asarray(x_host).reshape(-1), atol=1e-4)


def test_fused_mmgks_lcurve_matches_host():
    op, A, x_true, b, delta = problem_with_delta()
    L = FirstDerivative1D(len(b))
    x_host, info = MMGKS(op, b, L, pnorm=2, qnorm=1, projection_dim=3,
                         n_iter=6, regparam="l_curve")
    x_dev, lams, _ = fused_mmgks(op, jnp.asarray(b), L, pnorm=2.0,
                                 qnorm=1.0, projection_dim=3, n_iter=6,
                                 regparam_mode="l_curve")
    np.testing.assert_allclose(
        np.asarray(lams), np.asarray(info["regParam_history"]),
        rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(x_dev), np.asarray(x_host).reshape(-1), atol=1e-4)


def test_fused_hybrid_lsqr_dp_matches_host():
    from trips_tpu.solvers import Hybrid_LSQR
    from trips_tpu.solvers.fused import fused_hybrid_lsqr

    op, A, x_true, b, delta = problem_with_delta()
    x_host, info = Hybrid_LSQR(op, b, n_iter=10, regparam="dp", delta=delta)
    x_dev, lams = fused_hybrid_lsqr(op, jnp.asarray(b), n_iter=10,
                                    regparam_mode="dp", delta=delta)
    # host history starts at ii=1 (lam=0 quirk at ii=0 recorded separately)
    np.testing.assert_allclose(
        np.asarray(lams)[1:], np.asarray(info["regParam_history"]),
        rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(x_dev), np.asarray(x_host).reshape(-1), atol=1e-5)


def test_fused_hybrid_lsqr_lcurve_matches_host():
    from trips_tpu.solvers import Hybrid_LSQR
    from trips_tpu.solvers.fused import fused_hybrid_lsqr

    op, A, x_true, b, delta = problem_with_delta()
    x_host, info = Hybrid_LSQR(op, b, n_iter=10, regparam="l_curve")
    x_dev, lams = fused_hybrid_lsqr(op, jnp.asarray(b), n_iter=10,
                                    regparam_mode="l_curve")
    np.testing.assert_allclose(
        np.asarray(lams)[1:], np.asarray(info["regParam_history"]),
        rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(x_dev), np.asarray(x_host).reshape(-1), atol=1e-4)


def test_fused_f32_robustness():
    """The fused on-device regparam rules are the device path, which runs
    in f32: the selected lam must not collapse (GCV cancellation in
    t - trace), and DP must stay finite (Newton f' underflow), when the
    whole solve runs in float32. Regression for the f32 failures found in
    round 2: on this severely ill-posed config the solve-based GCV picked
    lam ~1e-7 in f32 (vs the f64 interior minimum ~6e-2, rel_err 11 vs
    0.32), and the hybrid DP Newton returned NaN."""
    from trips_tpu.core import DenseOperator
    from trips_tpu.problems import Deblurring1D
    from trips_tpu.solvers.fused import fused_hybrid_lsqr

    np.random.seed(11)
    prob = Deblurring1D()
    A64 = prob.forward_Op_1D(30, 200)
    x_true = prob.gen_xtrue(200, "curve0")
    b_true = prob.gen_data(x_true)
    b, delta = prob.add_noise(b_true, "Gaussian", 0.02)
    b = np.asarray(b).reshape(-1)
    L = FirstDerivative1D(200)
    xt = np.asarray(x_true).ravel()

    op32 = DenseOperator(jnp.asarray(np.asarray(A64.mat), jnp.float32))
    b32 = jnp.asarray(b, dtype=jnp.float32)

    # (a) fixed projected pencil: the masked GCV selector itself must find
    # the same interior minimizer in f32 as in f64 (the old solve-based
    # form collapsed to the 1e-9 boundary in f32)
    from trips_tpu.solvers.fused import _gcv_lambda_masked

    k = 24
    rng = np.random.default_rng(3)
    s = np.logspace(0, -6, k)
    R_A = np.diag(s)
    R_L = np.eye(k)
    # data coefficients with a noise floor: the classic interior-minimum
    # GCV setup (small-sv coefficients are noise-dominated)
    bp = s * 1.0 + 1e-3 * rng.standard_normal(k)
    active = jnp.ones((k,), bool)
    lam64 = float(_gcv_lambda_masked(
        jnp.asarray(R_A), jnp.asarray(R_L), jnp.asarray(bp),
        jnp.asarray(float(k)), active))
    lam32 = float(_gcv_lambda_masked(
        jnp.asarray(R_A, jnp.float32), jnp.asarray(R_L, jnp.float32),
        jnp.asarray(bp, jnp.float32), jnp.asarray(k, jnp.float32), active))
    assert 1e-8 < lam64 < 1e2
    np.testing.assert_allclose(lam32, lam64, rtol=0.1)

    # (b) end-to-end pure-f32 solve (subprocess on the CPU with x64 off,
    # as the solvers run on the GPU — the in-process x64 session would mix
    # precisions in a way an f32 run cannot): reconstruction must not blow up
    # (was rel_err ~11 / lam ~1.5e-7 with the solve-based GCV in f32)
    import os
    import subprocess
    import sys

    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np, jax.numpy as jnp\n"
        "from trips_tpu.problems import Deblurring1D\n"
        "from trips_tpu.solvers.fused import fused_gks\n"
        "from trips_tpu.operators import FirstDerivative1D\n"
        "np.random.seed(11)\n"
        "prob = Deblurring1D()\n"
        "A = prob.forward_Op_1D(30, 200)\n"
        "x_true = prob.gen_xtrue(200, 'curve0')\n"
        "b, delta = prob.add_noise(prob.gen_data(x_true), 'Gaussian', 0.02)\n"
        "b = np.asarray(b).reshape(-1)\n"
        "x, lams, _ = fused_gks(A, jnp.asarray(b), FirstDerivative1D(200),\n"
        "    projection_dim=3, n_iter=15, regparam_mode='gcv')\n"
        "xt = np.asarray(x_true).ravel()\n"
        "err = np.linalg.norm(np.asarray(x)-xt)/np.linalg.norm(xt)\n"
        "assert np.asarray(x).dtype == np.float32\n"
        "print('ERR', err, 'LAM', float(lams[-1]))\n"
        "assert err < 0.5, err\n"
        "assert float(lams[-1]) > 1e-4, lams\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr

    xh, lams = fused_hybrid_lsqr(op32, b32, n_iter=25, regparam_mode="dp",
                                 delta=float(delta))
    assert np.isfinite(np.asarray(lams)).all()
    assert np.isfinite(np.asarray(xh)).all()


def test_fused_hybrid_gmres_matches_host():
    from trips_tpu.solvers import Hybrid_GMRES
    from trips_tpu.solvers.fused import fused_hybrid_gmres

    op, A, x_true, b, delta = problem_with_delta()
    for mode, kw in (("gcv", {}), ("dp", {"delta": delta}),
                     ("l_curve", {})):
        x_host, info = Hybrid_GMRES(op, b, n_iter=10, regparam=mode, **kw)
        x_dev, lams = fused_hybrid_gmres(op, jnp.asarray(b), n_iter=10,
                                         regparam_mode=mode,
                                         delta=kw.get("delta", 0.0))
        np.testing.assert_allclose(
            np.asarray(x_dev), np.asarray(x_host).reshape(-1), atol=2e-4,
            err_msg=mode)


def test_fused_f32_all_modes_all_solvers():
    """Pure-f32 subprocess coverage for every regparam mode across every
    fused solver: the on-device L-curve and the
    hybrid rectangular DP are the newest scalar rules; all 16
    (solver x mode) combos must track their f64 trajectories when the
    whole solve runs in float32 (as on the GPU; the subprocesses stay on
    the CPU backend).

    "Track" = selected lam within 2x (both zero allowed: hybrid-LSQR DP
    legitimately keeps lam 0 on this config) and reconstruction error
    within 4x (mmgks-gcv amplifies an already-diverged config ~3.2x; every
    faithful-bad outcome — e.g. hybrid-GMRES DP err ~28 — must be equally
    bad in both precisions, not an f32-only collapse)."""
    import os
    import subprocess
    import sys

    matrix_src = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "{x64}"
        "import numpy as np, jax.numpy as jnp\n"
        "from trips_tpu.problems import Deblurring1D\n"
        "from trips_tpu.solvers.fused import (fused_gks, fused_mmgks,\n"
        "    fused_hybrid_lsqr, fused_hybrid_gmres)\n"
        "from trips_tpu.operators import FirstDerivative1D\n"
        "np.random.seed(11)\n"
        "prob = Deblurring1D()\n"
        "A = prob.forward_Op_1D(30, 200)\n"
        "x_true = prob.gen_xtrue(200, 'curve0')\n"
        "b, delta = prob.add_noise(prob.gen_data(x_true), 'Gaussian', 0.02)\n"
        "b = jnp.asarray(np.asarray(b).reshape(-1))\n"
        "delta = float(delta)\n"
        "L = FirstDerivative1D(200)\n"
        "xt = np.asarray(x_true).ravel()\n"
        "for mode in ('gcv', 'dp', 'l_curve', 'scalar'):\n"
        "    kw = dict(regparam_mode=mode, delta=delta)\n"
        "    if mode == 'scalar': kw['regparam'] = 1e-2\n"
        "    for name, call in (\n"
        "        ('gks', lambda: fused_gks(A, b, L, projection_dim=3,\n"
        "                                  n_iter=15, **kw)),\n"
        "        ('mmgks', lambda: fused_mmgks(A, b, L, pnorm=2, qnorm=1,\n"
        "                          projection_dim=3, n_iter=15, **kw)),\n"
        "        ('hlsqr', lambda: fused_hybrid_lsqr(A, b, n_iter=20, **kw)),\n"
        "        ('hgmres', lambda: fused_hybrid_gmres(A, b, n_iter=20,\n"
        "                                              **kw)),\n"
        "    ):\n"
        "        out = call()\n"
        "        x, lams = out[0], out[1]\n"
        "        assert np.isfinite(np.asarray(x)).all(), (name, mode)\n"
        "        assert np.isfinite(np.asarray(lams)).all(), (name, mode)\n"
        "        assert np.asarray(x).dtype == np.dtype('{dt}'), (name, mode)\n"
        "        err = np.linalg.norm(np.asarray(x)-xt)/np.linalg.norm(xt)\n"
        "        print('COMBO', name, mode, err, float(np.asarray(lams)[-1]))\n"
    )

    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def run_matrix(x64):
        src = matrix_src.format(
            x64="jax.config.update('jax_enable_x64', True)\n" if x64 else "",
            dt="float64" if x64 else "float32")
        r = subprocess.run([sys.executable, "-c", src], capture_output=True,
                           text=True, env=env, cwd=ROOT, timeout=560)
        assert r.returncode == 0, r.stdout + r.stderr
        out = {}
        for line in r.stdout.splitlines():
            if line.startswith("COMBO"):
                _, name, mode, err, lam = line.split()
                out[(name, mode)] = (float(err), float(lam))
        assert len(out) == 16, r.stdout
        return out

    f32 = run_matrix(x64=False)
    f64 = run_matrix(x64=True)
    for combo in f64:
        e32, l32 = f32[combo]
        e64, l64 = f64[combo]
        assert e32 < 4 * max(e64, 0.05), (combo, e32, e64)
        if l64 == 0.0 or l32 == 0.0:
            assert l32 == l64 == 0.0, (combo, l32, l64)
        else:
            assert 0.5 < l32 / l64 < 2.0, (combo, l32, l64)


def test_fused_mmgks_dynamic_weight_modes():
    """Fused isoTV/GS dynamic MMGKS matches the host solver:
    the reference's flagship dynamic modes (MMGKS.py:61-91) run
    entirely inside the fused device loop."""
    from trips_tpu.operators import CenteredSpaceTimeDerivative
    from trips_tpu.problems import generate_synthetic_dynamic
    from trips_tpu.sparse import EllOperator

    A, b, AA, B, nx, ny, nt, delta, x_true = generate_synthetic_dynamic(
        nx=16, nt=4, views=8, noise_level=0.01)
    op = EllOperator.from_scipy(A, dtype=np.float64)
    Ltv = CenteredSpaceTimeDerivative(nx, ny, nt)

    x_host, info = MMGKS(op, b, Ltv, pnorm=2, qnorm=1, projection_dim=4,
                         n_iter=6, regparam="gcv", isoTV="isoTV",
                         prob_dims=(nx, ny, nt))
    x_dev, lams, _ = fused_mmgks(op, jnp.asarray(b), Ltv, pnorm=2.0,
                                 qnorm=1.0, projection_dim=4, n_iter=6,
                                 regparam_mode="gcv", weight_mode="isoTV",
                                 prob_dims=(nx, ny, nt))
    ref = np.asarray(x_host).reshape(-1)
    assert (np.linalg.norm(np.asarray(x_dev) - ref)
            / np.linalg.norm(ref)) < 1e-5

    x_host_gs, _ = MMGKS(op, b, None, pnorm=2, qnorm=1, projection_dim=4,
                         n_iter=6, regparam="gcv", GS="GS",
                         prob_dims=(nx, ny, nt))
    x_dev_gs, lams_gs, _ = fused_mmgks(op, jnp.asarray(b), None, pnorm=2.0,
                                       qnorm=1.0, projection_dim=4, n_iter=6,
                                       regparam_mode="gcv", weight_mode="GS",
                                       prob_dims=(nx, ny, nt))
    ref = np.asarray(x_host_gs).reshape(-1)
    assert (np.linalg.norm(np.asarray(x_dev_gs) - ref)
            / np.linalg.norm(ref)) < 1e-5


def test_fused_mmgks_dynamic_banded_operator():
    """The reference's flagship dynamic reconstruction as ONE device
    program: DynamicBandedOperator as A inside fused_mmgks(isoTV)."""
    from trips_tpu.operators import CenteredSpaceTimeDerivative
    from trips_tpu.problems import generate_synthetic_dynamic
    from trips_tpu.sparse import EllOperator
    from trips_tpu.sparse.dynamic_banded import DynamicBandedOperator

    A, b, AA, B, nx, ny, nt, delta, x_true, angles_list = \
        generate_synthetic_dynamic(nx=16, nt=4, views=8, noise_level=0.01,
                                   return_angles=True)
    op = DynamicBandedOperator.from_frames(AA, nx, angles_list, n_groups=8)
    Ltv = CenteredSpaceTimeDerivative(nx, ny, nt)
    bj = jnp.asarray(b.astype(np.float64))
    x_dev, lams, _ = fused_mmgks(op, bj, Ltv, pnorm=2.0, qnorm=1.0,
                                 projection_dim=4, n_iter=6,
                                 regparam_mode="gcv", weight_mode="isoTV",
                                 prob_dims=(nx, ny, nt))
    # same program with the ELL apply: the banded pack is exact, so the
    # two operators are the same matrix
    op2 = EllOperator.from_scipy(A, dtype=np.float64)
    x_ref, _, _ = fused_mmgks(op2, bj, Ltv, pnorm=2.0, qnorm=1.0,
                              projection_dim=4, n_iter=6,
                              regparam_mode="gcv", weight_mode="isoTV",
                              prob_dims=(nx, ny, nt))
    ref = np.asarray(x_ref)
    assert (np.linalg.norm(np.asarray(x_dev) - ref)
            / np.linalg.norm(ref)) < 1e-4


def test_fused_info_adapters_match_plain(rng):
    """The (x, info) adapters scan the SAME device
    bodies: final x and lambda history are identical to the plain fused
    solvers, and the info dict carries the reference keys
    (GKS.py:97-105)."""
    import jax.numpy as jnp

    from trips_tpu.core import DenseOperator
    from trips_tpu.operators.derivatives import first_derivative_matrix
    from trips_tpu.solvers.fused import (fused_gks, fused_hybrid_gmres,
                                         fused_hybrid_lsqr, fused_mmgks)
    from trips_tpu.solvers.fused_info import (
        fused_gks_info, fused_hybrid_gmres_info, fused_hybrid_lsqr_info,
        fused_mmgks_info)

    n = 40
    Ah = rng.standard_normal((n, n))
    x_true = np.sin(np.linspace(0, 3, n))
    b = Ah @ x_true + 0.01 * rng.standard_normal(n)
    A = DenseOperator(jnp.asarray(Ah))
    L = DenseOperator(jnp.asarray(
        first_derivative_matrix(n).toarray()))
    bj = jnp.asarray(b)
    xt = jnp.asarray(x_true)

    for plain, wrapped, kw in (
            (fused_gks, fused_gks_info, dict(n_iter=6)),
            (fused_mmgks, fused_mmgks_info, dict(n_iter=6)),
    ):
        x0, lam0, res0 = plain(A, bj, L, regparam_mode="gcv", **kw)
        x1, info = wrapped(A, bj, L, regparam_mode="gcv", x_true=xt, **kw)
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x0),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(np.asarray(info["regParam_history"]),
                                   np.asarray(lam0), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(info["Residual"]),
                                   np.asarray(res0), rtol=1e-10)
        assert info["xHistory"].shape == (kw["n_iter"], n)
        np.testing.assert_allclose(np.asarray(info["xHistory"][-1]),
                                   np.asarray(x0), rtol=1e-10, atol=1e-12)
        assert info["relError"].shape == (kw["n_iter"],)
        assert "relResidual" not in info  # Residual here is the reference
        # GKS gradient norm (GKS.py:85-88), not a data residual
        rel_last = float(jnp.linalg.norm(x1 - xt) / jnp.linalg.norm(xt))
        np.testing.assert_allclose(float(info["relError"][-1]), rel_last,
                                   rtol=1e-8)
        assert info["its"] == kw["n_iter"]

    for plain, wrapped, start in (
            (fused_hybrid_lsqr, fused_hybrid_lsqr_info, 1),
            (fused_hybrid_gmres, fused_hybrid_gmres_info, 0)):
        x0, lam0 = plain(A, bj, n_iter=8, regparam_mode="gcv")
        x1, info = wrapped(A, bj, n_iter=8, regparam_mode="gcv", x_true=xt)
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x0),
                                   rtol=1e-10, atol=1e-12)
        # histories are sliced to performed solves: index i of every
        # array refers to the same iteration
        np.testing.assert_allclose(np.asarray(info["regParam_history"]),
                                   np.asarray(lam0)[start:], rtol=1e-10)
        assert (info["regParam_history"].shape == info["Residual"].shape
                == info["relResidual"].shape
                == (info["xHistory"].shape[0],)
                == (info["relError"].shape[0],))
        np.testing.assert_allclose(np.asarray(info["xHistory"][-1]),
                                   np.asarray(x0), rtol=1e-10, atol=1e-12)
        # projected residual identity: ||A x - b|| == ||B y - bhat||
        true_res = float(jnp.linalg.norm(A.matvec(x1) - bj))
        np.testing.assert_allclose(float(info["Residual"][-1]), true_res,
                                   rtol=1e-6)

"""Multi-device sharding tests on the simulated 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import sparse as sp

from trips_tpu.core import DenseOperator
from trips_tpu.krylov import cgls
from trips_tpu.operators import SpaceTimeDerivative
from trips_tpu.parallel import ShardedDynamicOperator, ShardedEllOperator, make_mesh
from trips_tpu.problems import generate_synthetic_dynamic
from trips_tpu.sparse import EllOperator


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh({"rows": 8})


@pytest.fixture(scope="module")
def mesh24():
    return make_mesh({"time": 2, "rows": 4})


def test_sharded_ell_matches_dense(rng, mesh8):
    A = sp.random(96, 120, density=0.1, format="csr", random_state=np.random.RandomState(5))
    op = EllOperator.from_scipy(A)
    sop = ShardedEllOperator.from_ell(op, mesh8)
    x = rng.standard_normal(120)
    y = rng.standard_normal(96)
    got = np.asarray(sop.matvec(jnp.asarray(x)))[:96]
    np.testing.assert_allclose(got, A @ x, atol=1e-12)
    got_t = np.asarray(sop.rmatvec(jnp.asarray(np.pad(y, (0, sop.shape[0] - 96)))))[:120]
    np.testing.assert_allclose(got_t, A.T @ y, atol=1e-12)


def test_sharded_cgls(rng, mesh8):
    """Full fused CGLS over the sharded operator: collectives inside jit."""
    m = n = 96
    A = sp.random(m, n, density=0.2, format="csr", random_state=np.random.RandomState(6))
    A = A + sp.identity(n)  # well-posed
    op = EllOperator.from_scipy(A.tocsr())
    sop = ShardedEllOperator.from_ell(op, mesh8)
    xt = rng.standard_normal(n)
    b = A @ xt
    x, k = cgls(sop, jnp.asarray(b), jnp.zeros(n), 300, 1e-12)
    assert np.linalg.norm(np.asarray(x)[:n] - xt) / np.linalg.norm(xt) < 1e-6


def test_sharded_dynamic_operator(rng, mesh24):
    A, b, AA, B, nx, ny, nt, delta, x_true = generate_synthetic_dynamic(
        nx=16, nt=4, views=8, noise_level=0.0
    )
    sop = ShardedDynamicOperator.from_blocks(AA, mesh24)
    x = rng.standard_normal(sop.shape[1])
    y = rng.standard_normal(sop.shape[0])
    np.testing.assert_allclose(np.asarray(sop.matvec(jnp.asarray(x))), A @ x, atol=1e-10)
    np.testing.assert_allclose(np.asarray(sop.rmatvec(jnp.asarray(y))), A.T @ y, atol=1e-10)


def test_sharded_dynamic_cgls_with_tv(rng, mesh24):
    """One regularized dynamic step: SpMV fwd/adj + spacetime-TV halo +
    global reductions, jitted over the 2-D mesh."""
    A, b, AA, B, nx, ny, nt, delta, x_true = generate_synthetic_dynamic(
        nx=16, nt=4, views=8, noise_level=0.01
    )
    sop = ShardedDynamicOperator.from_blocks(AA, mesh24)
    L = SpaceTimeDerivative(nx, ny, nt)
    lam = 0.01

    @jax.jit
    def step(op, bv, x):
        r = op.matvec(x) - bv
        g = op.rmatvec(r) + lam * L.rmatvec(L.matvec(x))
        alpha = jnp.vdot(r, op.matvec(g)) / (jnp.vdot(g, g) + 1e-30)
        return x - 0.01 * g, jnp.linalg.norm(g)

    x = jnp.zeros(sop.shape[1])
    bv = jnp.asarray(b)
    for _ in range(3):
        x, gn = step(sop, bv, x)
    assert np.isfinite(float(gn))


def test_gks_with_sharded_operator(rng, mesh8):
    """GKS end-to-end over a row-sharded device operator."""
    from trips_tpu.operators import FirstDerivative1D
    from trips_tpu.solvers import GKS

    n = 96
    rngs = np.random.RandomState(3)
    D = np.diag(np.logspace(0, -3, n))
    Q1, _ = np.linalg.qr(rngs.randn(n, n))
    Q2, _ = np.linalg.qr(rngs.randn(n, n))
    A = Q1 @ D @ Q2.T
    xt = np.sin(np.linspace(0, 3, n))
    b = A @ xt + 0.01 * rngs.randn(n)
    op = EllOperator.from_dense(A)
    sop = ShardedEllOperator.from_ell(op, mesh8)
    L = FirstDerivative1D(n)
    x0, info0 = GKS(op, jnp.asarray(b), L, projection_dim=3, n_iter=8,
                    regparam="gcv")
    x, info = GKS(sop, jnp.asarray(b), L, projection_dim=3, n_iter=8,
                  regparam="gcv")
    # sharded run reproduces the single-device run
    np.testing.assert_allclose(
        np.asarray(x).reshape(-1), np.asarray(x0).reshape(-1), atol=1e-6
    )


def test_batched_frame_solve(rng):
    from trips_tpu.operators import FirstDerivative2D
    from trips_tpu.parallel.batched import batched_frame_solve
    from trips_tpu.problems import generate_synthetic_dynamic

    A, b, AA, B, nx, ny, nt, delta, x_true = generate_synthetic_dynamic(
        nx=16, nt=4, views=10, noise_level=0.01
    )
    L = FirstDerivative2D(nx, ny)
    X = batched_frame_solve(AA, B, L, solver="mmgks", projection_dim=3,
                            n_iter=6, use_gcv=True)
    X = np.asarray(X)
    assert X.shape == (nt, nx * ny)
    xt = np.asarray(x_true).reshape(nt, -1)
    errs = [np.linalg.norm(X[t] - xt[t]) / np.linalg.norm(xt[t]) for t in range(nt)]
    assert max(errs) < 0.8


def test_pod_mesh_single_process():
    from trips_tpu.parallel import pod_mesh

    mesh = pod_mesh(time_shards=2)
    assert mesh.shape == {"time": 2, "rows": 4}


# ---- sharded BSR: the multi-chip path on the fast format --

def test_sharded_bsr_matches_scipy(rng, mesh8):
    from trips_tpu.parallel import ShardedBsrOperator

    A = sp.random(96, 250, density=0.1, format="csr",
                  random_state=np.random.RandomState(5)).astype(np.float32)
    op = ShardedBsrOperator.from_scipy(A, mesh8, block_shape=(8, 16))
    x = np.zeros(op.shape[1], np.float32)
    x[:250] = rng.standard_normal(250).astype(np.float32)
    y = rng.standard_normal(op.shape[0]).astype(np.float32)
    got = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got[:96], A @ x[:250], atol=1e-5)
    assert np.abs(got[96:]).max(initial=0.0) == 0.0
    gt = np.asarray(op.rmatvec(jnp.asarray(y)))
    np.testing.assert_allclose(gt[:250], A.T @ y[:96], atol=1e-5)
    assert np.abs(gt[250:]).max(initial=0.0) == 0.0


def test_sharded_bsr_cgls(rng, mesh8):
    """Fused CGLS over the sharded BSR operator (collectives inside jit)."""
    from trips_tpu.parallel import ShardedBsrOperator

    m = n = 96
    A = sp.random(m, n, density=0.2, format="csr",
                  random_state=np.random.RandomState(6))
    A = (A + sp.identity(n)).tocsr()
    op = ShardedBsrOperator.from_scipy(A, mesh8, block_shape=(8, 16))
    xt = rng.standard_normal(n)
    b = np.zeros(op.shape[0], np.float32)
    b[:m] = (A @ xt).astype(np.float32)
    x, k = cgls(op, jnp.asarray(b), jnp.zeros(op.shape[1], jnp.float32),
                300, 1e-12)
    assert np.linalg.norm(np.asarray(x)[:n] - xt) / np.linalg.norm(xt) < 1e-4


def test_sharded_dynamic_bsr(rng, mesh24):
    from trips_tpu.parallel import ShardedDynamicBsrOperator

    A, b, AA, B, nx, ny, nt, delta, x_true = generate_synthetic_dynamic(
        nx=16, nt=4, views=8, noise_level=0.0
    )
    sop = ShardedDynamicBsrOperator.from_blocks(AA, mesh24,
                                                block_shape=(8, 32))
    x = rng.standard_normal(sop.shape[1]).astype(np.float32)
    y = rng.standard_normal(sop.shape[0]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(sop.matvec(jnp.asarray(x))),
                               A @ x, atol=1e-4)
    np.testing.assert_allclose(np.asarray(sop.rmatvec(jnp.asarray(y))),
                               A.T @ y, atol=1e-4)


def test_sharded_dynamic_bsr_cgls_with_tv(rng, mesh24):
    """Regularized dynamic step over the BSR-sharded operator: SpMV fwd/adj
    + spacetime-TV halo + global reductions jitted over the 2-D mesh."""
    from trips_tpu.parallel import ShardedDynamicBsrOperator

    A, b, AA, B, nx, ny, nt, delta, x_true = generate_synthetic_dynamic(
        nx=16, nt=4, views=8, noise_level=0.01
    )
    sop = ShardedDynamicBsrOperator.from_blocks(AA, mesh24,
                                                block_shape=(8, 32))
    L = SpaceTimeDerivative(nx, ny, nt)
    lam = 0.01

    @jax.jit
    def step(op, bv, x):
        r = op.matvec(x) - bv
        g = op.rmatvec(r) + lam * L.rmatvec(L.matvec(x))
        return x - 0.01 * g, jnp.linalg.norm(g)

    x = jnp.zeros(sop.shape[1], jnp.float32)
    bv = jnp.asarray(b, jnp.float32)
    for _ in range(3):
        x, gn = step(sop, bv, x)
    assert np.isfinite(float(gn))


def test_sharded_bsr_bf16_blocks(rng, mesh8):
    """bf16 block storage on the sharded path (the quantized class)."""
    from trips_tpu.parallel import ShardedBsrOperator

    A = sp.random(96, 128, density=0.15, format="csr",
                  random_state=np.random.RandomState(9)).astype(np.float32)
    op = ShardedBsrOperator.from_scipy(A, mesh8, block_shape=(8, 16),
                                       block_dtype=jnp.bfloat16)
    x = np.zeros(op.shape[1], np.float32)
    x[:128] = rng.standard_normal(128).astype(np.float32)
    got = np.asarray(op.matvec(jnp.asarray(x)))[:96]
    ref = A @ x[:128]
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 2e-2, rel


def test_sharded_banded_projector(rng, mesh8):
    """Angle-sharded banded projector (the champion single-chip format):
    forward/adjoint match scipy exactly through shard_map + psum."""
    from trips_tpu.problems.projector import fan_beam_matrix
    from trips_tpu.parallel import ShardedBandedProjector
    from trips_tpu.sparse import BandedProjector

    nx, views = 32, 12
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    op = BandedProjector.from_scipy_fan(A, nx, views, n_groups=8)
    sop = ShardedBandedProjector.from_banded(op, mesh8)
    x = rng.standard_normal(sop.shape[1]).astype(np.float32)
    y = rng.standard_normal(sop.shape[0]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(sop.matvec(jnp.asarray(x))),
                               A @ x, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sop.rmatvec(jnp.asarray(y))),
                               A.T @ y, atol=2e-5)


def test_sharded_banded_cgls_recon(rng, mesh8):
    """CGLS reconstruction through the angle-sharded projector inside jit
    (collectives live in the loop) reproduces the single-device solve."""
    from trips_tpu.problems.projector import fan_beam_matrix
    from trips_tpu.problems.phantoms import shepp_logan
    from trips_tpu.parallel import ShardedBandedProjector
    from trips_tpu.sparse import BandedProjector

    nx, views = 32, 24
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    op = BandedProjector.from_scipy_fan(A, nx, views, n_groups=8)
    sop = ShardedBandedProjector.from_banded(op, mesh8)
    xt = shepp_logan(nx).reshape(-1).astype(np.float32)
    b = jnp.asarray(A @ xt)
    x_s, _ = cgls(sop, b, jnp.zeros(sop.shape[1], jnp.float32), 40, 0.0)
    x_1, _ = cgls(op, b, jnp.zeros(op.shape[1], jnp.float32), 40, 0.0)
    # psum reduction order differs from the serial dot, and 40 CGLS
    # iterations on an ill-posed system amplify the f32 difference:
    # compare reconstruction quality, not iterates (SURVEY §7.3)
    err_s = np.linalg.norm(np.asarray(x_s) - xt) / np.linalg.norm(xt)
    err_1 = np.linalg.norm(np.asarray(x_1) - xt) / np.linalg.norm(xt)
    assert abs(err_s - err_1) < 0.01, (err_s, err_1)
    assert err_s < 0.5, err_s  # semiconverged at 40 iters, not diverged


def test_batched_frame_solve_dp(rng):
    """Batched per-frame solves with the on-device DP rule (all four
    regparam modes vmap over frames)."""
    from trips_tpu.operators import FirstDerivative2D
    from trips_tpu.parallel.batched import batched_frame_solve
    from trips_tpu.problems import generate_synthetic_dynamic

    A, b, AA, B, nx, ny, nt, delta, x_true = generate_synthetic_dynamic(
        nx=16, nt=4, views=10, noise_level=0.01
    )
    L = FirstDerivative2D(nx, ny)
    X = batched_frame_solve(AA, B, L, solver="gks", projection_dim=3,
                            n_iter=6, regparam_mode="dp",
                            delta=float(delta) / nt)
    X = np.asarray(X)
    assert X.shape == (nt, nx * ny)
    assert np.isfinite(X).all()


def test_sharded_banded_normal_matvec(rng, mesh8):
    """Fused normal apply on the angle-sharded projector (local A^T A per
    slab + one psum) matches scipy A.T @ (A @ x), and cgls_normal over the
    sharded operator reproduces the standard sharded CGLS solve."""
    from trips_tpu.krylov import cgls, cgls_normal
    from trips_tpu.parallel import ShardedBandedProjector
    from trips_tpu.problems.projector import fan_beam_matrix
    from trips_tpu.sparse import BandedProjector

    nx, views = 32, 16
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    op = BandedProjector.from_scipy_fan(A, nx, views, n_groups=8)
    sop = ShardedBandedProjector.from_banded(op, mesh8)
    x = rng.standard_normal(sop.shape[1]).astype(np.float32)
    got = np.asarray(sop.normal_matvec(jnp.asarray(x)))
    ref = A.T @ (A @ x)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)

    xt = rng.random(nx * nx).astype(np.float32)
    b = jnp.asarray(A @ xt)
    x0 = jnp.zeros(sop.shape[1], jnp.float32)
    x_n, _ = cgls_normal(sop, b, x0, 20, 0.0)
    x_s, _ = cgls(sop, b, x0, 20, 0.0)
    d = np.linalg.norm(np.asarray(x_n) - np.asarray(x_s))
    assert d < 2e-2 * np.linalg.norm(np.asarray(x_s)), d


def test_sharded_dynamic_banded(rng, mesh8):
    """(time x angles)-sharded dynamic banded operator on a 2x4 mesh:
    forward/adjoint/fused normal match the scipy block-diag oracle of the
    frame-varying problem; cgls_normal runs over the full dynamic mesh."""
    from scipy import sparse as sp

    from trips_tpu.krylov import cgls_normal
    from trips_tpu.parallel import make_mesh
    from trips_tpu.parallel.sharded_dynamic_banded import (
        ShardedDynamicBandedOperator)
    from trips_tpu.problems import generate_synthetic_dynamic
    from trips_tpu.sparse import DynamicBandedOperator

    A, b, AA, B, nx, ny, nt, delta, x_true, angles_list = \
        generate_synthetic_dynamic(nx=32, nt=4, views=10,
                                   noise_level=0.01, return_angles=True)
    import jax

    dop = DynamicBandedOperator.from_frames(AA, nx, angles_list,
                                            n_groups=8)
    mesh = make_mesh({"time": 2, "angles": 4}, devices=jax.devices()[:8])
    sop = ShardedDynamicBandedOperator.from_dynamic(dop, mesh)
    Afull = sp.block_diag(AA, format="csr")
    x = rng.standard_normal(sop.shape[1]).astype(np.float32)
    y = rng.standard_normal(sop.shape[0]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(sop.matvec(jnp.asarray(x))),
                               Afull @ x, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(sop.rmatvec(jnp.asarray(y))),
                               Afull.T @ y, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(sop.normal_matvec(jnp.asarray(x))),
        Afull.T @ (Afull @ x), rtol=2e-4, atol=5e-4)
    xr, k = cgls_normal(sop, jnp.asarray(b.astype(np.float32)),
                        jnp.zeros(sop.shape[1], jnp.float32), 20, 0.0)
    err = np.linalg.norm(np.asarray(xr) - x_true) / np.linalg.norm(x_true)
    assert err < 0.6, err


def test_sharded_banded_single_psum_per_apply(rng, mesh8):
    """Pin the collective count: the merged
    single-program applies issue exactly ONE psum per normal/adjoint apply
    (both drive groups summed locally first) and none in the forward."""
    from trips_tpu.parallel import ShardedBandedProjector
    from trips_tpu.problems.projector import fan_beam_matrix
    from trips_tpu.sparse.banded import BandedProjector

    nx, views = 16, 8
    A = fan_beam_matrix(nx, views=views)
    op = BandedProjector.from_scipy_fan(A, nx, views=views, n_groups=8)
    sop = ShardedBandedProjector.from_banded(op, mesh8)
    assert len(sop._active()) == 2  # both drive groups present

    def count_psums(fn, arg):
        return str(jax.make_jaxpr(fn)(arg)).count("psum")

    x = jnp.asarray(rng.standard_normal(sop.shape[1]).astype(np.float32))
    y = jnp.asarray(rng.standard_normal(sop.shape[0]).astype(np.float32))
    assert count_psums(sop.normal_matvec, x) == 1
    assert count_psums(sop.rmatvec, y) == 1
    assert count_psums(sop.matvec, x) == 0


def test_sharded_dynamic_banded_single_psum_per_apply(rng):
    """Same pin for the (time x angles) dynamic operator."""
    from trips_tpu.parallel import make_mesh
    from trips_tpu.parallel.sharded_dynamic_banded import (
        ShardedDynamicBandedOperator)
    from trips_tpu.problems import generate_synthetic_dynamic
    from trips_tpu.sparse.dynamic_banded import DynamicBandedOperator

    A, b, AA, B, nx, ny, nt, delta, x_true, angles_list = \
        generate_synthetic_dynamic(nx=16, nt=4, views=8, noise_level=0.0,
                                   return_angles=True)
    dop = DynamicBandedOperator.from_frames(AA, nx, angles_list, n_groups=8)
    mesh = make_mesh({"time": 2, "angles": 4})
    sop = ShardedDynamicBandedOperator.from_dynamic(dop, mesh)

    def count_psums(fn, arg):
        return str(jax.make_jaxpr(fn)(arg)).count("psum")

    x = jnp.asarray(rng.standard_normal(sop.shape[1]).astype(np.float32))
    y = jnp.asarray(rng.standard_normal(sop.shape[0]).astype(np.float32))
    assert count_psums(sop.normal_matvec, x) == 1
    assert count_psums(sop.rmatvec, y) == 1
    assert count_psums(sop.matvec, x) == 0


def test_sharded_bucketed_banded_projector(rng, mesh8):
    """Angle-sharded Ta-bucketed pack on the mesh: forward/adjoint/normal match scipy, and the
    single-psum-per-apply economy survives the bucketing (jaxpr pin)."""
    from trips_tpu.parallel import ShardedBucketedBandedProjector
    from trips_tpu.problems.projector import fan_beam_matrix
    from trips_tpu.sparse.banded_buckets import BucketedBandedProjector

    nx, views = 32, 12
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    op = BucketedBandedProjector.from_scipy_fan(A, nx, views, n_groups=8,
                                               n_buckets=3)
    sop = ShardedBucketedBandedProjector.from_bucketed(op, mesh8,
                                                       axis="rows")
    x = rng.standard_normal(sop.shape[1]).astype(np.float32)
    y = rng.standard_normal(sop.shape[0]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(sop.matvec(jnp.asarray(x))),
                               A @ x, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sop.rmatvec(jnp.asarray(y))),
                               A.T @ y, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(sop.normal_matvec(jnp.asarray(x))),
        A.T @ (A @ x), rtol=2e-4, atol=2e-4)

    def count_psums(fn, arg):
        return str(jax.make_jaxpr(fn)(arg)).count("psum")

    xj = jnp.asarray(x)
    yj = jnp.asarray(y)
    assert count_psums(sop.normal_matvec, xj) == 1
    assert count_psums(sop.rmatvec, yj) == 1
    assert count_psums(sop.matvec, xj) == 0


def test_sharded_bucketed_dynamic_banded(rng):
    """(time x angles)-sharded bucketed dynamic operator: parity vs the
    scipy block-diag system plus the single-psum jaxpr pin."""
    from trips_tpu.krylov import cgls_normal
    from trips_tpu.parallel import ShardedBucketedDynamicBandedOperator
    from trips_tpu.problems import generate_synthetic_dynamic
    from trips_tpu.sparse.dynamic_banded import BucketedDynamicBandedOperator

    A, b, AA, B, nx, ny, nt, delta, x_true, angles_list = \
        generate_synthetic_dynamic(nx=16, nt=4, views=8, noise_level=0.0,
                                   return_angles=True)
    dop = BucketedDynamicBandedOperator.from_frames(
        AA, nx, angles_list, n_groups=8, n_buckets=2)
    mesh = make_mesh({"time": 2, "angles": 4})
    sop = ShardedBucketedDynamicBandedOperator.from_dynamic(dop, mesh)
    Afull = sp.block_diag(AA, format="csr")
    x = rng.standard_normal(sop.shape[1]).astype(np.float32)
    y = rng.standard_normal(sop.shape[0]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(sop.matvec(jnp.asarray(x))),
                               Afull @ x, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(sop.rmatvec(jnp.asarray(y))),
                               Afull.T @ y, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(sop.normal_matvec(jnp.asarray(x))),
        Afull.T @ (Afull @ x), rtol=2e-4, atol=5e-4)
    xr, k = cgls_normal(sop, jnp.asarray(b.astype(np.float32)),
                        jnp.zeros(sop.shape[1], jnp.float32), 20, 0.0)
    err = np.linalg.norm(np.asarray(xr) - x_true) / np.linalg.norm(x_true)
    assert err < 0.6, err

    def count_psums(fn, arg):
        return str(jax.make_jaxpr(fn)(arg)).count("psum")

    xj = jnp.asarray(x)
    yj = jnp.asarray(y)
    assert count_psums(sop.normal_matvec, xj) == 1
    assert count_psums(sop.rmatvec, yj) == 1
    assert count_psums(sop.matvec, xj) == 0


def test_hlo_collective_audit(rng, mesh8):
    """The compiled-HLO collective audit (bench/hlo_audit.py) measures
    exactly one all-reduce of n_pad^2 f32 per adjoint/normal apply on the
    sharded bucketed projector."""
    from trips_tpu.bench.hlo_audit import audit_operator
    from trips_tpu.parallel import ShardedBucketedBandedProjector
    from trips_tpu.problems.projector import fan_beam_matrix
    from trips_tpu.sparse.banded_buckets import BucketedBandedProjector

    nx, views = 16, 8
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    op = BucketedBandedProjector.from_scipy_fan(A, nx, views, n_groups=8,
                                                n_buckets=2)
    sop = ShardedBucketedBandedProjector.from_bucketed(op, mesh8,
                                                       axis="rows")
    audit = audit_operator(sop)
    for apply_name in ("rmatvec", "normal_matvec"):
        ar = audit[apply_name]["collectives"]["all-reduce"]
        assert ar["count"] == 1, audit[apply_name]
        assert ar["bytes"] == op.n_pad * op.n_pad * 4, audit[apply_name]
    # the forward's only collective is the output assembly (sinogram-sized,
    # not weight-sized)
    fwd_bytes = audit["matvec"]["total_bytes"]
    assert fwd_bytes <= 4 * sop.shape[0] * 8, audit["matvec"]


def test_streamed_dynamic_matches_resident(rng):
    """Out-of-core streamed dynamic operator: the
    two-slot host->device pipeline reproduces the resident block-diag
    system exactly, and streamed CGLS matches the fused resident solve."""
    from trips_tpu.krylov import cgls_normal
    from trips_tpu.parallel import (StreamedDynamicBandedOperator,
                                    cgls_normal_streamed)
    from trips_tpu.problems import generate_synthetic_dynamic
    from trips_tpu.sparse import BandedProjector
    from trips_tpu.sparse.dynamic_banded import DynamicBandedOperator

    A, b, AA, B, nx, ny, nt, delta, x_true, angles_list = \
        generate_synthetic_dynamic(nx=16, nt=3, views=8, noise_level=0.0,
                                   return_angles=True)
    frame_ops = [
        BandedProjector.from_scipy_fan(AA[t], nx, len(angles_list[t]),
                                       angles=angles_list[t], n_groups=8)
        for t in range(nt)]
    sop = StreamedDynamicBandedOperator(frame_ops)
    Afull = sp.block_diag(AA, format="csr")
    assert sop.shape == Afull.shape
    x = rng.standard_normal(sop.shape[1]).astype(np.float32)
    y = rng.standard_normal(sop.shape[0]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(sop.matvec(jnp.asarray(x))),
                               Afull @ x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sop.rmatvec(jnp.asarray(y))),
                               Afull.T @ y, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(sop.normal_matvec(jnp.asarray(x))),
        Afull.T @ (Afull @ x), rtol=2e-4, atol=2e-4)
    # streamed CGLS vs the fused resident solve on the same system
    dop = DynamicBandedOperator.from_frames(AA, nx, angles_list,
                                            n_groups=8)
    bj = jnp.asarray(b, jnp.float32)
    # pre-convergence the trajectories track to f32 roundoff (the streamed
    # normal apply is bitwise-equal to the resident one; only XLA fusion
    # boundaries differ). At the convergence floor of this tiny noise-free
    # system the drift is chaotic-amplified — bound it loosely there.
    for iters, tol in ((8, 1e-4), (15, 5e-3)):
        xs, _ = cgls_normal_streamed(
            sop, bj, jnp.zeros(sop.shape[1], jnp.float32), iters)
        xr, _ = cgls_normal(dop, bj, jnp.zeros(dop.shape[1], jnp.float32),
                            iters, 0.0)
        rel = (np.linalg.norm(np.asarray(xs) - np.asarray(xr))
               / np.linalg.norm(np.asarray(xr)))
        assert rel < tol, (iters, rel)


def test_sharded_int8_bucketed_static(rng, mesh8):
    """int8 bucketed pack sharded over the mesh (r5: the champion format's
    multi-chip path carries the scales): parity vs the dequantized matrix
    and the single-psum jaxpr pin."""
    from trips_tpu.parallel import ShardedBucketedBandedProjector
    from trips_tpu.problems.projector import fan_beam_matrix
    from trips_tpu.sparse.banded_buckets import BucketedBandedProjector

    nx, views = 32, 12
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    op8 = BucketedBandedProjector.from_scipy_fan(
        A, nx, views, n_groups=8, n_buckets=2, dtype="int8")
    M8 = op8.to_scipy()
    sop = ShardedBucketedBandedProjector.from_bucketed(op8, mesh8,
                                                       axis="rows")
    x = rng.standard_normal(sop.shape[1]).astype(np.float32)
    y = rng.standard_normal(sop.shape[0]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(sop.matvec(jnp.asarray(x))),
                               M8 @ x, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(sop.rmatvec(jnp.asarray(y))),
                               M8.T @ y, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(sop.normal_matvec(jnp.asarray(x))),
        M8.T @ (M8 @ x), rtol=5e-4, atol=5e-4)

    def count_psums(fn, arg):
        return str(jax.make_jaxpr(fn)(arg)).count("psum")

    assert count_psums(sop.normal_matvec, jnp.asarray(x)) == 1
    assert count_psums(sop.rmatvec, jnp.asarray(y)) == 1


def test_sharded_int8_bucketed_dynamic(rng):
    """(time x angles)-sharded int8 dynamic pack: parity vs the
    dequantized block-diag system; single psum per normal apply."""
    from trips_tpu.parallel import ShardedBucketedDynamicBandedOperator
    from trips_tpu.problems import generate_synthetic_dynamic
    from trips_tpu.sparse.dynamic_banded import BucketedDynamicBandedOperator

    A, b, AA, B, nx, ny, nt, delta, x_true, al = \
        generate_synthetic_dynamic(nx=16, nt=4, views=8, noise_level=0.0,
                                   return_angles=True)
    dop8 = BucketedDynamicBandedOperator.from_frames(
        AA, nx, al, n_groups=8, n_buckets=2, dtype="int8")
    mesh = make_mesh({"time": 2, "angles": 4})
    sop = ShardedBucketedDynamicBandedOperator.from_dynamic(dop8, mesh)
    x = rng.standard_normal(sop.shape[1]).astype(np.float32)
    y = rng.standard_normal(sop.shape[0]).astype(np.float32)
    # oracle: the single-chip int8 operator (same quantized matrix)
    np.testing.assert_allclose(np.asarray(sop.matvec(jnp.asarray(x))),
                               np.asarray(dop8.matvec(jnp.asarray(x))),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(sop.rmatvec(jnp.asarray(y))),
                               np.asarray(dop8.rmatvec(jnp.asarray(y))),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(sop.normal_matvec(jnp.asarray(x))),
        np.asarray(dop8.normal_matvec(jnp.asarray(x))),
        rtol=5e-4, atol=5e-4)

    def count_psums(fn, arg):
        return str(jax.make_jaxpr(fn)(arg)).count("psum")

    assert count_psums(sop.normal_matvec, jnp.asarray(x)) == 1

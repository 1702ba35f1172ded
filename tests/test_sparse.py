"""Sparse operator correctness vs scipy oracles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import sparse as sp

from trips_tpu.core import (
    BatchedBlockDiagOperator,
    BlockDiagOperator,
    DenseOperator,
    IdentityOperator,
    VStackOperator,
)
from trips_tpu.sparse import BsrOperator, EllOperator


def random_sparse(rng, m, n, density=0.05):
    return sp.random(m, n, density=density, format="csr", random_state=np.random.RandomState(7))


@pytest.mark.parametrize("cls,kw", [(EllOperator, {}), (BsrOperator, {"bs": 16})])
def test_spmv_matches_scipy(rng, cls, kw):
    A = random_sparse(rng, 123, 87)
    op = cls.from_scipy(A, **kw)
    x = rng.standard_normal(87)
    y = rng.standard_normal(123)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), A @ x, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.rmatvec(jnp.asarray(y))), A.T @ y, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("cls,kw", [(EllOperator, {}), (BsrOperator, {"bs": 16})])
def test_spmm_matches_scipy(rng, cls, kw):
    A = random_sparse(rng, 64, 150)
    op = cls.from_scipy(A, **kw)
    X = rng.standard_normal((150, 5))
    Y = rng.standard_normal((64, 3))
    np.testing.assert_allclose(np.asarray(op.matmat(jnp.asarray(X))), A @ X, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.rmatmat(jnp.asarray(Y))), A.T @ Y, rtol=1e-10, atol=1e-12)


def test_spmv_under_jit(rng):
    A = random_sparse(rng, 40, 40)
    op = EllOperator.from_scipy(A)
    x = rng.standard_normal(40)

    @jax.jit
    def f(op, x):
        return op.matvec(x)

    np.testing.assert_allclose(np.asarray(f(op, jnp.asarray(x))), A @ x, rtol=1e-10, atol=1e-12)


def test_empty_blockrow_bsr(rng):
    A = sp.csr_matrix((48, 48))
    A[0, 0] = 1.0
    A[40, 3] = 2.0
    op = BsrOperator.from_scipy(A.tocsr(), bs=16)
    x = rng.standard_normal(48)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), A @ x, atol=1e-12)


def test_combinators(rng):
    A = rng.standard_normal((10, 8))
    B = rng.standard_normal((6, 8))
    opA, opB = DenseOperator(A), DenseOperator(B)
    x = rng.standard_normal(8)

    stack = VStackOperator([opA, opB])
    np.testing.assert_allclose(np.asarray(stack @ x), np.concatenate([A @ x, B @ x]), atol=1e-12)
    y = rng.standard_normal(16)
    np.testing.assert_allclose(np.asarray(stack.T @ y), A.T @ y[:10] + B.T @ y[10:], atol=1e-12)

    bd = BlockDiagOperator([opA, opB])
    z = rng.standard_normal(16)
    np.testing.assert_allclose(
        np.asarray(bd @ z), np.concatenate([A @ z[:8], B @ z[8:]]), atol=1e-12
    )

    bbd = BatchedBlockDiagOperator(opA, 3)
    w = rng.standard_normal(24)
    expect = np.concatenate([A @ w[:8], A @ w[8:16], A @ w[16:]])
    np.testing.assert_allclose(np.asarray(bbd @ w), expect, atol=1e-12)
    yy = rng.standard_normal(30)
    expect_t = np.concatenate([A.T @ yy[:10], A.T @ yy[10:20], A.T @ yy[20:]])
    np.testing.assert_allclose(np.asarray(bbd.T @ yy), expect_t, atol=1e-12)

    ident = IdentityOperator(8)
    np.testing.assert_allclose(np.asarray(ident @ x), x)
    comp = opA @ ident
    np.testing.assert_allclose(np.asarray(comp @ x), A @ x, atol=1e-12)
    scaled = 2.5 * opA
    np.testing.assert_allclose(np.asarray(scaled @ x), 2.5 * (A @ x), atol=1e-12)


def test_bf16_blocks_reconstruction_parity(rng):
    """bf16 block storage (the bench fast path) must not change noisy-data
    reconstructions materially (noise floor >> bf16 operator error)."""
    import jax.numpy as jnp

    from trips_tpu.krylov import cgls
    from trips_tpu.problems.phantoms import tectonic
    from trips_tpu.problems.projector import fan_beam_matrix

    nx, views = 32, 20
    Af = fan_beam_matrix(nx, views=views).astype(np.float32)
    xt = tectonic(nx).reshape(-1).astype(np.float32)
    b_true = Af @ xt
    e = rng.standard_normal(len(b_true)).astype(np.float32)
    b = b_true + 0.01 * np.linalg.norm(b_true) / np.linalg.norm(e) * e
    op32 = BsrOperator.from_scipy(Af, block_shape=(16, 32))
    op16 = BsrOperator.from_scipy(Af, block_shape=(16, 32),
                                  block_dtype=jnp.bfloat16)
    x32, _ = cgls(op32, jnp.asarray(b), jnp.zeros(nx * nx, jnp.float32), 20, 0.0)
    x16, _ = cgls(op16, jnp.asarray(b), jnp.zeros(nx * nx, jnp.float32), 20, 0.0)
    rel = np.linalg.norm(np.asarray(x16) - np.asarray(x32)) / np.linalg.norm(np.asarray(x32))
    assert rel < 0.03


def test_int8_blocks_quantized_apply(rng):
    """int8 per-block quantization: applies match scipy within the
    blockmax/254 quantization budget, and noisy reconstructions track the
    f32 path (same regime as the bf16 test; int8 halves the stream again)."""
    import jax.numpy as jnp

    from trips_tpu.krylov import cgls
    from trips_tpu.problems.phantoms import tectonic
    from trips_tpu.problems.projector import fan_beam_matrix

    A = random_sparse(rng, 123, 87).astype(np.float32)
    op = BsrOperator.from_scipy(A, block_shape=(8, 32), block_dtype=jnp.int8)
    assert op.blocks.dtype == jnp.int8 and op.quant_scale is not None
    x = rng.standard_normal(87).astype(np.float32)
    y = rng.standard_normal(123).astype(np.float32)
    ref = A @ x
    got = np.asarray(op.matvec(jnp.asarray(x)))
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.02
    refT = A.T @ y
    gotT = np.asarray(op.rmatvec(jnp.asarray(y)))
    assert np.linalg.norm(gotT - refT) / np.linalg.norm(refT) < 0.02

    nx, views = 32, 20
    Af = fan_beam_matrix(nx, views=views).astype(np.float32)
    xt = tectonic(nx).reshape(-1).astype(np.float32)
    b_true = Af @ xt
    e = rng.standard_normal(len(b_true)).astype(np.float32)
    b = b_true + 0.01 * np.linalg.norm(b_true) / np.linalg.norm(e) * e
    op32 = BsrOperator.from_scipy(Af, block_shape=(16, 32))
    op8 = BsrOperator.from_scipy(Af, block_shape=(16, 32),
                                 block_dtype=jnp.int8)
    x32, _ = cgls(op32, jnp.asarray(b), jnp.zeros(nx * nx, jnp.float32), 20, 0.0)
    x8, _ = cgls(op8, jnp.asarray(b), jnp.zeros(nx * nx, jnp.float32), 20, 0.0)
    rel = (np.linalg.norm(np.asarray(x8) - np.asarray(x32))
           / np.linalg.norm(np.asarray(x32)))
    assert rel < 0.05


def test_int8_todense_not_zero(rng):
    """Regression: todense()/to_scipy() on an
    int8-quantized BsrOperator must reconstruct the matrix, not an all-zero
    int8 cast. The computation dtype of a quantized operator is float32."""
    import jax.numpy as jnp

    A = random_sparse(rng, 64, 48).astype(np.float32)
    op = BsrOperator.from_scipy(A, block_shape=(8, 32), block_dtype=jnp.int8)
    assert op.dtype == jnp.float32
    dense = op.to_scipy()
    assert dense.dtype == np.float32
    ref = A.toarray()
    rel = np.linalg.norm(dense - ref) / np.linalg.norm(ref)
    assert rel < 0.02
    # quant scales count toward the streamed bytes
    assert op.stored_bytes > op.blocks.size


# The XLA einsum + segment-sum apply is the BSR path.


def test_dynamic_bucketed_int8(rng):
    """int8-stored dynamic bucketed operator (r5): per-(frame, angle)
    scales; XLA path matches the dequantized matrices; class budget <1%
    vs exact."""
    import jax.numpy as jnp
    from scipy import sparse as sp

    from trips_tpu.problems import generate_synthetic_dynamic
    from trips_tpu.sparse.dynamic_banded import BucketedDynamicBandedOperator

    A, b, AA, B, nx, ny, nt, delta, x_true, al = \
        generate_synthetic_dynamic(nx=16, nt=3, views=8, noise_level=0.0,
                                   return_angles=True)
    dop8 = BucketedDynamicBandedOperator.from_frames(
        AA, nx, al, n_groups=8, n_buckets=2, dtype="int8")
    assert any(len(st) > 4 for st in dop8.stacks)
    assert all(st[0].dtype == jnp.int8 for st in dop8.stacks)
    Afull = sp.block_diag(AA, format="csr")
    x = rng.standard_normal(dop8.shape[1]).astype(np.float32)
    y = rng.standard_normal(dop8.shape[0]).astype(np.float32)
    exact = Afull.T @ (Afull @ x)
    got = np.asarray(dop8.normal_matvec(jnp.asarray(x)))
    rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
    assert rel < 1e-2, rel
    relf = (np.linalg.norm(np.asarray(dop8.matvec(jnp.asarray(x)))
                           - Afull @ x) / np.linalg.norm(Afull @ x))
    assert relf < 1e-2, relf
    rela = (np.linalg.norm(np.asarray(dop8.rmatvec(jnp.asarray(y)))
                           - Afull.T @ y) / np.linalg.norm(Afull.T @ y))
    assert rela < 1e-2, rela
    # adjointness holds exactly for the quantized matrix
    lhs = float(np.asarray(dop8.matvec(jnp.asarray(x))) @ y)
    rhs = float(x @ np.asarray(dop8.rmatvec(jnp.asarray(y))))
    assert abs(lhs - rhs) < 1e-3 * abs(lhs)
    # int8 storage halves weight bytes vs bf16
    dop16 = BucketedDynamicBandedOperator.from_frames(
        AA, nx, al, n_groups=8, n_buckets=2, dtype=jnp.bfloat16)
    w8 = sum(st[0].size * st[0].dtype.itemsize for st in dop8.stacks)
    w16 = sum(st[0].size * st[0].dtype.itemsize for st in dop16.stacks)
    assert w8 * 2 == w16

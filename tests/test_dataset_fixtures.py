"""Fixture tests for the gated real-dataset loaders.

Each test writes a tiny synthetic file in the *exact* on-disk format of the
real dataset — MATLAB v7.3 (HDF5) CSC with data/ir/jc for Emoji and
STEMPO-real (reference io.py:132-134, 423-464), loadmat-v5 sparse for
CrossPhantom (io.py:200-202), a v5 struct bundle for gelPhantom
(cil_io.py:35-91) — then runs the loader end-to-end and checks every
output (block splits, Fortran-order data flattening, angle subsampling,
delta) against an independent NumPy mirror of the reference's parsing.
"""
import os

import numpy as np
import pytest
import scipy.io as spio
from scipy import sparse as sp


@pytest.fixture()
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _random_block_diag(rng, nt, block_m, block_n, density=0.3):
    blocks = []
    for _ in range(nt):
        M = (rng.random((block_m, block_n)) < density) * rng.random(
            (block_m, block_n))
        M[-1, -1] = 1.0  # keep every block's last row/col occupied
        blocks.append(sp.csr_matrix(M))
    return sp.block_diag(blocks, format="csc"), blocks


def test_emoji_fixture(in_tmp):
    """MATLAB v7.3 layout: HDF5 groups A/{data,ir,jc} (CSC), sinogram
    stored transposed (MATLAB column-major). Mirrors io.py:123-162."""
    import h5py

    rng = np.random.default_rng(0)
    T, N, mm = 33, 4, 2          # 33 frames of 4x4, 2 detector bins/angle
    nn = 3 * T                    # every 3rd angle kept -> 1 angle/frame
    block_m = mm * (nn // 3) // T  # = 2 rows per frame after subsampling
    # full A: (nn*mm, T*N*N), rows grouped angle-major (mm rows per angle)
    A_full, _ = _random_block_diag(rng, T, 3 * block_m, N * N)
    A_full = sp.csc_matrix(A_full)
    # permute rows into angle-major order: frame f's 3 angles are angles
    # 3f, 3f+1, 3f+2 -> rows already contiguous per frame; that IS the
    # emoji layout (frame-major == angle-major at 3 angles/frame)
    sino_matlab = rng.random((mm, nn))

    os.makedirs("data/emoji_data")
    with h5py.File("data/emoji_data/DataDynamic_128x30.mat", "w") as f:
        g = f.create_group("A")
        g["data"] = A_full.data
        g["ir"] = A_full.indices
        g["jc"] = A_full.indptr
        f["sinogram"] = sino_matlab.T  # MATLAB stores column-major
        f["normA"] = np.array([[1.0]])

    from trips_tpu.problems import generate_emoji

    A_small, b, AA, B, nx, ny, nt = generate_emoji(30)
    assert (nx, ny, nt) == (N, N, T)

    # independent mirror of the reference parsing
    ind = []
    for ii in range(nn // 3):
        ind.extend(np.arange(mm) + (3 * ii) * mm)
    A_exp = sp.csr_matrix(A_full)[ind, :]
    b_exp = sino_matlab[:, 0::3].reshape(-1, 1, order="F").squeeze()

    assert A_small.shape == A_exp.shape
    assert (sp.csr_matrix(A_small) != A_exp).nnz == 0
    np.testing.assert_allclose(b, b_exp)
    assert len(AA) == T and len(B) == T
    for i in (0, 16, 32):
        blk = A_exp[block_m * i: block_m * (i + 1),
                    N * N * i: N * N * (i + 1)]
        assert (sp.csr_matrix(AA[i]) != blk).nnz == 0
        np.testing.assert_allclose(B[i], b_exp[block_m * i:
                                               block_m * (i + 1)])


def test_emoji_fixture_noise_delta(in_tmp):
    """noise_level > 0 returns delta = ||added noise|| (io.py:151-155)."""
    import h5py

    rng = np.random.default_rng(1)
    T, N, mm = 33, 4, 2
    nn = 3 * T
    A_full, _ = _random_block_diag(rng, T, 3 * 2, N * N)
    A_full = sp.csc_matrix(A_full)
    sino = rng.random((mm, nn))
    os.makedirs("data/emoji_data")
    with h5py.File("data/emoji_data/DataDynamic_128x60.mat", "w") as f:
        g = f.create_group("A")
        g["data"], g["ir"], g["jc"] = (A_full.data, A_full.indices,
                                       A_full.indptr)
        f["sinogram"] = sino.T

    from trips_tpu.problems import generate_emoji

    np.random.seed(7)
    out = generate_emoji(60, noise_level=0.05)
    assert len(out) == 8
    A_small, b, AA, B, nx, ny, nt, delta = out
    b_clean = sino[:, 0::3].reshape(-1, 1, order="F").squeeze()
    np.random.seed(7)
    e = np.random.randn(b_clean.shape[0])
    sig = 0.05 * np.linalg.norm(b_clean) / np.linalg.norm(e)
    np.testing.assert_allclose(delta, np.linalg.norm(sig * e))
    np.testing.assert_allclose(b, b_clean + sig * e)


def test_crossphantom_fixture(in_tmp):
    """loadmat-v5 layout: sparse A + dense sinogram (io.py:187-229)."""
    rng = np.random.default_rng(2)
    T, N, mm = 16, 4, 2
    nn = 3 * T
    A_full, _ = _random_block_diag(rng, T, 3 * 2, N * N)
    sino = rng.random((mm, nn))
    os.makedirs("data/crossphantom_data")
    spio.savemat("data/crossphantom_data/DataDynamic_128x15.mat",
                 {"A": sp.csc_matrix(A_full), "sinogram": sino})

    from trips_tpu.problems import generate_crossPhantom

    A_small, b, AA, B, nx, ny, nt = generate_crossPhantom(15)
    assert (nx, ny, nt) == (N, N, T)
    ind = []
    for ii in range(nn // 3):
        ind.extend(np.arange(mm) + (3 * ii) * mm)
    A_exp = sp.csr_matrix(A_full)[ind, :]
    b_exp = sino[:, ::3].reshape(-1, 1, order="F").squeeze()
    assert (sp.csr_matrix(A_small) != A_exp).nnz == 0
    np.testing.assert_allclose(b, b_exp)
    blk = A_exp[:2, : N * N]
    assert (sp.csr_matrix(AA[0]) != blk).nnz == 0


def test_stempo_real_fixture(in_tmp):
    """STEMPO real mode: CtData/sinogram (v7.3, stored transposed) +
    A_seqData.mat CSC with explicit (N*45, N*N) shape (io.py:423-464)."""
    import h5py

    rng = np.random.default_rng(3)
    thinning = 8
    N = 2240 // thinning          # 280
    n_rows = N * 45               # 12600
    nt = 8
    # sparse A with a handful of nnz (shape is passed explicitly)
    nnz = 200
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, N * N, nnz)
    A_true = sp.csc_matrix(
        (rng.random(nnz), (rows, cols)), shape=(n_rows, N * N))
    m_matlab = rng.random((45 * nt, N))  # (360, 280)

    os.makedirs("data/stempo_data")
    with h5py.File(f"data/stempo_data/stempo_seq8x45_2d_b{thinning}.mat",
                   "w") as f:
        g = f.create_group("CtData")
        g["sinogram"] = m_matlab.T
    with h5py.File("data/stempo_data/A_seqData.mat", "w") as f:
        g = f.create_group("A")
        g["data"], g["ir"], g["jc"] = (A_true.data, A_true.indices,
                                       A_true.indptr)

    from trips_tpu.problems import generate_stempo

    np.random.seed(5)
    Afull, b, saveA, B, nx, ny, nt_out, delta, truth = generate_stempo(
        "real", data_thinning=thinning, noise_level=0.0)
    assert (nx, ny, nt_out) == (N, N, nt)
    assert truth is None
    assert len(saveA) == nt
    assert (sp.csr_matrix(saveA[0]) != sp.csr_matrix(A_true)).nnz == 0
    assert Afull.shape == (nt * n_rows, nt * N * N)
    for i in (0, 7):
        np.testing.assert_allclose(
            B[i], m_matlab[45 * i: 45 * (i + 1), :].flatten())
    # b is the column-stacked per-frame data (io.py flatten order='F')
    np.testing.assert_allclose(b[:n_rows], B[0])
    np.testing.assert_allclose(b[-n_rows:], B[7])


def test_gelphantom_fixture(in_tmp):
    """Helsinki gel bundle: one v5 file, struct with stacked sinograms and
    per-frame parameter structs (cil_io.py:35-91, 156-224)."""
    rng = np.random.default_rng(4)
    nt, n_angles, n_det = 3, 12, 16
    step = 4                        # keep angles 0, 4, 8
    sinos = rng.random((nt, n_angles, n_det))
    angles_deg = np.linspace(0.0, 330.0, n_angles)
    params = {
        "distanceSourceDetector": 553.74,
        "distanceSourceOrigin": 410.66,
        "geometricMagnification": 553.74 / 410.66,
        "numDetectors": float(n_det),
        "pixelSize": 0.2,
        "pixelSizeRaw": 0.05,
        "effectivePixelSize": 0.1483,
        "angles": angles_deg,
    }
    # (nt,) struct array — one parameter struct per frame, like the bundle
    dt = [(k, "O") for k in params]
    parr = np.zeros((nt,), dtype=dt)
    for k, v in params.items():
        for t in range(nt):
            parr[k][t] = v
    os.makedirs("data/gelphantom_data")
    spio.savemat(
        "data/gelphantom_data/GelPhantomData_b4.mat",
        {"GelPhantomData_b4": {
            "type": "2D", "sinogram": sinos, "parameters": parr}},
    )

    from trips_tpu.problems import generate_gelPhantom
    from trips_tpu.problems.gelphantom import read_frames

    info = read_frames("data/gelphantom_data/GelPhantomData_b4.mat")
    assert info["sinograms"].shape == (nt, n_angles, n_det)
    np.testing.assert_allclose(info["angles"],
                               np.deg2rad(angles_deg))
    assert info["numDetectors"] == n_det
    np.testing.assert_allclose(info["distanceOriginDetector"],
                               553.74 - 410.66)

    nx = 8
    A, b, AA, B, nx_o, ny_o, nt_o = generate_gelPhantom(
        nx=nx, angle_step=step)
    assert (nx_o, ny_o, nt_o) == (nx, nx, nt)
    n_kept = len(range(0, n_angles, step))
    assert AA[0].shape == (n_kept * n_det, nx * nx)
    # same geometry reused per frame (reference cil_io.py:208-218)
    assert all(a is AA[0] for a in AA)
    for i in range(nt):
        np.testing.assert_allclose(
            B[i], sinos[i, ::step, :].reshape(-1))
    assert A.shape == (nt * n_kept * n_det, nt * nx * nx)
    # the geometry produces a real operator: nonempty, nonnegative weights
    assert AA[0].nnz > 0 and AA[0].min() >= 0


def test_saved_data_tomography_fixture(in_tmp):
    """Pre-saved A/b bundles (reference Tomography.py:170-201): SL60/CT60
    and head/CT200 layouts. (The reference's SL90 branch reads a nested
    data['x_true']['b'] struct field — a layout only the real SL90.mat can
    pin down; the uniform b field is tested here.)"""
    rng = np.random.default_rng(6)
    q, p, n = 6, 8, 16
    A = sp.random(p * q, n, density=0.4, format="csc",
                  random_state=np.random.RandomState(6))
    x_true = rng.random((4, 4))
    b = rng.random((1, p * q))  # stored row-major, loader transposes
    os.makedirs("data/image_data")
    spio.savemat("data/image_data/SL60.mat", {"x_true": x_true, "b": b})
    spio.savemat("data/image_data/CT60.mat",
                 {"A": A, "phi": np.zeros((1, q)), "s": np.zeros((1, p))})
    spio.savemat("data/image_data/head.mat", {"x_true": x_true, "b": b})
    spio.savemat("data/image_data/CT200.mat",
                 {"A": A, "phi": np.zeros((1, q)), "s": np.zeros((1, p))})

    from trips_tpu.problems import Tomography

    tomo = Tomography()
    A_out, xt_out, b_out = tomo.gen_saved_data(60)
    assert (sp.csr_matrix(A_out) != sp.csr_matrix(A)).nnz == 0
    np.testing.assert_allclose(xt_out, x_true)
    np.testing.assert_allclose(b_out, b.T)
    assert (tomo.p, tomo.q) == (p, q)
    A_out, xt_out, b_out = tomo.gen_saved_data("head")
    np.testing.assert_allclose(b_out, b.T)


def test_emoji_fixture_full_scale(in_tmp):
    """True Emoji shapes end-to-end: the v7.3 CSC at
    the real (214830, 540672) 30-angle layout (io.py:123-162 — 33 frames,
    217 detector bins x 30 angles/frame, 128x128 images), realistic nnz,
    loader -> per-frame blocks -> ELL reconstruction (5 CGLS iters)."""
    import resource

    import h5py
    import jax.numpy as jnp

    from trips_tpu.krylov import cgls
    from trips_tpu.sparse import EllOperator

    rng = np.random.default_rng(9)
    T, N, mm = 33, 128, 217          # frames, image side, det bins/angle
    ang_all = 30                     # angles per frame in the file
    rows_f, cols_f = mm * ang_all, N * N
    per_row = 32                     # nnz per row (test-sized density)
    rows = np.repeat(np.arange(rows_f), per_row)
    data_parts, ij = [], []
    for t in range(T):
        cols = rng.integers(0, cols_f, rows_f * per_row)
        ij.append((rows + t * rows_f, cols + t * cols_f))
        data_parts.append(rng.random(rows_f * per_row))
    A_full = sp.csc_matrix(
        (np.concatenate(data_parts),
         (np.concatenate([i for i, _ in ij]),
          np.concatenate([j for _, j in ij]))),
        shape=(T * rows_f, T * cols_f))
    sino = rng.random((mm, ang_all * T))

    os.makedirs("data/emoji_data")
    with h5py.File("data/emoji_data/DataDynamic_128x30.mat", "w") as f:
        g = f.create_group("A")
        g["data"], g["ir"], g["jc"] = (A_full.data, A_full.indices,
                                       A_full.indptr)
        f["sinogram"] = sino.T
        f["normA"] = np.array([[1.0]])

    from trips_tpu.problems import generate_emoji

    A_small, b, AA, B, nx, ny, nt = generate_emoji(30)
    assert (nx, ny, nt) == (N, N, T)
    assert A_small.shape == (71610, 540672)      # io.py:156-158 sizes
    assert len(AA) == T and AA[0].shape == (2170, 16384)
    assert b.shape[0] == 71610

    # every 3rd angle kept: block 0 equals rows {0..216, 651..867, ...}
    keep = np.concatenate([np.arange(mm) + (3 * k) * mm
                           for k in range(ang_all // 3)])
    blk0 = sp.csr_matrix(A_full)[keep, :cols_f]
    assert (sp.csr_matrix(AA[0]) != blk0).nnz == 0

    # end-to-end reconstruction at full scale through the ELL apply
    op = EllOperator.from_scipy(sp.csr_matrix(A_small).astype(np.float32))
    x, k = cgls(op, jnp.asarray(np.asarray(b, np.float32)),
                jnp.zeros(op.shape[1], jnp.float32), 5, 0.0)
    r = np.asarray(A_small @ np.asarray(x)) - np.asarray(b).reshape(-1)
    assert np.isfinite(r).all()
    assert np.linalg.norm(r) < np.linalg.norm(np.asarray(b))  # descent
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"emoji full-scale fixture peak RSS {rss_gb:.2f} GB")


def test_stempo_real_fixture_full_density(in_tmp):
    """STEMPO-real layout at realistic density:
    (12600, 78400) per-frame CSC with ~30 nnz/row through A_seqData.mat,
    8-frame block system reconstructed end-to-end (3 CGLS iters)."""
    import h5py
    import jax.numpy as jnp

    from trips_tpu.krylov import cgls
    from trips_tpu.sparse import EllOperator

    rng = np.random.default_rng(10)
    thinning = 8
    N = 2240 // thinning             # 280
    n_rows, n_cols = N * 45, N * N
    nt = 8
    per_row = 30
    rows = np.repeat(np.arange(n_rows), per_row)
    cols = rng.integers(0, n_cols, n_rows * per_row)
    A_true = sp.csc_matrix(
        (rng.random(n_rows * per_row), (rows, cols)),
        shape=(n_rows, n_cols))
    m_matlab = rng.random((45 * nt, N))

    os.makedirs("data/stempo_data")
    with h5py.File(f"data/stempo_data/stempo_seq8x45_2d_b{thinning}.mat",
                   "w") as f:
        g = f.create_group("CtData")
        g["sinogram"] = m_matlab.T
    with h5py.File("data/stempo_data/A_seqData.mat", "w") as f:
        g = f.create_group("A")
        g["data"], g["ir"], g["jc"] = (A_true.data, A_true.indices,
                                       A_true.indptr)

    from trips_tpu.problems import generate_stempo

    np.random.seed(5)
    Afull, b, saveA, B, nx, ny, nt_out, delta, truth = generate_stempo(
        "real", data_thinning=thinning, noise_level=0.0)
    assert (nx, ny, nt_out) == (N, N, nt)
    assert Afull.shape == (nt * n_rows, nt * n_cols)
    assert (sp.csr_matrix(saveA[3]) != sp.csr_matrix(A_true)).nnz == 0

    op = EllOperator.from_scipy(sp.csr_matrix(Afull).astype(np.float32))
    x, k = cgls(op, jnp.asarray(np.asarray(b, np.float32).reshape(-1)),
                jnp.zeros(op.shape[1], jnp.float32), 3, 0.0)
    r = np.asarray(Afull @ np.asarray(x)) - np.asarray(b).reshape(-1)
    assert np.isfinite(r).all()
    assert np.linalg.norm(r) < np.linalg.norm(np.asarray(b))

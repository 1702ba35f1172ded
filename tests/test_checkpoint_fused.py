"""Checkpoint/resume for the fused device loops:
chunked execution surfaces the state pytree between identical chunk
programs, so a killed run resumed from its checkpoint reproduces the
uninterrupted final iterate bit-for-bit."""
import numpy as np
import jax.numpy as jnp
import pytest

from trips_tpu.operators import Blur1D, FirstDerivative1D
from trips_tpu.solvers.checkpointed import (cgls_normal_checkpointed,
                                            fused_gks_checkpointed,
                                            fused_mmgks_checkpointed)
from trips_tpu.solvers.fused import fused_gks, fused_mmgks
from trips_tpu.utils.checkpoint import CheckpointCallback, save_state


class _Killed(Exception):
    pass


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
    return op, jnp.asarray(b)


def test_gks_chunked_matches_monolithic():
    op, b = problem()
    L = FirstDerivative1D(b.shape[0])
    x_mono, lams_mono, _ = fused_gks(op, b, L, projection_dim=3, n_iter=9,
                                     regparam_mode="gcv")
    x_chk, lams_chk, _ = fused_gks_checkpointed(
        op, b, L, projection_dim=3, n_iter=9, regparam_mode="gcv", chunk=4)
    np.testing.assert_allclose(np.asarray(x_chk), np.asarray(x_mono),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(lams_chk), np.asarray(lams_mono),
                               rtol=1e-8, atol=1e-12)


def test_gks_kill_resume_bitwise(tmp_path):
    op, b = problem()
    L = FirstDerivative1D(b.shape[0])
    path = str(tmp_path / "gks_ckpt.npz")
    kw = dict(projection_dim=3, n_iter=12, regparam_mode="gcv", chunk=3)

    x_ref, lams_ref, resids_ref = fused_gks_checkpointed(op, b, L, **kw)

    def cb(it, **state):
        save_state(path, state)
        if it >= 6:
            raise _Killed

    with pytest.raises(_Killed):
        fused_gks_checkpointed(op, b, L, callback=cb, **kw)
    x_res, lams_res, resids_res = fused_gks_checkpointed(
        op, b, L, resume_state=path, **kw)
    # bit-for-bit: the chunk program is identical, so resuming from the
    # surfaced state replays the exact same op sequence
    assert np.array_equal(np.asarray(x_res), np.asarray(x_ref))
    assert np.array_equal(np.asarray(lams_res), np.asarray(lams_ref))
    assert np.array_equal(np.asarray(resids_res), np.asarray(resids_ref))


def test_mmgks_checkpointed_with_callback(tmp_path):
    op, b = problem()
    L = FirstDerivative1D(b.shape[0])
    path = str(tmp_path / "mmgks_ckpt.npz")
    kw = dict(pnorm=2.0, qnorm=1.0, projection_dim=3, n_iter=8,
              regparam_mode="gcv", chunk=3)
    x_mono, _, _ = fused_mmgks(op, b, L, pnorm=2.0, qnorm=1.0,
                               projection_dim=3, n_iter=8,
                               regparam_mode="gcv")
    cb = CheckpointCallback(path, every=1)
    x_full, _, _ = fused_mmgks_checkpointed(op, b, L, callback=cb, **kw)
    np.testing.assert_allclose(np.asarray(x_full), np.asarray(x_mono),
                               rtol=1e-10, atol=1e-12)
    # the final checkpoint resumes to the identical iterate (no-op resume)
    x_res, _, _ = fused_mmgks_checkpointed(op, b, L, resume_state=path,
                                           **kw)
    assert np.array_equal(np.asarray(x_res), np.asarray(x_full))


def test_cgls_normal_kill_resume_bitwise(tmp_path):
    from trips_tpu.krylov import cgls_normal

    op, b = problem()
    x0 = jnp.zeros(op.shape[1], b.dtype)
    path = str(tmp_path / "cgn_ckpt.npz")

    x_mono, k_mono = cgls_normal(op, b, x0, 40, 0.0)
    x_ref, k_ref = cgls_normal_checkpointed(op, b, x0, 40, chunk=7)
    np.testing.assert_allclose(np.asarray(x_ref), np.asarray(x_mono),
                               rtol=1e-12, atol=1e-14)
    assert int(k_ref) == int(k_mono)

    def cb(it, **state):
        save_state(path, state)
        if it >= 14:
            raise _Killed

    with pytest.raises(_Killed):
        cgls_normal_checkpointed(op, b, x0, 40, chunk=7, callback=cb)
    x_res, k_res = cgls_normal_checkpointed(op, b, x0, 40, chunk=7,
                                            resume_state=path)
    assert np.array_equal(np.asarray(x_res), np.asarray(x_ref))
    assert int(k_res) == int(k_ref)

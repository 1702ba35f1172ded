"""What running on a GPU requires of the code, checked on the CPU.

- Exact-class f32 products carry HIGHEST precision (a GPU may otherwise run
  an f32 dot or convolution in TF32, about three decimal digits).
- The compile cache follows ``JAX_COMPILATION_CACHE_DIR`` or sits at one
  fixed, git-ignored path in the checkout.
- ``chip_smoke.py`` refuses to run without a GPU.
- ``device_sparse_operator`` picks a format without asking the platform.
- The native library is built from ``projector.cpp`` and a failed build
  is reported.
"""
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trips_tpu.problems.projector import fan_beam_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tomo(nx=16, views=6):
    angles = np.linspace(0, np.pi, views, endpoint=False)
    return fan_beam_matrix(nx, angles=angles).astype(np.float32), angles


def _lowered(case):
    """(jitted fn, args, least number of f32 dots/convolutions expected)."""
    from trips_tpu.operators import Blur2D, FirstDerivative2D
    from trips_tpu.problems import device_sparse_operator
    from trips_tpu.solvers.fused import fused_gks

    A, angles = _tomo()
    x = jnp.ones(A.shape[1], jnp.float32)
    if case == "blur":
        op = Blur2D([5, 5], (1.5, 1.5), 16, 16)
        op.psf = op.psf.astype(jnp.float32)
        return jax.jit(lambda o, v: o.matvec(v)), (op, x), 1
    if case == "fused_gks":
        op = device_sparse_operator(A, dtype=np.float32)
        b = jnp.asarray(A @ np.ones(A.shape[1], np.float32))
        f = jax.jit(lambda o, bb: fused_gks(o, bb, FirstDerivative2D(16, 16),
                                           projection_dim=2, n_iter=3))
        return f, (op, b), 1
    prefer = {"ell": "ell", "bsr_f32": "bsr", "banded_f32": "banded"}[case]
    op = device_sparse_operator(A, dtype=np.float32, nx=16, angles=angles,
                                prefer=prefer)
    # ELL applies are gathers and row sums: no dot to run in TF32
    return (jax.jit(lambda o, v: (o.matvec(v), o.rmatvec(o.matvec(v)))),
            (op, x), 0 if case == "ell" else 1)


@pytest.mark.parametrize(
    "case", ["ell", "bsr_f32", "banded_f32", "blur", "fused_gks"])
def test_exact_f32_products_are_highest(case):
    fn, args, least = _lowered(case)
    text = fn.lower(*args).as_text()
    ops = [ln for ln in text.splitlines()
           if re.search(r"stablehlo\.(dot_general|convolution)", ln)
           and "xf32>" in ln]
    assert len(ops) >= least, (case, len(ops))
    loose = [ln.strip() for ln in ops if "HIGHEST" not in ln]
    assert not loose, (case, loose[:3])


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, from_env):
    from trips_tpu.config import DEFAULT_CACHE_DIR, enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
        assert DEFAULT_CACHE_DIR == want
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    try:
        assert enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU backend, and in a directory with no rest of the repo,
    the smoke script exits non-zero and prints no ok line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, env=env, cwd=os.path.dirname(script),
                       timeout=300)
    assert r.returncode != 0, r.stdout
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("prefer", [None, "ell", "bsr", "banded"])
def test_device_sparse_operator_one_rule(monkeypatch, prefer):
    """The format follows ``prefer``/``DEFAULT_FORMAT`` alone: the choice
    never queries the platform, so every backend gets the same operator."""
    from trips_tpu.problems import tomography
    from trips_tpu.sparse import (BsrOperator, BucketedBandedProjector,
                                  EllOperator)

    A, angles = _tomo()
    kind = {"ell": EllOperator, "bsr": BsrOperator,
            "banded": BucketedBandedProjector}[
        prefer or tomography.DEFAULT_FORMAT]

    def no_platform(*a, **k):
        raise AssertionError("format choice queried the platform")

    monkeypatch.setattr(jax, "devices", no_platform)
    monkeypatch.setattr(jax, "default_backend", no_platform)
    op = tomography.device_sparse_operator(A, nx=16, angles=angles,
                                           prefer=prefer)
    assert type(op) is kind
    x = np.random.default_rng(0).standard_normal(A.shape[1]).astype(
        np.float32)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                               A @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["int8", jnp.bfloat16])
def test_device_sparse_operator_quantized_needs_a_format(dtype):
    """A quantized dtype is never cast into ELL (int8 would truncate the
    weights to 0/1): the default refuses it, and ``prefer='bsr'`` stores
    it as quantized BSR blocks that stay within the class budget."""
    from trips_tpu.problems import device_sparse_operator
    from trips_tpu.sparse import BsrOperator, EllOperator

    A, angles = _tomo()
    with pytest.raises(ValueError, match="ELL"):
        device_sparse_operator(A, dtype=dtype)
    with pytest.raises(ValueError, match="ELL"):
        EllOperator.from_scipy(A, dtype=dtype)
    op = device_sparse_operator(A, dtype=dtype, prefer="bsr")
    assert type(op) is BsrOperator
    assert op.blocks.dtype == jnp.dtype(dtype)
    x = np.random.default_rng(0).standard_normal(A.shape[1]).astype(
        np.float32)
    got = np.asarray(op.matvec(jnp.asarray(x)))
    assert np.linalg.norm(got - A @ x) / np.linalg.norm(A @ x) < 1e-2


def _native_in(monkeypatch, where):
    import trips_tpu.native as nat

    monkeypatch.setattr(nat, "_DIR", str(where))
    monkeypatch.setattr(nat, "_LIB", str(where / "libprojector.so"))
    monkeypatch.setattr(nat, "_SRC", str(where / "projector.cpp"))
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_tried", False)
    return nat


def test_native_builds_from_source(monkeypatch, tmp_path):
    import trips_tpu.native as nat

    for f in ("projector.cpp", "Makefile"):
        shutil.copy(os.path.join(nat._DIR, f), tmp_path)
    nat = _native_in(monkeypatch, tmp_path)
    lib = nat.load()
    assert lib is not None and hasattr(lib, "pack_angle")
    built = os.path.getmtime(nat._LIB)
    # a source newer than the library triggers a rebuild
    os.utime(nat._SRC, (built + 5, built + 5))
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_tried", False)
    assert nat.load() is not None
    assert os.path.getmtime(nat._LIB) > built


def test_native_build_failure_warns_once(monkeypatch, tmp_path):
    import trips_tpu.native as nat

    shutil.copy(os.path.join(nat._DIR, "Makefile"), tmp_path)
    (tmp_path / "projector.cpp").write_text("this is not C++\n")
    nat = _native_in(monkeypatch, tmp_path)
    with pytest.warns(RuntimeWarning, match="native projector library"):
        assert nat.load() is None
    assert nat.load() is None  # decided once; no second build or warning


@pytest.mark.gpu
def test_exact_f32_applies_on_gpu(gpu):
    """On the card, the default stored format and the blur match scipy in
    float64 to 1e-5 (TF32 would give ~1e-3); chip_smoke.py runs the same
    checks at full size."""
    from scipy.ndimage import convolve

    from trips_tpu.operators import Blur2D
    from trips_tpu.problems import device_sparse_operator

    A, _ = _tomo(64, 20)
    op = device_sparse_operator(A, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(A.shape[1]).astype(
        np.float32)
    got = np.asarray(op.matvec(jnp.asarray(x)), np.float64)
    ref = A.astype(np.float64) @ x.astype(np.float64)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5
    blur = Blur2D([9, 9], (3, 3), 64, 64)
    blur.psf = blur.psf.astype(jnp.float32)
    got = np.asarray(blur.matvec(jnp.asarray(x)), np.float64)
    ref = convolve(x.reshape(64, 64).astype(np.float64),
                   np.asarray(blur.psf, np.float64), mode="reflect")
    assert np.linalg.norm(got - ref.ravel()) / np.linalg.norm(ref) < 1e-5

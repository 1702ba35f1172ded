"""Static tomography test problem (fan-beam CT).

API parity with ``trips/test_problems/Tomography.py:41-268``, with the ASTRA
C++ projector replaced by the native matrix generator
(``trips_tpu.problems.projector``): the geometry parameters are identical
(p = int(sqrt(2)*nx) detectors, theta in [0, pi), source 3*nx, detector nx,
pixel size (so+od)/so — Tomography.py:53-60), inverse crime is avoided by
generating data with angles shifted by 1e-8 rad (Tomography.py:62-67), and
the solver-facing operator is the device sparse operator chosen by
``device_sparse_operator``.
"""
from __future__ import annotations

import os

import numpy as np
import scipy.linalg as sla

from ..sparse import BsrOperator, EllOperator
from ..utils.images import image_to_new_size, load_image_mat
from . import phantoms as phantom
from .projector import fan_beam_matrix


# Stored-matrix format for exact-class (f32/f64) matrices: the fastest
# exact XLA form in the fused CGLS loop on an H100 (PERF.md, "Format
# ranking").
DEFAULT_FORMAT = "ell"


def device_sparse_operator(A_csr, prefer_bsr=None, dtype=np.float32,
                           nx=None, angles=None, prefer=None):
    """Wrap a host CSR matrix as a device operator.

    One rule on every platform: ``prefer`` ('banded' | 'bsr' | 'ell')
    forces a format, otherwise ``DEFAULT_FORMAT``. Exact-class ``dtype``
    (float32/float64) stores the matrix as it is. The quantized classes
    (``jnp.bfloat16`` or ``"int8"``, <1%-of-norm recon deviation, pinned
    by tests) are a storage of the BSR blocks or of the banded pack and
    must be asked for with ``prefer``; ELL stores exact values only and
    refuses them. The banded pack needs fan/parallel geometry (``nx`` +
    ``angles``); when its preconditions do not hold the matrix goes to
    ``DEFAULT_FORMAT``."""
    quantized = np.dtype(dtype) not in (np.float32, np.float64)
    if prefer is None and prefer_bsr is not None:  # legacy flag
        prefer = "bsr" if prefer_bsr else "ell"
    prefer = prefer or DEFAULT_FORMAT
    if prefer == "banded":
        from ..sparse import BucketedBandedProjector

        try:
            if nx is None or angles is None or A_csr.shape[1] != nx * nx:
                raise ValueError("banded pack needs square-grid geometry")
            n_pad = -(-nx // 128) * 128
            for ng in (32, 16, 8, 4, 2, 1):
                if n_pad % ng == 0:
                    break
            return BucketedBandedProjector.from_scipy_fan(
                A_csr, nx, views=None, angles=np.asarray(angles),
                n_groups=ng,
                dtype=("int8" if np.dtype(dtype) == np.int8
                       else None if np.dtype(dtype) == np.float32
                       else dtype))
        except (ValueError, AssertionError):  # pack preconditions
            prefer = DEFAULT_FORMAT
    if prefer == "bsr":
        if quantized:
            return BsrOperator.from_scipy(A_csr, dtype=np.float32,
                                          block_dtype=dtype)
        return BsrOperator.from_scipy(A_csr, dtype=dtype)
    return EllOperator.from_scipy(A_csr, dtype=dtype)


class Tomography:
    def __init__(self, **kwargs):
        self.seed = kwargs.pop("seed", 2022)
        self.nx = None
        self.ny = None
        self.CommitCrime = kwargs.get("CommitCrime", False)

    # -- geometry ---------------------------------------------------------
    def define_proj_id(self, nx, ny, views, **kwargs):
        self.nx, self.ny = nx, ny
        self.p = int(np.sqrt(2) * nx)
        self.q = views
        self.views = views
        self.theta = np.linspace(0, np.pi, views, endpoint=False)
        self.source_origin = 3 * nx
        self.detector_origin = nx
        self.detector_pixel_size = (self.source_origin + self.detector_origin) / self.source_origin

    def define_A(self, nx, ny, views, dtype=None):
        self.define_proj_id(nx, ny, views)
        kw = dict(
            det_count=self.p,
            det_width=self.detector_pixel_size,
            source_origin=self.source_origin,
            origin_det=self.detector_origin,
        )
        self.A = fan_beam_matrix(nx, ny, angles=self.theta, **kw)
        if not self.CommitCrime:
            self.A_mis = fan_beam_matrix(nx, ny, angles=self.theta + 1e-8, **kw)

    def forward_Op(self, nx, ny, views, dtype=None):
        """Returns (OP, A[, A_mis]): device operator, host CSR, and (when
        CommitCrime is False) the angle-mismatched CSR used for data."""
        self.define_A(nx, ny, views)
        if dtype is None:
            import jax

            dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
        self.OP = device_sparse_operator(
            self.A, dtype=dtype,
            nx=nx if nx == ny else None, angles=self.theta)
        if not self.CommitCrime:
            return self.OP, self.A, self.A_mis
        return self.OP, self.A

    # -- ground truth -----------------------------------------------------
    def gen_true(self, test_problem, **kwargs):
        if self.nx is None or self.ny is None:
            if "nx" in kwargs and "ny" in kwargs:
                self.nx, self.ny = kwargs["nx"], kwargs["ny"]
            else:
                raise TypeError(
                    "The dimension of the image is not specified. Pass nx/ny "
                    "or define the forward operator first."
                )
        N = self.nx
        seed = kwargs.get("phantom_seed", None)
        if test_problem == "grains":
            x = phantom.grains(N, int(round(4 * np.sqrt(N))), seed=seed)
        elif test_problem == "smooth":
            x = phantom.smooth(N)
        elif test_problem == "tectonic":
            x = phantom.tectonic(N)
        elif test_problem == "threephases":
            x = phantom.threephases(N, seed=seed)
        elif test_problem == "ppower":
            x = phantom.ppower(N, seed=seed)
        elif test_problem == "shepp_logan":
            x = phantom.shepp_logan(N)
        elif test_problem in ("SL60", "SL90", "head"):
            img = load_image_mat(test_problem)
            if img.shape != (self.nx, self.ny):
                img = image_to_new_size(img, (self.nx, self.ny))
                img[np.isnan(img)] = 0
            x = img
        else:
            raise TypeError(
                "You must enter a valid test problem! Options are: grains, "
                "smooth, tectonic, threephases, ppower, shepp_logan, SL60, "
                "SL90, head."
            )
        self.nx, self.ny = x.shape
        return x.reshape(-1, 1), self.nx, self.ny

    # -- data -------------------------------------------------------------
    def gen_data(self, x, nx, ny, views):
        self.nx, self.ny, self.views = nx, ny, views
        if not self.CommitCrime:
            OP, A, A_mis = self.forward_Op(nx, ny, views)
            b = (A_mis @ np.asarray(x).reshape(-1)).reshape(-1, 1)
        else:
            OP, A = self.forward_Op(nx, ny, views)
            b = (A @ np.asarray(x).reshape(-1)).reshape(-1, 1)
        # reference swaps p/q after data generation (Tomography.py:164-166)
        self.p = self.views
        self.q = int(b.shape[0] / self.views)
        return OP, b, self.p, self.q, A

    def gen_saved_data(self, dataset):
        """Pre-saved A/b .mat bundles ('SL60'/'SL90'/'head' + CT60/CT90/CT200);
        requires local data files (Tomography.py:170-201)."""
        mapping = {60: ("SL60", "CT60"), 90: ("SL90", "CT90"), "head": ("head", "CT200")}
        test_problem, otherdata = mapping[dataset]
        import scipy.io as spio

        data = spio.loadmat(f"./data/image_data/{test_problem}.mat")
        CT = spio.loadmat(f"./data/image_data/{otherdata}.mat")
        A, phi, s = CT["A"], CT["phi"], CT["s"]
        x_true = data["x_true"]
        b = data["b"].T
        self.q = phi.shape[1]
        self.p = s.shape[1]
        return A, x_true, b

    def add_noise(self, b_true, opt, noise_level):
        b_true = np.asarray(b_true).reshape(-1, 1)
        if opt == "Gaussian":
            noise = np.random.randn(b_true.shape[0]).reshape(-1, 1)
            e = noise_level * np.linalg.norm(b_true) / np.linalg.norm(noise) * noise
            delta = sla.norm(e)
            b_meas = b_true + e
            return b_meas.reshape(self.p, self.q), delta
        if opt == "Poisson":
            b_meas = np.random.poisson(lam=b_true + 1).astype(float)
            return b_meas.reshape(self.p, self.q), 0
        e = np.random.laplace(size=(b_true.shape[0], 1))
        sig = noise_level * np.linalg.norm(b_true) / np.linalg.norm(e)
        b_meas = b_true + sig * e
        return b_meas.reshape(self.p, self.q), sla.norm(sig * e)

    def plot_rec(self, img, save_imgs=False, save_path="./saveImagesTomo"):
        import matplotlib.pyplot as plt

        plt.set_cmap("inferno")
        if save_imgs and not os.path.exists(save_path):
            os.makedirs(save_path)
        plt.imshow(np.asarray(img).reshape(self.nx, self.ny))
        plt.axis("off")
        if save_imgs:
            plt.savefig(save_path + "/rec.png", bbox_inches="tight")

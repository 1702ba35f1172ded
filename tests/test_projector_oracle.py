"""Analytic projector oracle.

The discrete fan-/parallel-beam builders were previously validated only
against their own NumPy/C++ twins. Closed-form ellipse line integrals
(``problems.projector.analytic_sinogram``) pin the geometry conventions
independently: the discrete ``A @ x`` of a pixel-center rasterization must
CONVERGE to the analytic sinogram under grid refinement
(reference geometry: trips/test_problems/Tomography.py:49-68 fan;
trips/utilities/io.py:391-420 parallel/Joseph).
"""
import numpy as np
import pytest

from trips_tpu.problems.projector import (
    analytic_sinogram,
    fan_beam_matrix,
    parallel_beam_matrix,
)

# (rho, a, b, cx, cy, phi) in units of nx (scaled per grid below)
PHANTOM = (
    (1.0, 0.31, 0.22, 0.09, -0.06, 0.5),
    (0.6, 0.12, 0.28, -0.17, 0.11, 2.2),
    (-0.4, 0.07, 0.05, 0.05, -0.01, 0.0),
)


def _rasterize(nx):
    j = np.arange(nx)
    px = -nx / 2.0 + j + 0.5
    py = (nx / 2.0 - j - 0.5)
    X, Y = np.meshgrid(px, py)  # row-major: Y[i] = ny/2 - i - 1/2
    img = np.zeros((nx, nx))
    for rho, a, b, cx, cy, phi in _scaled(nx):
        c, s = np.cos(phi), np.sin(phi)
        xr = (X - cx) * c + (Y - cy) * s
        yr = -(X - cx) * s + (Y - cy) * c
        img += rho * ((xr / a) ** 2 + (yr / b) ** 2 <= 1.0)
    return img.reshape(-1)


def _scaled(nx):
    return [(rho, a * nx, b * nx, cx * nx, cy * nx, phi)
            for rho, a, b, cx, cy, phi in PHANTOM]


def _rel_err(geometry, nx, model="line"):
    views = 14
    angles = np.linspace(0, np.pi, views, endpoint=False) + 0.123
    if geometry == "fan":
        A = fan_beam_matrix(nx, angles=angles)
        p = int(np.sqrt(2) * nx)
    else:
        A = parallel_beam_matrix(nx, angles, model=model)
        p = nx
    ref = analytic_sinogram(_scaled(nx), nx, geometry=geometry,
                            angles=angles, det_count=p)
    got = (A @ _rasterize(nx)).reshape(len(angles), p)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("geometry", ["fan", "parallel"])
def test_discrete_converges_to_analytic(geometry):
    errs = [_rel_err(geometry, nx) for nx in (48, 96, 192)]
    # O(h) boundary discretization: each refinement should cut the error
    assert errs[1] < 0.75 * errs[0], errs
    assert errs[2] < 0.75 * errs[1], errs
    assert errs[2] < 2e-2, errs


def test_joseph_converges_to_analytic():
    errs = [_rel_err("parallel", nx, model="linear") for nx in (48, 96, 192)]
    assert errs[1] < 0.75 * errs[0], errs
    assert errs[2] < 0.75 * errs[1], errs
    assert errs[2] < 3e-2, errs


def test_fan_oracle_matches_known_chord():
    """Single centered disk at theta=0: the central ray's chord is the
    diameter (sanity-pin of the parametrization, not just convergence)."""
    nx = 64
    r = 0.25 * nx
    sino = analytic_sinogram([(1.0, r, r, 0.0, 0.0, 0.0)], nx,
                             geometry="fan", angles=np.array([0.0]))
    p = int(np.sqrt(2) * nx)
    # detector offsets are symmetric; for even p the two central rays
    # straddle the center — chord there is slightly under the diameter
    mid = sino[0, (p - 1) // 2:(p + 2) // 2]
    assert np.all(mid <= 2 * r + 1e-9)
    assert np.all(mid > 2 * r * 0.995)
    assert sino[0, 0] == 0.0 and sino[0, -1] == 0.0

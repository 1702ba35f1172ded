"""Offline numeric cross-check of the gelPhantom Cone2D -> fan mapping.

CIL itself is not in this image, so this test *reimplements* CIL's
published geometry arithmetic independently — straight from the CIL source
semantics — and asserts ``gelphantom.gel_operator`` reproduces it:

- ``AcquisitionGeometry.create_Cone2D(source_position=[0, SO],
  detector_position=[0, -OD])`` yields ``dist_source_center = SO``,
  ``dist_center_detector = OD`` and ``magnification = (SO + OD) / SO``
  (sign of the positions cancels in the distances).
- ``get_ImageGeometry(resolution=1)`` sets
  ``voxel_size_xy = panel.pixel_size[0] / magnification``.
- The reference corrects the panel pixel size by 2x before building the
  panel (``pixelSize = 2*file_info['pixelSize']``, cil_io.py:176) and
  overrides ``voxel_num`` to 256 while keeping the default voxel size
  (cil_io.py:196-198).
- ``Slicer(roi={'angle': (0, 360, 20)})`` keeps angle indices
  0, 20, ..., 340 (cil_io.py:202-204).

Reference: trips/utilities/cil_io.py:156-224.
"""
import numpy as np
import pytest

import trips_tpu.problems.gelphantom as gp

# Helsinki gel-phantom real-bundle values (GelPhantomData_b4 metadata)
SO = 410.66
SD = 553.74
OD = SD - SO
PIXEL = 0.1
N_DET = 140


def cil_reference_arithmetic(pixel_size_panel, so, od):
    """Independent reimplementation of the CIL formulas used by the
    reference loader (do NOT call into trips_tpu here)."""
    # AcquisitionGeometry.magnification for Cone2D
    dist_source_center = abs(-so)  # source_position [0, SO] -> distance SO
    dist_center_detector = abs(od)
    magnification = (dist_source_center + dist_center_detector) / \
        dist_source_center
    # get_ImageGeometry(resolution=1.0)
    voxel_size_xy = pixel_size_panel / magnification
    return magnification, voxel_size_xy


def make_info(angles_deg=None):
    angles_deg = np.arange(360.0) if angles_deg is None else angles_deg
    return {
        "angles": np.asarray(angles_deg) * np.pi / 180.0,
        "distanceSourceOrigin": SO,
        "distanceSourceDetector": SD,
        "distanceOriginDetector": OD,
        "geometricMagnification": SD / SO,
        "numDetectors": N_DET,
        "pixelSize": PIXEL,
        "effectivePixelSize": 2 * PIXEL / (SD / SO),
    }


def test_magnification_matches_cil_formula():
    mag, v = cil_reference_arithmetic(2 * PIXEL, SO, OD)
    assert gp.cil_cone2d_magnification(SO, OD) == pytest.approx(mag, rel=1e-14)
    assert gp.cil_voxel_size(2 * PIXEL, SO, OD) == pytest.approx(v, rel=1e-14)
    # for the real bundle the file's own field agrees with the derived value
    assert mag == pytest.approx(SD / SO, rel=1e-12)


def test_gel_operator_geometry_numbers(monkeypatch):
    """gel_operator must hand fan_beam_matrix the CIL-derived geometry in
    voxel units: SO/v, OD/v, det width (2*pixelSize)/v == magnification."""
    captured = {}

    def fake_fan_beam_matrix(nx, angles=None, det_count=None, det_width=None,
                             source_origin=None, origin_det=None, **kw):
        captured.update(nx=nx, angles=angles, det_count=det_count,
                        det_width=det_width, source_origin=source_origin,
                        origin_det=origin_det)

        class Dummy:
            pass

        return Dummy()

    monkeypatch.setattr(gp, "fan_beam_matrix", fake_fan_beam_matrix)
    info = make_info()
    keep = np.arange(0, 360, 20)
    gp.gel_operator(info, 256, keep)

    mag, v = cil_reference_arithmetic(2 * PIXEL, SO, OD)
    assert captured["nx"] == 256  # reference overrides voxel_num to 256
    assert captured["det_count"] == N_DET
    assert captured["source_origin"] == pytest.approx(SO / v, rel=1e-12)
    assert captured["origin_det"] == pytest.approx(OD / v, rel=1e-12)
    # detector width in voxel units reduces exactly to the magnification
    assert captured["det_width"] == pytest.approx(2 * PIXEL / v, rel=1e-12)
    assert captured["det_width"] == pytest.approx(mag, rel=1e-12)
    # angle slicing: CIL Slicer roi={'angle': (0, 360, 20)} semantics
    expect = np.arange(360.0)[np.arange(0, 360, 20)] * np.pi / 180.0
    np.testing.assert_allclose(np.asarray(captured["angles"]), expect,
                               rtol=0, atol=1e-15)
    assert len(captured["angles"]) == 18
    assert captured["angles"][-1] == pytest.approx(340.0 * np.pi / 180.0)


def test_gel_operator_uses_derived_not_file_magnification(monkeypatch):
    """CIL derives magnification from the configured distances; the file's
    geometricMagnification field must be ignored even when it disagrees."""
    captured = {}

    def fake_fan_beam_matrix(nx, **kw):
        captured.update(kw)

        class Dummy:
            pass

        return Dummy()

    monkeypatch.setattr(gp, "fan_beam_matrix", fake_fan_beam_matrix)
    info = make_info()
    info["geometricMagnification"] = 99.0  # poisoned field
    gp.gel_operator(info, 256, np.arange(0, 360, 20))
    _, v = cil_reference_arithmetic(2 * PIXEL, SO, OD)
    assert captured["source_origin"] == pytest.approx(SO / v, rel=1e-12)


def test_gel_operator_builds_real_matrix_rows():
    """End-to-end sanity on the real geometry numbers: the fan matrix for
    the gel geometry at small nx has every detector row either empty or a
    plausible chord (positive weights, row-sum bounded by the grid
    diagonal), and the adjoint is exact (matrix transpose)."""
    info = make_info()
    A = gp.gel_operator(info, 32, np.arange(0, 360, 40))
    A = np.asarray(A.todense() if hasattr(A, "todense") else A)
    assert A.shape == (9 * N_DET, 32 * 32)
    assert (A >= 0).all()
    # chord through a 32-grid is at most the diagonal in pixel units
    assert A.sum(axis=1).max() <= np.sqrt(2) * 32 + 1e-6
    # the magnified fan at this geometry covers the grid through the
    # central detectors (the real panel is wider than a 32-voxel grid, so
    # edge detectors legitimately miss it)
    rows = A.sum(axis=1).reshape(9, N_DET)
    center = N_DET // 2
    assert (rows[:, center - 5:center + 5] > 0).all()
    assert (A.sum(axis=1) > 0).mean() > 0.15

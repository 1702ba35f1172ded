"""ctypes bindings for the native (C++) projector builder.

``libprojector.so`` is not shipped: ``load()`` builds it from
``projector.cpp`` with the bundled Makefile on first use, and again when the
source is newer than the library. When the build or the load fails it warns
once and returns None, and callers use the vectorized NumPy implementation
(about 7x slower host packing).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB = os.path.join(_DIR, "libprojector.so")
_SRC = os.path.join(_DIR, "projector.cpp")
_lib = None
_tried = False


def _stale():
    return (not os.path.exists(_LIB)
            or os.path.getmtime(_SRC) > os.path.getmtime(_LIB))


def load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if _stale():
            subprocess.run(["make", "-C", _DIR, "-B"], check=True,
                           capture_output=True, text=True, timeout=300)
        lib = ctypes.CDLL(_LIB)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or e
        warnings.warn(
            f"native projector library unavailable ({detail}); using the "
            "NumPy fallback for matrix building and banded packing",
            RuntimeWarning, stacklevel=2)
        return None
    for name in ("fan_beam_csr", "parallel_beam_csr"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
    _lib = lib
    return _lib


def _run(fn_name, nx, ny, angles, det_count, det_width, extra=()):
    lib = load()
    if lib is None:
        return None
    angles = np.ascontiguousarray(angles, dtype=np.float64)
    n_angles = len(angles)
    rows = n_angles * det_count
    cap = rows * (nx + ny + 3)
    rowptr = np.zeros(rows + 1, dtype=np.int64)
    col = np.zeros(cap, dtype=np.int32)
    val = np.zeros(cap, dtype=np.float64)
    fn = getattr(lib, fn_name)
    args = [
        ctypes.c_int(nx),
        ctypes.c_int(ny),
        ctypes.c_int(n_angles),
        angles.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int(det_count),
        ctypes.c_double(det_width),
        *extra,
        rowptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        val.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(cap),
    ]
    nnz = fn(*args)
    if nnz < 0:
        return None
    from scipy import sparse as sp

    return sp.csr_matrix(
        (val[:nnz], col[:nnz], rowptr), shape=(rows, nx * ny)
    )


def fan_beam_csr_native(nx, ny, angles, det_count, det_width, so, od):
    return _run(
        "fan_beam_csr", nx, ny, angles, det_count, det_width,
        extra=(ctypes.c_double(so), ctypes.c_double(od)),
    )


def parallel_beam_csr_native(nx, ny, angles, det_count, det_width):
    return _run("parallel_beam_csr", nx, ny, angles, det_count, det_width)


def pack_angle(d, line, c, n, p, n_groups, n_pad):
    """Native banded-pack kernel for one angle (bit-identical twin of
    ``sparse/banded.py::_pack_angle``'s shear/predictor/tap computation).

    Returns (t, shift, P, T_a) or None when the native library is
    unavailable (callers fall back to the NumPy path).
    """
    lib = load()
    if lib is None:
        return None
    try:
        fn = lib.pack_angle
    except AttributeError:  # stale .so from an older build
        return None
    fn.restype = ctypes.c_int32
    d = np.ascontiguousarray(d, np.int32)
    line = np.ascontiguousarray(line, np.int32)
    c = np.ascontiguousarray(c, np.int32)
    nnz = len(d)
    t = np.empty(nnz, np.int32)
    shift = np.zeros(n_pad, np.int32)
    P = np.empty((n_groups, p), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ret = fn(ctypes.c_int64(nnz),
             d.ctypes.data_as(i32p), line.ctypes.data_as(i32p),
             c.ctypes.data_as(i32p),
             ctypes.c_int32(n), ctypes.c_int32(p),
             ctypes.c_int32(n_groups), ctypes.c_int32(n_pad),
             t.ctypes.data_as(i32p), shift.ctypes.data_as(i32p),
             P.ctypes.data_as(i32p))
    if ret < 0:
        return None  # invariant violation -> NumPy path (which asserts)
    return t, shift, P, max(int(ret), 1)


def scatter_fill(t, i, d, v, W_slab):
    """Fill one angle's (T, n_pad, p_pad) slab: W[t, i, d] = v.

    ``W_slab`` must be C-contiguous float32 or bfloat16 (the bf16 path
    converts with round-to-nearest-even, identical to numpy astype).
    Returns True on success, False -> caller uses the numpy scatter.
    """
    lib = load()
    if lib is None or W_slab.ndim != 3 or not W_slab.flags.c_contiguous:
        return False
    kind = W_slab.dtype.name
    if kind == "float32":
        name = "scatter_fill_f32"
        ctype = ctypes.c_float
    elif kind == "bfloat16":
        name = "scatter_fill_bf16"
        ctype = ctypes.c_uint16
    else:
        return False
    try:
        fn = getattr(lib, name)
    except AttributeError:
        return False
    i32p = ctypes.POINTER(ctypes.c_int32)
    t = np.ascontiguousarray(t, np.int32)
    i = np.ascontiguousarray(i, np.int32)
    d = np.ascontiguousarray(d, np.int32)
    v = np.ascontiguousarray(v, np.float32)
    sT = W_slab.shape[1] * W_slab.shape[2]
    sI = W_slab.shape[2]
    fn(ctypes.c_int64(len(t)),
       t.ctypes.data_as(i32p), i.ctypes.data_as(i32p),
       d.ctypes.data_as(i32p),
       v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
       W_slab.ctypes.data_as(ctypes.POINTER(ctype)),
       ctypes.c_int64(sT), ctypes.c_int64(sI))
    return True

"""Shear-rotate fan-beam projector — a gather-free surrogate fan projector.

A matrix-free discretization of the reference's ASTRA 'line_fanflat'
geometry (``trips/test_problems/Tomography.py:49-68``). The exact Siddon
fan matrix is unstructured sparsity; this operator removes *all* runtime
indexing by restructuring fan projection into dense, gather-free stages:

  A. **Rotate** each view's image into a canonical frame (source at
     ``(0, -so)``, horizontal detector at ``y = +od``) — an exact quarter
     turn (``rot90``: transpose + flip, no resampling) followed by a 3-shear
     rotation for the residual angle in [-45°, 45°). Each shear is a per-line
     integer roll (log2 decomposition into masked power-of-two rolls) plus
     a 2-tap fractional blend. All views are processed as one
     batched (na, C, C) array — a single fused XLA program, no per-angle
     dispatch.
  B. **Fan contraction**: in the canonical frame the geometry is *identical
     for every view*, so the remaining work — per-row perspective sampling of
     the rotated canvases at the ray/row crossings, ray-step weighting, and
     the sum over rows — is one einsum ``y[a,d] = Σ_{i,c} R[a,i,c]·G[i,c,d]``
     against a **view-independent constant** ``G`` built once *on device*
     from iota arithmetic (a few scalars cross the host boundary, never a
     matrix). ``G[i,:,d]`` holds the 2-tap hat weights at the crossing of
     ray ``d`` with canvas row ``i``, scaled by the per-ray step length
     ``sqrt(1 + (u_d/(so+od))^2)``.

The adjoint is ``jax.linear_transpose`` of the forward — exact transposition
of every stage, so ``<Ax, y> == <x, A'y>`` holds to roundoff by
construction.

Correctness of the circular rolls: content never wraps because the maximum
shear excursion of the image disc (radius r = nx/sqrt(2)) is
``r·sqrt(1 + tan^2(22.5°))`` horizontally during the middle shear state and
``r`` vertically — the canvas is sized past the worst case, so rolled-in
values are always zeros from the empty margin.

Model note: composing the rotation's interpolations with the stage-B hat
sampling gives an effective pixel footprint a little wider than Siddon's
'line' chords — a standard smoother discretization of the same line
integrals (shear/slant-stack Radon). Reconstruction parity with the
exact-Siddon matrix at measurement-noise level is pinned by tests
(mirroring the validated parallel shear-stack, ``shear_projector.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.linop import LinearOperator, register_op


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class ShearFanProjector(LinearOperator):
    """Fan-beam projector via shear rotation + one banded-warp einsum.

    Matches the reference geometry defaults (``Tomography.py:53-60``):
    ``p = int(sqrt(2) * nx)`` detectors, ``so = 3 nx``, ``od = nx``,
    ``det_width = (so + od) / so``. Sinogram rows are angle-major
    (``angle * p + detector``); the image is (ny, nx) row-major with
    row 0 at the top, matching ``fan_beam_matrix``.

    ``g_dtype`` controls the storage dtype of the stage-B constant
    (bfloat16 halves the bytes it streams; accumulation stays f32).
    """

    def __init__(self, nx, angles=None, views=None, det_count=None,
                 det_width=None, source_origin=None, origin_det=None,
                 ny=None, dtype=None, g_dtype=None):
        ny = ny or nx
        if ny != nx:
            raise NotImplementedError("square grids only")
        dtype = jnp.dtype(dtype or (jnp.float64 if jax.config.jax_enable_x64
                                    else jnp.float32))
        g_dtype = jnp.dtype(g_dtype or dtype)
        if angles is None:
            angles = np.linspace(0, np.pi, views, endpoint=False)
        angles = np.asarray(angles, dtype=float)
        na = len(angles)
        p = int(det_count) if det_count is not None else int(np.sqrt(2) * nx)
        so = float(source_origin) if source_origin is not None else 3.0 * nx
        od = float(origin_det) if origin_det is not None else float(nx)
        dw = float(det_width) if det_width is not None else (so + od) / so
        self.nx = self.ny = nx
        self.det_count = p
        self.n_angles = na
        self.shape = (na * p, nx * ny)
        self.dtype_ = dtype
        self._so, self._od, self._dw = so, od, dw

        # ---- canvas sizing (see module docstring) -----------------------
        r = nx / np.sqrt(2.0)
        bulge = r * np.sqrt(1.0 + np.tan(np.pi / 8) ** 2) + 3.0
        C = int(_round_up(int(np.ceil(2 * bulge)) + 2, 16))
        self._C = C
        cc = (C - 1) / 2.0

        # ---- per-view decomposition: exact quarter turns + residual ----
        # the image is rotated by -theta (the assembly stays canonical)
        k = np.round(angles / (np.pi / 2)).astype(int)  # 0, 1 or 2
        phi = angles - k * (np.pi / 2)  # residual in [-45, 45)
        self._kgroups = tuple(
            tuple(int(a) for a in np.nonzero(k == kk)[0]) for kk in (0, 1, 2))
        # rotate-by-(-phi) in pull-back form (out(c) = in(c + shift)):
        # shifts sx = -tan(phi/2)*y per row, sy = -sin(phi)*x per column,
        # applied as ShX, ShY, ShX (sign conventions pinned numerically
        # against scipy.ndimage.rotate)
        t_sh = np.tan(-phi / 2.0)
        m_sh = -np.sin(phi)

        # per-line real shifts; line coordinates are center offsets with
        # y positive up (canvas row 0 on top), x positive right
        y_line = cc - np.arange(C)
        x_line = np.arange(C) - cc
        sx = t_sh[:, None] * y_line[None, :]   # (na, C): x-shift per row
        sy = m_sh[:, None] * x_line[None, :]   # (na, C): y-shift per column

        def split(s):
            k_int = np.floor(s).astype(np.int64)
            return (jnp.asarray(k_int, jnp.int32),
                    jnp.asarray(s - k_int, dtype))

        self._kx, self._fx = split(sx)
        self._ky, self._fy = split(sy)

        # ---- stage-B constant: built lazily on device -------------------
        self._g_dtype = g_dtype
        self.G = self._build_g()

    def _build_g(self):
        """(C, C, p) hat-weight constant, from iota arithmetic on
        device."""
        C, p = self._C, self.det_count
        so, od, dw = self._so, self._od, self._dw
        cc = (C - 1) / 2.0
        r = self.nx / np.sqrt(2.0)
        f64 = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        u = (jnp.arange(p, dtype=f64) - (p - 1) / 2.0) * dw          # (p,)
        yrow = cc - jnp.arange(C, dtype=f64)                          # (C,)
        # ray d crosses row y at x = u_d * (y + so) / (so + od)
        q = u[None, :] * (yrow[:, None] + so) / (so + od) + cc        # (C,p)
        step = jnp.sqrt(1.0 + (u / (so + od)) ** 2)                   # (p,)
        live = (jnp.abs(yrow) <= (r + 1.5)).astype(f64)               # (C,)
        c0 = jnp.floor(q)
        f = q - c0
        cix = jnp.arange(C, dtype=f64)[None, :, None]                 # c axis
        w = step[None, None, :] * live[:, None, None]
        G = w * ((cix == c0[:, None, :]) * (1.0 - f)[:, None, :]
                 + (cix == (c0 + 1.0)[:, None, :]) * f[:, None, :])
        return G.astype(self._g_dtype)

    # -- shear machinery ---------------------------------------------------
    def _roll(self, buf, shift, axis):
        """Per-line roll of (na, C, C) ``buf`` along ``axis``.

        value_out(c) = value_in(c + shift) per line; ``shift`` is (na, C)
        indexed by the complementary spatial axis. Decomposed into masked
        power-of-two rolls (non-negative after mod C)."""
        Cp = buf.shape[axis]
        s = jnp.mod(shift, Cp)
        for k in range(int(Cp - 1).bit_length()):
            bit = ((s >> k) & 1).astype(bool)
            mask = bit[:, :, None] if axis == 2 else bit[:, None, :]
            buf = jnp.where(mask, jnp.roll(buf, -(1 << k), axis=axis), buf)
        return buf

    def _shear(self, buf, k_int, frac, axis):
        """Integer per-line roll + 2-tap fractional blend along ``axis``:
        out(c) = (1-f) * in(c + k) + f * in(c + k + 1)."""
        rolled = self._roll(buf, k_int, axis)
        rolled1 = jnp.roll(rolled, -1, axis=axis)
        f = frac[:, :, None] if axis == 2 else frac[:, None, :]
        return (1.0 - f) * rolled + f * rolled1

    def _rotate_all(self, X):
        """(ny, nx) image -> (na, C, C) canonically rotated canvases."""
        C, nx = self._C, self.nx
        off = (C - nx) // 2
        canvas = jnp.zeros((C, C), X.dtype)
        canvas = jax.lax.dynamic_update_slice(canvas, X, (off, off))
        # exact quarter turns: image rotated by -k*90 deg
        quarters = (canvas,
                    jnp.rot90(canvas, k=-1),
                    jnp.rot90(canvas, k=-2))
        parts, order = [], []
        for kk, group in enumerate(self._kgroups):
            if not group:
                continue
            gi = np.asarray(group)
            buf = jnp.broadcast_to(quarters[kk], (len(group), C, C))
            buf = self._shear(buf, self._kx[gi], self._fx[gi], axis=2)
            buf = self._shear(buf, self._ky[gi], self._fy[gi], axis=1)
            buf = self._shear(buf, self._kx[gi], self._fx[gi], axis=2)
            parts.append(buf)
            order.extend(group)
        R = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        perm = np.empty(self.n_angles, dtype=np.int64)
        perm[np.asarray(order)] = np.arange(self.n_angles)
        return R[jnp.asarray(perm)] if list(order) != sorted(order) else R

    def _forward(self, x):
        X = x.reshape(self.ny, self.nx)
        R = self._rotate_all(X)
        acc = jnp.promote_types(self.dtype_, jnp.float32)
        y = jnp.einsum("aic,icd->ad", R.astype(self.G.dtype), self.G,
                       preferred_element_type=acc)
        return y.reshape(-1).astype(self.dtype_)

    def matvec(self, x):
        return self._forward(x.astype(self.dtype_)).astype(x.dtype)

    def rmatvec(self, y):
        x0 = jax.ShapeDtypeStruct((self.shape[1],), self.dtype_)
        (xt,) = jax.linear_transpose(self._forward, x0)(y.astype(self.dtype_))
        return xt.astype(y.dtype)

    def matmat(self, Xm):
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(Xm)

    def rmatmat(self, Ym):
        return jax.vmap(self.rmatvec, in_axes=1, out_axes=1)(Ym)


register_op(
    ShearFanProjector,
    ["G", "_kx", "_fx", "_ky", "_fy"],
    ["nx", "ny", "det_count", "n_angles", "shape", "dtype_", "_C",
     "_kgroups", "_so", "_od", "_dw", "_g_dtype"],
)

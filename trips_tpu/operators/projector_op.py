"""Matrix-free on-the-fly tomography projector.

The detector coordinate of pixel (i, c) at a given angle is affine in c for
parallel-beam geometry, so each (angle, image-row) pair contributes
``y[a, :] += M @ X[i, :]`` with an interpolation matrix
``M[d, c] = hat(d - (alpha + beta * c))`` that never needs to be stored:
it is generated on the fly from broadcasted iotas and contracted
immediately. No stored matrix is read — per apply the only memory touched
is the image and the sinogram.

Exactly reproduces the Joseph ('linear') parallel-beam matrix
(``problems.projector.parallel_beam_matrix(model='linear')``, the
reference's STEMPO simulation projector — io.py:391-420); the adjoint is
the exact transpose by construction (same M, transposed contraction).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from ..core.linop import LinearOperator, register_op

# Exact class: true f32 products (lower precisions run f32 dots in TF32 on
# GPUs, about three decimal digits).
_PREC = jax.lax.Precision.HIGHEST


def _angle_params(theta, nx, ny, det_count, det_width):
    """Per-angle affine map for the Joseph crossing position.

    Joseph interpolates the image at the point where ray d crosses each
    line of the driving axis: the perpendicular pixel coordinate of that
    crossing is affine in both the driving index i and the detector index
    d:  pos(i, d) = P0 + Pi*i + Pd*d. Derived by inverting the ray
    parametrization used by ``problems.projector._joseph_parallel``
    (point = offs*u + t*dir, offs_d = (d-(p-1)/2)*det_width).
    """
    half = (det_count - 1) / 2.0
    c, sn = np.cos(theta), np.sin(theta)
    drive_is_y = abs(c) >= abs(sn)
    if drive_is_y:
        # drive over image rows i; perpendicular = column coordinate
        # x(offs, i) = offs/cos - yc(i)*tan ; xi = x + nx/2 - 0.5
        P0 = -half * det_width / c - (ny / 2.0 - 0.5) * np.tan(theta) \
            + nx / 2.0 - 0.5
        Pi = np.tan(theta)
        Pd = det_width / c
        step = 1.0 / abs(c)
    else:
        # drive over image columns j; perpendicular = row coordinate
        # y(offs, j) = offs/sin - xc(j)*cot ; yi = ny/2 - 0.5 - y
        P0 = ny / 2.0 - 0.5 + half * det_width / sn \
            + (-nx / 2.0 + 0.5) * (c / sn)
        Pi = c / sn
        Pd = -det_width / sn
        step = 1.0 / abs(sn)
    return drive_is_y, P0, Pi, Pd, step


class OnTheFlyParallelProjector(LinearOperator):
    """Parallel-beam Joseph projector, generated in-register per apply.

    Rows are angle-major (angle * det_count + detector), matching
    ``parallel_beam_matrix``. Image is (ny, nx) row-major, ny == nx
    supported (square grids, as in every reference config).
    """

    def __init__(self, nx, angles, det_count=None, det_width=1.0, ny=None,
                 dtype=None):
        ny = ny or nx
        if ny != nx:
            raise NotImplementedError("square grids only")
        dtype = dtype or (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        self.nx, self.ny = nx, ny
        self.det_count = det_count if det_count is not None else nx
        self.det_width = float(det_width)
        self.angles = np.asarray(angles, dtype=float)
        self.n_angles = len(self.angles)
        p = self.det_count
        self.shape = (self.n_angles * p, nx * ny)

        # precompute per-angle affine coefficients (host, tiny)
        drive, p0s, pis, pds, steps = [], [], [], [], []
        for th in self.angles:
            drive_is_y, P0, Pi, Pd, step = _angle_params(
                th, nx, ny, p, self.det_width
            )
            drive.append(drive_is_y)
            p0s.append(P0)
            pis.append(Pi)
            pds.append(Pd)
            steps.append(step)
        self.drive_is_y = jnp.asarray(drive)
        self.P0 = jnp.asarray(p0s, dtype)
        self.Pi = jnp.asarray(pis, dtype)
        self.Pd = jnp.asarray(pds, dtype)
        self.step = jnp.asarray(steps, dtype)

    # -- the on-the-fly interpolation tensor for one angle ---------------
    def _interp(self, a_idx):
        """M (nx_drive, p, nx_perp) for angle a:
        M[i, d, c] = hat(pos(i, d) - c) * step  (Joseph linear weights)."""
        p = self.det_count
        nx = self.nx
        dt = self.P0.dtype
        i_idx = jnp.arange(nx, dtype=dt)
        d_idx = jnp.arange(p, dtype=dt)
        c_idx = jnp.arange(nx, dtype=dt)
        pos = (self.P0[a_idx] + self.Pi[a_idx] * i_idx[:, None]
               + self.Pd[a_idx] * d_idx[None, :])  # (i, d)
        diff = pos[:, :, None] - c_idx[None, None, :]  # (i, d, c)
        return jnp.maximum(0.0, 1.0 - jnp.abs(diff)) * self.step[a_idx]

    def _image_for_angle(self, X, a_idx):
        # driving axis = rows when drive_is_y else columns
        return jax.lax.cond(
            self.drive_is_y[a_idx], lambda: X, lambda: X.T
        )

    def matvec(self, x):
        X = x.reshape(self.ny, self.nx)
        n_ang = self.n_angles

        def one_angle(a_idx):
            M = self._interp(a_idx)  # (i, d, c)
            Xd = self._image_for_angle(X, a_idx)  # (i, c)
            return jnp.einsum(
                "idc,ic->d", M, Xd,
                precision=_PREC,
            )

        y = jax.lax.map(one_angle, jnp.arange(n_ang))
        return y.reshape(-1)

    def rmatvec(self, y):
        p = self.det_count
        n_ang = self.n_angles
        Y = y.reshape(n_ang, p)

        def one_angle(a_idx):
            M = self._interp(a_idx)  # (i, d, c)
            Xd = jnp.einsum(
                "idc,d->ic", M, Y[a_idx],
                precision=_PREC,
            )
            return jax.lax.cond(
                self.drive_is_y[a_idx], lambda: Xd, lambda: Xd.T
            )

        Xs = jax.lax.map(one_angle, jnp.arange(n_ang))
        return jnp.sum(Xs, axis=0).reshape(-1)


register_op(
    OnTheFlyParallelProjector,
    ["drive_is_y", "P0", "Pi", "Pd", "step"],
    ["nx", "ny", "det_count", "det_width", "shape", "n_angles"],
)


class OnTheFlyFanProjector(LinearOperator):
    """Fan-beam 'line' (exact chord-length) projector, generated in-register.

    Replaces the stored fan-beam matrix (``problems.projector
    .fan_beam_matrix``; reference geometry Tomography.py:49-68) with
    per-apply weight generation: for each (angle, detector) the ray's
    crossings of every row band (and, for shallow rays, column band) are
    rational-affine functions of the detector index; the chord length
    inside pixel (i, c) is the clipped band-interval overlap scaled by the
    band segment length. All elementwise — no gathers, no stored matrix,
    HBM traffic is just the image and sinogram.

    Matches the Siddon CSR matrix to ~1e-11 in float64. In float32 the ray
    geometry itself rounds (band crossings are differences of coordinates
    ~3*nx from the origin), which puts an apply ~1e-4 from the matrix, and
    a ray within that rounding of a pixel boundary (a view at pi/2 with an
    odd detector count) may land in the neighbouring pixel: a class of its
    own, not the exact stored matrix. Rows are angle-major like the
    matrix builder.
    """

    def __init__(self, nx, angles=None, views=None, det_count=None,
                 det_width=None, source_origin=None, origin_det=None,
                 ny=None, dtype=jnp.float32):
        ny = ny or nx
        if ny != nx:
            raise NotImplementedError("square grids only")
        self.nx, self.ny = nx, ny
        if angles is None:
            angles = np.linspace(0, np.pi, views, endpoint=False)
        angles = np.asarray(angles, dtype=float)
        self.n_angles = len(angles)
        p = det_count if det_count is not None else int(np.sqrt(2) * nx)
        so = source_origin if source_origin is not None else 3 * nx
        od = origin_det if origin_det is not None else nx
        dw = det_width if det_width is not None else (so + od) / so
        self.det_count = p
        self.shape = (self.n_angles * p, nx * ny)

        offs = (np.arange(p) - (p - 1) / 2.0) * dw
        Sx = so * np.sin(angles)
        Sy = -so * np.cos(angles)
        D0x = -od * np.sin(angles)
        D0y = od * np.cos(angles)
        ux, uy = np.cos(angles), np.sin(angles)
        # per (angle, detector) ray endpoints
        Dx = D0x[:, None] + offs[None, :] * ux[:, None]
        Dy = D0y[:, None] + offs[None, :] * uy[:, None]
        self.Sx = jnp.asarray(Sx, dtype)
        self.Sy = jnp.asarray(Sy, dtype)
        self.Dx = jnp.asarray(Dx, dtype)
        self.Dy = jnp.asarray(Dy, dtype)
        # static angle groups: angles whose whole fan shares one driving
        # axis skip the other branch's weight generation (~2x less work)
        yd = np.abs(Dy - Sy[:, None]) >= np.abs(Dx - Sx[:, None])
        g_y = [a for a in range(self.n_angles) if yd[a].all()]
        g_x = [a for a in range(self.n_angles) if (~yd[a]).all()]
        g_m = [a for a in range(self.n_angles) if a not in g_y and a not in g_x]
        self._groups = (tuple(g_y), tuple(g_x), tuple(g_m))
        order = list(g_y) + list(g_x) + list(g_m)
        # static row permutation: group-ordered rows -> angle-major rows
        perm = np.empty(self.n_angles, dtype=np.int64)
        perm[order] = np.arange(self.n_angles)
        self._row_perm = tuple(perm.tolist())

    def _weights(self, a):
        """(Wy (i, d, c), Wx (j, d, r)) chord tensors for angle a."""
        return self._weights_y(a), self._weights_x(a)

    def _band_weights(self, par_c, perp_c, S_par, S_perp, d_par, d_perp, mask):
        """Crossings of bands along the 'par' axis; interp over 'perp'.

        par_c: band-center coordinates (n,), perp_c: pixel-center
        coordinates along the other axis (n,).
        Returns W (band, det, perp_pixel).
        """
        dt = self.Dx.dtype
        eps = jnp.asarray(1e-12 if dt == jnp.float64 else 1e-6, dt)
        slope = d_perp / jnp.where(jnp.abs(d_par) < eps, eps, d_par)
        t1 = (par_c[:, None] - 0.5 - S_par) * slope[None, :] + S_perp
        t2 = (par_c[:, None] + 0.5 - S_par) * slope[None, :] + S_perp
        lo = jnp.minimum(t1, t2)  # (band, det)
        hi = jnp.maximum(t1, t2)
        span = hi - lo
        seglen = jnp.sqrt(span * span + 1.0)
        # overlap with pixel intervals [perp_c - .5, perp_c + .5]
        ov = jnp.clip(
            jnp.minimum(hi[:, :, None], perp_c[None, None, :] + 0.5)
            - jnp.maximum(lo[:, :, None], perp_c[None, None, :] - 0.5),
            0.0,
        )
        frac = ov / jnp.maximum(span, eps)[:, :, None]
        # half-open pixel interval, as the matrix builder's floor(): a ray
        # on a pixel boundary belongs to the pixel above it, not to both
        rel_lo = lo[:, :, None] - perp_c[None, None, :]
        inside = (rel_lo >= -0.5) & (rel_lo < 0.5)
        w = jnp.where(span[:, :, None] < eps,
                      jnp.where(inside, seglen[:, :, None], 0.0),
                      frac * seglen[:, :, None])
        return w * mask[None, :, None]

    def _grid_centers(self):
        dt = self.Dx.dtype
        yc = (self.ny / 2.0 - 0.5) - jnp.arange(self.nx, dtype=dt)
        xc = (-self.nx / 2.0 + 0.5) + jnp.arange(self.nx, dtype=dt)
        return yc, xc

    def _weights_y(self, a, masked=True):
        dx = self.Dx[a] - self.Sx[a]
        dy = self.Dy[a] - self.Sy[a]
        yc, xc = self._grid_centers()
        mask = (jnp.abs(dy) >= jnp.abs(dx)) if masked else jnp.ones_like(dx, bool)
        return self._band_weights(yc, xc, self.Sy[a], self.Sx[a], dy, dx, mask)

    def _weights_x(self, a, masked=True):
        dx = self.Dx[a] - self.Sx[a]
        dy = self.Dy[a] - self.Sy[a]
        yc, xc = self._grid_centers()
        mask = (jnp.abs(dy) < jnp.abs(dx)) if masked else jnp.ones_like(dx, bool)
        return self._band_weights(xc, yc, self.Sx[a], self.Sy[a], dx, dy, mask)

    def _branch_fns(self, branch):
        if branch == "y":
            fwd = lambda a, X: jnp.einsum(
                "idc,ic->d", self._weights_y(a), X, precision=_PREC)
            adj = lambda a, yd: jnp.einsum(
                "idc,d->ic", self._weights_y(a), yd, precision=_PREC)
        elif branch == "x":
            fwd = lambda a, X: jnp.einsum(
                "jdr,rj->d", self._weights_x(a), X, precision=_PREC)
            adj = lambda a, yd: jnp.einsum(
                "jdr,d->rj", self._weights_x(a), yd, precision=_PREC)
        else:
            def fwd(a, X):
                return (jnp.einsum("idc,ic->d", self._weights_y(a), X,
                                   precision=_PREC)
                        + jnp.einsum("jdr,rj->d", self._weights_x(a), X,
                                     precision=_PREC))

            def adj(a, yd):
                return (jnp.einsum("idc,d->ic", self._weights_y(a), yd,
                                   precision=_PREC)
                        + jnp.einsum("jdr,d->rj", self._weights_x(a), yd,
                                     precision=_PREC))
        return fwd, adj

    def matvec(self, x):
        X = x.reshape(self.ny, self.nx)
        parts = []
        for branch, group in zip(("y", "x", "m"), self._groups):
            if not group:
                continue
            fwd, _ = self._branch_fns(branch)
            ys = jax.lax.map(lambda a: fwd(a, X), jnp.asarray(group))
            parts.append(ys)
        y = jnp.concatenate(parts, axis=0)
        y = y[jnp.asarray(self._row_perm)]  # static permutation
        return y.reshape(-1)

    def rmatvec(self, y):
        Y = y.reshape(self.n_angles, self.det_count)
        total = jnp.zeros((self.ny, self.nx), Y.dtype)
        for branch, group in zip(("y", "x", "m"), self._groups):
            if not group:
                continue
            _, adj = self._branch_fns(branch)
            g = jnp.asarray(group)
            Xs = jax.lax.map(lambda a: adj(a, Y[a]), g)
            total = total + jnp.sum(Xs, axis=0)
        return total.reshape(-1)


register_op(
    OnTheFlyFanProjector,
    ["Sx", "Sy", "Dx", "Dy"],
    ["nx", "ny", "det_count", "shape", "n_angles", "_groups", "_row_perm"],
)

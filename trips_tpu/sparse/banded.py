"""Shear-packed band format for projector matrices (exact, ROADMAP item 1).

The exact Siddon/Joseph fan(parallel)-beam matrix is unstructured sparsity
to a generic format, but in the (angle, drive-line, detector) parametrization
every matrix entry sits within a narrow *band*: ray ``d`` crosses drive line
``i`` in at most 3 adjacent pixels (measured; see tests), and the crossing
position is nearly affine in ``d`` with a smoothly varying per-line slope.

Packing (host, exact — every nnz keeps its f32 value and position):

  column(a, i, d, t) = shift[a,i] + P[a,g(i),d] + t,     0 <= t < T

where ``shift`` is a per-(angle, line) integer shear, ``P`` is a per-group
integer predictor (``g(i)`` groups ``n/G`` consecutive lines; the predictor
absorbs the common slope), and the tap axis ``T`` absorbs the per-line
residual (affine-fit error + slope variation within a group). ``T`` is
typically 5-7 for the reference fan geometry — so the stored stream is
``na * n * T * p`` weights (~66-94 MB bf16 at 256x256/60 views) versus
0.45 GB for (32,128) BSR blocks: a ~6x stream reduction with *zero* runtime
index data on the critical path (the predictor is shared per group and the
shear is a roll).

The drive axis per angle follows Joseph's rule (rows when |cos θ| >= |sin θ|,
else columns, operating on the transposed image), chosen statically.

Applies: ``matvec``/``rmatvec`` are one gather + einsum (forward) and one
scatter-add (adjoint) per drive group (``apply_group_xla``).

Replaces the role of ASTRA's stored projector
(``trips/test_problems/Tomography.py:73-88``) on the stored-matrix path.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..core.linop import LinearOperator, register_op


def sp_isspmatrix_csr_like(A):
    return getattr(A, "format", None) == "csr"


def _pack_angle(coo_d, coo_i, coo_c, coo_v, n, p, n_groups, n_pad=None):
    """Pack one angle's (detector, line, column, value) triplets.

    Returns (W (T_a, n_pad, p), shift (n_pad,), P (n_groups, p)) with
    column = shift[i] + P[g(i), d] + t. ``n_pad >= n`` pads the line/roll
    axis to a multiple of 128 (padded lines carry zero weight, so the
    mod-n_pad wraps stay exact: true columns never wrap).
    """
    n_pad = n if n_pad is None else n_pad
    from ..native import pack_angle as _native_pack

    native = _native_pack(coo_d, coo_i, coo_c, n, p, n_groups, n_pad)
    if native is not None:
        t, shift, P, T_a = native
        return (t, coo_i, coo_d, coo_v), T_a, shift, P
    # minimum observed column per (line, detector): cmin[i, d]
    cmin = np.full((n, p), np.iinfo(np.int32).max, np.int64)
    np.minimum.at(cmin, (coo_i, coo_d), coo_c)
    have_id = cmin < np.iinfo(np.int32).max

    # per-line integer shear: the line's median start (dealiases the
    # per-line offset; any per-line constant works). Vectorized median:
    # sort with +inf sentinels, average the two middle elements of each
    # row's valid prefix — int(np.median(...)) semantics for the
    # non-negative columns (floor of the midpoint average).
    shift = np.zeros(n_pad, np.int64)
    have_i = have_id.any(axis=1)
    cnt = have_id.sum(axis=1)
    vals = np.where(have_id, cmin, np.iinfo(np.int64).max)
    vals.sort(axis=1)
    rows = np.arange(n)
    safe = np.maximum(cnt, 1)
    lo = vals[rows, (safe - 1) // 2]
    hi = vals[rows, np.minimum(safe // 2, p - 1)]
    shift[:n] = np.where(have_i, (lo + hi) // 2, 0)

    # nonparametric per-group predictor: P[g, d] = min over the group's
    # lines of (cmin - shift). This absorbs the projective (Moebius)
    # curvature of the start positions exactly — only the within-group
    # slope variation is left for the tap axis.
    gsize = n_pad // n_groups
    g_of = np.arange(n) // gsize
    rel = np.where(have_id, cmin - shift[:n, None],
                   np.iinfo(np.int32).max)
    P = np.full((n_groups, p), np.iinfo(np.int32).max, np.int64)
    np.minimum.at(P, (g_of[:, None].repeat(p, 1), np.arange(p)[None, :]
                      .repeat(n, 0)), rel)
    # (g, d) cells with no data: nearest present detector of the group
    for g in range(n_groups):
        miss = P[g] == np.iinfo(np.int32).max
        if miss.all():
            P[g] = 0
        elif miss.any():
            ok = np.nonzero(~miss)[0]
            P[g, miss] = P[g, ok[np.argmin(
                np.abs(np.nonzero(miss)[0][:, None] - ok[None, :]), axis=1)]]

    t = coo_c - shift[coo_i] - P[g_of[coo_i], coo_d]
    assert (t >= 0).all()
    T_a = int(t.max()) + 1 if len(t) else 1
    # return scatter coordinates instead of a materialized W: the caller
    # fills one preallocated (na, T, n_pad, p_pad) array directly (the
    # pad->stack->astype copy chain dominated pack time at STEMPO scale)
    return ((t, coo_i, coo_d, coo_v), T_a, shift.astype(np.int32),
            P.astype(np.int32))


def _pack_groups(A, nx, views, angles, n_groups):
    """Shared pack pipeline: angle-major matrix -> per-angle pack results
    split by drive orientation. Returns (packs, idx, angles, p, n_pad)
    where packs[dr] is a list of ``_pack_angle`` results and idx[dr] the
    matching global angle ids."""
    angles = (np.linspace(0, np.pi, views, endpoint=False)
              if angles is None else np.asarray(angles))
    coo = A.tocoo()
    p = A.shape[0] // len(angles)
    n = nx
    # pad the roll axis to a multiple of 128 (the pack layout the
    # bucketed/sharded tables and their tests assume); padded lines are
    # zero-weight
    n_pad = -(-n // 128) * 128
    if n_pad % n_groups:
        raise ValueError(
            f"n_groups={n_groups} must divide the padded grid "
            f"{n_pad} (nx={n} padded to the next multiple of 128); "
            f"pick n_groups from the divisors of {n_pad}.")
    drive_rows = np.abs(np.cos(angles)) >= np.abs(np.sin(angles))
    packs = {True: [], False: []}
    idx = {True: [], False: []}
    # int32 throughout: these feed indexing and the native pack; the
    # int64 casts were ~30% of STEMPO-scale pack time
    d_of = (coo.row % p).astype(np.int32, copy=False)
    i_img = (coo.col // nx).astype(np.int32, copy=False)
    j_img = (coo.col % nx).astype(np.int32, copy=False)
    vals = (coo.data if coo.data.dtype == np.float32
            else coo.data.astype(np.float32))
    # csr->coo rows are sorted, so angles are contiguous slices —
    # avoids one full boolean-mask pass over the nnz per angle; for
    # CSR input the bounds come straight off indptr (no searchsorted)
    if sp_isspmatrix_csr_like(A):
        sorted_rows = True
        bounds = np.asarray(A.indptr)[np.arange(len(angles) + 1) * p]
    else:
        a_of = coo.row // p
        sorted_rows = bool(np.all(np.diff(coo.row) >= 0))
        if sorted_rows:
            bounds = np.searchsorted(a_of, np.arange(len(angles) + 1))
    tasks = []
    for a in range(len(angles)):
        m = (slice(bounds[a], bounds[a + 1]) if sorted_rows
             else a_of == a)
        dr = bool(drive_rows[a])
        line = i_img[m] if dr else j_img[m]
        c = j_img[m] if dr else i_img[m]
        tasks.append((dr, a, (d_of[m], line, c, vals[m])))
    # per-angle packs are independent; the native kernel releases the
    # GIL, so a small thread pool overlaps them across host cores
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(4, os.cpu_count() or 1)) as ex:
        results = list(ex.map(
            lambda t: _pack_angle(*t[2], n, p, n_groups, n_pad=n_pad),
            tasks))
    for (dr, a, _), r in zip(tasks, results):
        packs[dr].append(r)
        idx[dr].append(a)
    return packs, idx, angles, p, n_pad


def _stack_packs(group, n_pad, p, p_pad, n_groups, out_dtype):
    """Stack a list of per-angle pack results into (W, S, P) arrays at the
    group-wide T = max T_a."""
    if not group:
        z = np.zeros((0, n_pad), np.int32)
        return (np.zeros((0, 1, n_pad, p_pad), out_dtype), z,
                np.zeros((0, n_groups, p_pad), np.int32))
    T = max(T_a for _, T_a, _, _ in group)
    # single allocation in the target dtype, filled by scatter —
    # no per-angle W materialization, no pad/stack/astype copies
    from ..native import scatter_fill

    W = np.zeros((len(group), T, n_pad, p_pad), out_dtype)
    for k, ((t, ii, dd, vv), _, _, _) in enumerate(group):
        if not scatter_fill(t, ii, dd, vv, W[k]):
            W[k, t, ii, dd] = vv
    S = np.stack([s for _, _, s, _ in group])
    P = np.stack([np.pad(pp, ((0, 0), (0, p_pad - p)), mode="edge")
                  for _, _, _, pp in group])
    return W, S, P


class BandedProjector(LinearOperator):
    """Exact banded repack of an angle-major projector matrix."""

    def __init__(self, W_rows, shift_rows, P_rows, angles_rows,
                 W_cols, shift_cols, P_cols, angles_cols,
                 shape, nx, p, n_groups, nnz, n_pad=None):
        # *_rows: angles driven along image rows; *_cols: transposed drive.
        # W_* layout: (na_g, T, n, p_pad) with the detector axis padded to
        # a multiple of 128 (zero weights past det_count).
        self.W_rows = W_rows
        self.shift_rows = shift_rows
        self.P_rows = P_rows
        self.W_cols = W_cols
        self.shift_cols = shift_cols
        self.P_cols = P_cols
        self._angles_rows = tuple(angles_rows)
        self._angles_cols = tuple(angles_cols)
        self.shape = tuple(shape)
        self.nx = nx
        # line/roll-axis size: nx padded to a multiple of 128 (padded lines
        # carry zero weight; rolls and predictors work mod n_pad)
        self.n_pad = nx if n_pad is None else n_pad
        self.det_count = p
        self.n_groups = n_groups
        self.nnz = nnz

    @classmethod
    def from_scipy_fan(cls, A, nx, views, angles=None, n_groups=64,
                       dtype=None, lane_pad=128):
        """Pack an angle-major fan/parallel matrix (rows = a*p + d)."""
        packs, idx, angles, p, n_pad = _pack_groups(A, nx, views, angles,
                                                    n_groups)
        p_pad = -(-p // lane_pad) * lane_pad
        out_dtype = np.float32 if dtype is None else dtype

        def stack(group):
            return _stack_packs(group, n_pad, p, p_pad, n_groups,
                                out_dtype)

        Wr, Sr, Pr = stack(packs[True])
        Wc, Sc, Pc = stack(packs[False])
        return cls(jnp.asarray(Wr), jnp.asarray(Sr), jnp.asarray(Pr),
                   idx[True],
                   jnp.asarray(Wc), jnp.asarray(Sc), jnp.asarray(Pc),
                   idx[False],
                   A.shape, nx, p, n_groups, A.nnz, n_pad=n_pad)

    @property
    def T_rows(self):
        return self.W_rows.shape[1] if self.W_rows.size else 0

    @property
    def T_cols(self):
        return self.W_cols.shape[1] if self.W_cols.size else 0

    @property
    def stored_bytes(self):
        return (self.W_rows.size * self.W_rows.dtype.itemsize
                + self.W_cols.size * self.W_cols.dtype.itemsize
                + self.shift_rows.size * 4 + self.shift_cols.size * 4
                + self.P_rows.size * 4 + self.P_cols.size * 4)

    def to_scipy(self):
        """Exact reconstruction of the packed matrix (host oracle)."""
        from scipy import sparse as sp

        nx, p = self.nx, self.det_count
        n = nx
        gsize = self.n_pad // self.n_groups
        rows, cols, vals = [], [], []
        for W, S, P, aidx, dr in (
                (self.W_rows, self.shift_rows, self.P_rows,
                 self._angles_rows, True),
                (self.W_cols, self.shift_cols, self.P_cols,
                 self._angles_cols, False)):
            W, S, P = map(np.asarray, (W, S, P))
            for k, a in enumerate(aidx):
                tt, ii, dd = np.nonzero(W[k])
                cc = S[k][ii] + P[k][ii // gsize, dd] + tt
                ok = (cc >= 0) & (cc < n) & (dd < p)
                ii, tt, dd, cc = ii[ok], tt[ok], dd[ok], cc[ok]
                pix = ii * nx + cc if dr else cc * nx + ii
                rows.append(a * p + dd)
                cols.append(pix)
                vals.append(W[k][tt, ii, dd])
        M = sp.csr_matrix(
            (np.concatenate(vals).astype(np.float64),
             (np.concatenate(rows), np.concatenate(cols))), shape=self.shape)
        M.sum_duplicates()
        return M

    def _apply_group_xla(self, X, W, S, P, transpose, y_rows=None):
        return apply_group_xla(self.n_pad, self.n_groups, X, W, S, P,
                               transpose, y_rows=y_rows)

    def _embed(self, X):
        """(nx, nx) image -> (n_pad, n_pad) padded roll space."""
        n, npd = self.nx, self.n_pad
        if npd == n:
            return X
        return jnp.zeros((npd, npd), X.dtype).at[:n, :n].set(X)

    def matvec(self, x):
        n, p = self.nx, self.det_count
        X = self._embed(x.reshape(n, n))
        na = len(self._angles_rows) + len(self._angles_cols)
        y = jnp.zeros((na, p), jnp.promote_types(x.dtype, jnp.float32))
        if self.W_rows.size:
            yr = self._apply_group_xla(X, self.W_rows, self.shift_rows,
                                       self.P_rows, False)
            y = y.at[jnp.asarray(self._angles_rows)].set(yr[:, :p])
        if self.W_cols.size:
            yc = self._apply_group_xla(X.T, self.W_cols, self.shift_cols,
                                       self.P_cols, False)
            y = y.at[jnp.asarray(self._angles_cols)].set(yc[:, :p])
        return y.reshape(-1).astype(x.dtype)

    def rmatvec(self, y):
        n, p = self.nx, self.det_count
        Y = y.reshape(-1, p)
        acc = jnp.promote_types(y.dtype, jnp.float32)
        img = jnp.zeros((self.n_pad, self.n_pad), acc)
        if self.W_rows.size:
            img += self._apply_group_xla(
                None, self.W_rows, self.shift_rows, self.P_rows, True,
                y_rows=Y[jnp.asarray(self._angles_rows)])
        if self.W_cols.size:
            img += self._apply_group_xla(
                None, self.W_cols, self.shift_cols, self.P_cols, True,
                y_rows=Y[jnp.asarray(self._angles_cols)]).T
        return img[:n, :n].reshape(-1).astype(y.dtype)


register_op(
    BandedProjector,
    ["W_rows", "shift_rows", "P_rows", "W_cols", "shift_cols", "P_cols"],
    ["_angles_rows", "_angles_cols", "shape", "nx", "det_count", "n_groups",
     "nnz", "n_pad"],
)


def dequant_slab(W, sc):
    """Dequantize an int8 weight stack with per-angle scales. ``sc`` None
    passes W through — the shared no-op for f32/bf16 packs."""
    if sc is None:
        return W
    return W.astype(jnp.float32) * sc[:, None, None, None]


def apply_group_xla(nx, n_groups, X, W, S, P, transpose, y_rows=None,
                    wrap=False):
    """All angles of one drive group.

    X: (n, n) image (drive-major). forward: returns (na_g, p_pad);
    adjoint: consumes y_rows (na_g, p) and returns the image contribution.

    wrap=True consumes mod-n P tables (the bucketed and sharded packs):
    indices wrap cyclically and NO validity mask is applied — exact,
    because packed weights are zero wherever the true column is out of
    range (see _pack_angle). wrap=False consumes raw (possibly negative)
    P with clipping + validity masking."""
    n = nx
    gsize = -(-n // n_groups)
    T, p_pad = W.shape[1], W.shape[3]
    acc = jnp.promote_types(X.dtype if not transpose else y_rows.dtype,
                            jnp.float32)
    # column index per (a, t, i, d)
    g_of = jnp.arange(n) // gsize
    cidx = (S[:, None, :, None]
            + P[:, g_of][:, None, :, :]
            + jnp.arange(T)[None, :, None, None])  # (na_g, T, n, p_pad)
    if wrap:
        cclip = jnp.mod(cidx, n)
        Wv = W.astype(acc)
    else:
        cclip = jnp.clip(cidx, 0, n - 1)
        valid = (cidx >= 0) & (cidx < n)
        Wv = jnp.where(valid, W.astype(acc), 0)
    if not transpose:
        gath = jnp.take_along_axis(
            X.astype(acc)[None, None, :, :],
            cclip, axis=3)
        return jnp.einsum("atid,atid->ad", Wv, gath,
                          precision=jax.lax.Precision.HIGHEST)
    ypad = jnp.pad(y_rows.astype(acc),
                   ((0, 0), (0, p_pad - y_rows.shape[1])))
    contrib = Wv * ypad[:, None, None, :]  # (na_g, T, n, p_pad)
    flat_tgt = (jnp.arange(n)[None, None, :, None] * n
                + cclip).reshape(-1)
    img = jnp.zeros(n * n, acc).at[flat_tgt].add(contrib.reshape(-1))
    return img.reshape(n, n)

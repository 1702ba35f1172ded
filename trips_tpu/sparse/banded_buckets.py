"""Ta-bucketed banded projector.

The flat ``BandedProjector`` stacks every drive group at the group-wide
T = max(T_a), but per-angle tap widths vary ~2x (mean 8.2 vs max 15 on
the tomo256x60 fan geometry) — 40%+ of the stored slab is structural
zero padding. This variant splits each drive group's angles into
``n_buckets`` Ta-sorted buckets, each stacked at its own T, and applies
each bucket separately: no added compute, 27-45% fewer stored bytes.

Same exact matrix as the flat pack (``to_scipy`` bit-identical entries).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.linop import LinearOperator, register_op
from .banded import _pack_groups, _stack_packs, apply_group_xla


class BucketedBandedProjector(LinearOperator):
    """Exact banded repack with per-bucket tap widths.

    ``stacks``: tuple of (W, S, Pm-mod-n_pad) array triples (pytree data);
    ``aidxs``/``is_cols`` static per-bucket angle ids and drive flags.
    """

    def __init__(self, stacks, aidxs, is_cols, shape, nx, p, n_groups,
                 nnz, n_pad):
        self.stacks = tuple(tuple(s) for s in stacks)
        self.aidxs = tuple(tuple(int(a) for a in ai) for ai in aidxs)
        self.is_cols = tuple(bool(f) for f in is_cols)
        self.shape = tuple(shape)
        self.nx = nx
        self.n_pad = n_pad
        self.det_count = p
        self.n_groups = n_groups
        self.nnz = nnz

    @classmethod
    def from_scipy_fan(cls, A, nx, views, angles=None, n_groups=64,
                       dtype=None, lane_pad=128, n_buckets=4):
        # dtype "int8": per-angle absmax/127 scales, dequantized at apply
        # time (quantized class; half the weight bytes of bf16).
        int8 = dtype in ("int8", jnp.int8, np.int8)
        packs, idx, angles, p, n_pad = _pack_groups(A, nx, views, angles,
                                                    n_groups)
        p_pad = -(-p // lane_pad) * lane_pad
        out_dtype = np.float32 if (dtype is None or int8) else dtype
        stacks, aidxs, is_cols = [], [], []
        for dr in (True, False):
            group, ids = packs[dr], idx[dr]
            if not group:
                continue
            Ta = np.array([T_a for _, T_a, _, _ in group])
            order = np.argsort(Ta, kind="stable")
            for part in np.array_split(order, min(n_buckets, len(order))):
                if not len(part):
                    continue
                sub = [group[k] for k in part]
                W, S, P = _stack_packs(sub, n_pad, p, p_pad, n_groups,
                                       out_dtype)
                ai = [ids[k] for k in part]
                if int8:
                    sc = np.maximum(
                        np.abs(W).max(axis=(1, 2, 3)), 1e-30) / 127.0
                    Wq = np.rint(W / sc[:, None, None, None]).astype(
                        np.int8)
                    stacks.append((jnp.asarray(Wq), jnp.asarray(S),
                                   jnp.asarray(np.mod(P, n_pad)),
                                   jnp.asarray(sc.astype(np.float32))))
                else:
                    stacks.append((jnp.asarray(W), jnp.asarray(S),
                                   jnp.asarray(np.mod(P, n_pad))))
                aidxs.append(ai)
                is_cols.append(not dr)
        return cls(stacks, aidxs, is_cols, A.shape, nx, p, n_groups,
                   A.nnz, n_pad)

    @property
    def stored_bytes(self):
        return sum(st[0].size * st[0].dtype.itemsize
                   + st[1].size * 4 + st[2].size * 4
                   + (st[3].size * 4 if len(st) > 3 else 0)
                   for st in self.stacks)

    @staticmethod
    def _parts(stack):
        W, S, P = stack[:3]
        sc = stack[3] if len(stack) > 3 else None
        return W, S, P, sc

    @staticmethod
    def _dequant(W, sc):
        from .banded import dequant_slab

        return dequant_slab(W, sc)

    def to_scipy(self):
        """Exact reconstruction (host oracle) — same entry set as the flat
        pack."""
        from scipy import sparse as sp

        nx, p = self.nx, self.det_count
        gsize = self.n_pad // self.n_groups
        rows, cols, vals = [], [], []
        for stack, aidx, isc in zip(self.stacks, self.aidxs,
                                    self.is_cols):
            W, S, P, sc = self._parts(stack)
            if sc is not None:
                W = np.asarray(W, np.float32) * np.asarray(sc)[
                    :, None, None, None]
            W, S, P = map(np.asarray, (W, S, P))
            for k, a in enumerate(aidx):
                tt, ii, dd = np.nonzero(W[k])
                cc = np.mod(S[k][ii] + P[k][ii // gsize, dd] + tt,
                            self.n_pad)
                ok = (cc < nx) & (dd < p) & (ii < nx)
                ii, tt, dd, cc = ii[ok], tt[ok], dd[ok], cc[ok]
                pix = cc * nx + ii if isc else ii * nx + cc
                rows.append(a * p + dd)
                cols.append(pix)
                vals.append(W[k][tt, ii, dd])
        M = sp.csr_matrix(
            (np.concatenate(vals).astype(np.float64),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=self.shape)
        M.sum_duplicates()
        return M

    def _embed(self, x):
        n, npd = self.nx, self.n_pad
        X = jnp.reshape(x, (n, n)).astype(jnp.float32)
        if npd == n:
            return X
        return jnp.zeros((npd, npd), X.dtype).at[:n, :n].set(X)

    def matvec(self, x):
        n, p, npd = self.nx, self.det_count, self.n_pad
        na_tot = self.shape[0] // p
        X = self._embed(x)
        y = jnp.zeros((na_tot, p), jnp.float32)
        for stack, aidx, isc in zip(self.stacks, self.aidxs,
                                    self.is_cols):
            W, S, P, sc = self._parts(stack)
            Xg = X.T if isc else X
            yg = apply_group_xla(npd, self.n_groups, Xg,
                                 self._dequant(W, sc), S, P, False,
                                 wrap=True)
            y = y.at[jnp.asarray(aidx)].set(yg[:, :p], mode="drop")
        return y.reshape(-1).astype(x.dtype)

    def rmatvec(self, yv):
        n, p, npd = self.nx, self.det_count, self.n_pad
        Y = jnp.reshape(yv, (-1, p)).astype(jnp.float32)
        img = jnp.zeros((npd, npd), jnp.float32)
        for stack, aidx, isc in zip(self.stacks, self.aidxs,
                                    self.is_cols):
            W, S, P, sc = self._parts(stack)
            p_pad = W.shape[3]
            Yg = jnp.take(Y, jnp.asarray(aidx), axis=0, mode="fill",
                          fill_value=0.0)
            Yg = jnp.pad(Yg, ((0, 0), (0, p_pad - p)))
            c = apply_group_xla(npd, self.n_groups, None,
                                self._dequant(W, sc), S, P, True,
                                y_rows=Yg, wrap=True)
            img = img + (c.T if isc else c)
        return img[:n, :n].reshape(-1).astype(yv.dtype)

    def normal_matvec(self, x):
        """x -> A^T A x, bucket by bucket (each bucket's dequantized
        weights feed its forward and adjoint)."""
        n, npd = self.nx, self.n_pad
        X = self._embed(x)
        img = jnp.zeros((npd, npd), jnp.float32)
        for stack, aidx, isc in zip(self.stacks, self.aidxs,
                                    self.is_cols):
            W, S, P, sc = self._parts(stack)
            Xg = X.T if isc else X
            Wf = self._dequant(W, sc)
            yg = apply_group_xla(npd, self.n_groups, Xg, Wf, S, P,
                                 False, wrap=True)
            c = apply_group_xla(npd, self.n_groups, None, Wf, S, P,
                                True, y_rows=yg, wrap=True)
            img = img + (c.T if isc else c)
        return img[:n, :n].reshape(-1).astype(x.dtype)


register_op(
    BucketedBandedProjector,
    ["stacks"],
    ["aidxs", "is_cols", "shape", "nx", "det_count", "n_groups", "nnz",
     "n_pad"],
)

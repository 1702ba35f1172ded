"""Frame-varying dynamic CT on the banded format.

``BatchedBlockDiagOperator`` covers the shared-geometry dynamic datasets
(Emoji / CrossPhantom / STEMPO-real reuse one per-frame operator,
``trips/utilities/io.py:156-158,423-464``). The STEMPO *simulation* mode
instead rotates the angle set every frame
(``trips/utilities/io.py:391-420``), so every frame has its own projector.
``DynamicBandedOperator`` packs each frame's matrix into the shear-banded
format, pads all frames to common (na, T) shapes per drive group, and runs
the per-frame applies as ONE vmapped apply over the frame axis —
block-diagonal in time.

Padding is exact: padded angles carry all-zero weight slabs (zero
contribution in both directions) and their scatter indices point one past
the sinogram (dropped by scatter ``mode='drop'`` / gather fill 0).

Unlike BSR, the banded pack stores only the true band per angle, so the
wide parallel-beam STEMPO frames that density-exploded BSR (the r2 OOM,
see ``parallel/sharded_bsr.py`` guard) stay at their natural size here.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.linop import LinearOperator, register_op
from .banded import apply_group_xla


class DynamicBandedOperator(LinearOperator):
    """Block-diag over time of per-frame banded projectors with
    frame-varying geometry; applies vmapped over the frame axis."""

    def __init__(self, groups, shape, nx, p, views, n_groups, nnz, nt,
                 n_pad=None):
        # groups: two tuples (W, S, Pm, aidx) stacked over frames —
        # W (nt, na, T, n, p_pad), S (nt, na, n), Pm (nt, na, G, p_pad)
        # int32 mod-n, aidx (nt, na) with out-of-range pad = views
        (self.W_rows, self.shift_rows, self.P_rows, self.aidx_rows) = \
            groups[0]
        (self.W_cols, self.shift_cols, self.P_cols, self.aidx_cols) = \
            groups[1]
        self.shape = tuple(shape)
        self.nx = nx
        self.n_pad = nx if n_pad is None else n_pad
        self.det_count = p
        self.views = views
        self.n_groups = n_groups
        self.nnz = nnz
        self.nt = nt

    @classmethod
    def from_frames(cls, AA, nx, angles_list, n_groups=32, dtype=None,
                    lane_pad=128):
        """Pack per-frame matrices AA[t] (scipy, angle-major rows) built at
        ``angles_list[t]`` into one stacked operator."""
        nt = len(AA)
        assert len(angles_list) == nt
        views0 = len(angles_list[0])
        for t, a in enumerate(angles_list):
            if len(a) != views0:
                raise ValueError(
                    f"frame {t} has {len(a)} angles, expected {views0}: "
                    "the stacked sinogram layout (nt, views, p) requires a "
                    "uniform angle count per frame")
        # pack every frame on the host and scatter-fill ONE preallocated
        # (nt, na, T, n_pad, p_pad) stack per drive group — the previous
        # per-frame BandedProjector + pad/stack/asarray chain made 4-5
        # full copies of the (GB-scale) slabs and dominated dynamic pack
        # time (r4: 39 s for 3 STEMPO frames -> ~4 s)
        from .banded import _pack_groups
        from ..native import scatter_fill

        views = views0
        packed = []
        p = None
        for t in range(nt):
            packs, idx, _, p_t, n_pad = _pack_groups(
                AA[t], nx, None, np.asarray(angles_list[t]), n_groups)
            if p is None:
                p = p_t
            elif p_t != p:
                raise ValueError(
                    f"frame {t} has {p_t} detectors, expected {p}")
            packed.append((packs, idx))
        p_pad = -(-p // lane_pad) * lane_pad
        out_dtype = np.float32 if dtype is None else dtype

        def stack_group(dr):
            counts = [len(idx[dr]) for _, idx in packed]
            na_max = max(counts)
            T_max = max((T_a for packs, _ in packed
                         for _, T_a, _, _ in packs[dr]), default=1)
            if na_max == 0:
                return (jnp.asarray(np.zeros((nt, 0, 1, n_pad, p_pad),
                                             out_dtype)),
                        jnp.asarray(np.zeros((nt, 0, n_pad), np.int32)),
                        jnp.asarray(np.zeros((nt, 0, n_groups, p_pad),
                                             np.int32)),
                        jnp.asarray(np.full((nt, 0), views, np.int32)))
            W = np.zeros((nt, na_max, T_max, n_pad, p_pad), out_dtype)
            S = np.zeros((nt, na_max, n_pad), np.int32)
            P = np.zeros((nt, na_max, n_groups, p_pad), np.int32)
            Ai = np.full((nt, na_max), views, np.int32)
            for t, (packs, idx) in enumerate(packed):
                for k, ((tt, ii, dd, vv), _, shift, Pk) in enumerate(
                        packs[dr]):
                    if not scatter_fill(tt, ii, dd, vv, W[t, k]):
                        W[t, k][tt, ii, dd] = vv
                    S[t, k] = shift
                    P[t, k, :, :p] = Pk
                    P[t, k, :, p:] = Pk[:, -1:]  # edge pad (flat-stack rule)
                    Ai[t, k] = idx[dr][k]
            np.mod(P, n_pad, out=P)
            return (jnp.asarray(W), jnp.asarray(S), jnp.asarray(P),
                    jnp.asarray(Ai))

        rows = stack_group(True)
        cols = stack_group(False)
        m = sum(At.shape[0] for At in AA)
        ncols = nt * nx * nx
        nnz = sum(At.nnz for At in AA)
        return cls((rows, cols), (m, ncols), nx, p, views, n_groups, nnz,
                   nt, n_pad=n_pad)

    @property
    def stored_bytes(self):
        tot = 0
        for a in (self.W_rows, self.W_cols):
            tot += a.size * a.dtype.itemsize
        for a in (self.shift_rows, self.shift_cols, self.P_rows,
                  self.P_cols, self.aidx_rows, self.aidx_cols):
            tot += a.size * 4
        return tot

    def _groups(self):
        # (W, S, Pm, aidx, is_cols, scales-or-None); scales only for the
        # int8-stored bucketed subclass
        return ((self.W_rows, self.shift_rows, self.P_rows,
                 self.aidx_rows, False, None),
                (self.W_cols, self.shift_cols, self.P_cols,
                 self.aidx_cols, True, None))

    @staticmethod
    def _deq(W, sc):
        from .banded import dequant_slab

        return dequant_slab(W, sc)

    def _fwd_frame(self, W, S, Pm, X, sc=None):
        return apply_group_xla(self.n_pad, self.n_groups, X,
                               self._deq(W, sc), S, Pm, False, wrap=True)

    def _adj_frame(self, W, S, Pm, Yg, sc=None):
        return apply_group_xla(self.n_pad, self.n_groups, None,
                               self._deq(W, sc), S, Pm, True, y_rows=Yg,
                               wrap=True)

    def _ata_frame(self, W, S, Pm, X, sc=None):
        Wf = self._deq(W, sc)
        y = apply_group_xla(self.n_pad, self.n_groups, X, Wf, S, Pm,
                            False, wrap=True)
        return apply_group_xla(self.n_pad, self.n_groups, None, Wf, S, Pm,
                               True, y_rows=y, wrap=True)

    @staticmethod
    def _vmap_frames(fn, W, S, Pm, arg, sc):
        if sc is None:
            return jax.vmap(lambda w, s, p, a: fn(w, s, p, a))(
                W, S, Pm, arg)
        return jax.vmap(lambda w, s, p, a, c: fn(w, s, p, a, c))(
            W, S, Pm, arg, sc)

    def _embed_frames(self, X):
        n, npd = self.nx, self.n_pad
        if npd == n:
            return X
        return jnp.zeros((self.nt, npd, npd), X.dtype).at[
            :, :n, :n].set(X)

    def matvec(self, x):
        n, p, v = self.nx, self.det_count, self.views
        X = self._embed_frames(
            x.reshape(self.nt, n, n).astype(jnp.float32))
        y = jnp.zeros((self.nt, v, p), jnp.float32)
        for W, S, Pm, aidx, is_cols, sc in self._groups():
            if not W.size:
                continue
            Xg = jnp.swapaxes(X, 1, 2) if is_cols else X
            yg = self._vmap_frames(self._fwd_frame, W, S, Pm, Xg, sc)
            y = jax.vmap(
                lambda yy, gg, ai: yy.at[ai].set(gg[:, :p], mode="drop")
            )(y, yg, aidx)
        return y.reshape(-1).astype(x.dtype)

    def rmatvec(self, yv):
        n, p, v = self.nx, self.det_count, self.views
        Y = yv.reshape(self.nt, v, p).astype(jnp.float32)
        img = jnp.zeros((self.nt, n, n), jnp.float32)
        for W, S, Pm, aidx, is_cols, sc in self._groups():
            if not W.size:
                continue
            p_pad = W.shape[4]
            Yg = jax.vmap(lambda yy, ai: jnp.take(
                yy, ai, axis=0, mode="fill", fill_value=0.0))(Y, aidx)
            Yg = jnp.pad(Yg, ((0, 0), (0, 0), (0, p_pad - p)))
            c = self._vmap_frames(self._adj_frame, W, S, Pm, Yg, sc)
            img = img + (jnp.swapaxes(c, 1, 2) if is_cols else c)[
                :, :n, :n]
        return img.reshape(-1).astype(yv.dtype)

    def normal_matvec(self, x):
        """Per-frame A^T A vmapped over frames."""
        n = self.nx
        X = self._embed_frames(
            x.reshape(self.nt, n, n).astype(jnp.float32))
        img = jnp.zeros((self.nt, n, n), jnp.float32)
        for W, S, Pm, aidx, is_cols, sc in self._groups():
            if not W.size:
                continue
            Xg = jnp.swapaxes(X, 1, 2) if is_cols else X
            c = self._vmap_frames(self._ata_frame, W, S, Pm, Xg, sc)
            img = img + (jnp.swapaxes(c, 1, 2) if is_cols else c)[
                :, :n, :n]
        return img.reshape(-1).astype(x.dtype)


register_op(
    DynamicBandedOperator,
    ["W_rows", "shift_rows", "P_rows", "aidx_rows",
     "W_cols", "shift_cols", "P_cols", "aidx_cols"],
    ["shape", "nx", "det_count", "views", "n_groups", "nnz", "nt",
     "n_pad"],
)


class BucketedDynamicBandedOperator(DynamicBandedOperator):
    """Ta-bucketed dynamic banded operator: within each drive group,
    every frame's angle entries are sorted by their true tap width and
    split into ``n_buckets`` equal-count buckets, each stacked at its own
    T — the same stored-byte cut as ``BucketedBandedProjector``. Same
    exact per-frame matrices; the parent's vmapped applies run unchanged
    over the per-bucket groups."""

    def __init__(self, stacks, is_cols, shape, nx, p, views, n_groups,
                 nnz, nt, n_pad):
        self.stacks = tuple(tuple(s) for s in stacks)
        self.is_cols = tuple(bool(f) for f in is_cols)
        self.shape = tuple(shape)
        self.nx = nx
        self.n_pad = n_pad
        self.det_count = p
        self.views = views
        self.n_groups = n_groups
        self.nnz = nnz
        self.nt = nt

    def _groups(self):
        return tuple(
            (st[0], st[1], st[2], st[3], isc,
             st[4] if len(st) > 4 else None)
            for st, isc in zip(self.stacks, self.is_cols))

    @property
    def stored_bytes(self):
        return sum(st[0].size * st[0].dtype.itemsize
                   + (st[1].size + st[2].size + st[3].size) * 4
                   + (st[4].size * 4 if len(st) > 4 else 0)
                   for st in self.stacks)

    @classmethod
    def from_frames(cls, AA, nx, angles_list, n_groups=32, dtype=None,
                    lane_pad=128, n_buckets=3):
        # dtype "int8": per-(frame, angle) absmax/127 scales, dequantized
        # at apply time
        from .banded import _pack_groups
        from ..native import scatter_fill

        int8 = dtype in ("int8", jnp.int8, np.int8)
        if int8:
            dtype = None  # pack in f32, quantize per bucket below
        nt = len(AA)
        assert len(angles_list) == nt
        views = len(angles_list[0])
        for t, a in enumerate(angles_list):
            if len(a) != views:
                raise ValueError(
                    f"frame {t} has {len(a)} angles, expected {views}")
        packed = []
        p = None
        for t in range(nt):
            packs, idx, _, p_t, n_pad = _pack_groups(
                AA[t], nx, None, np.asarray(angles_list[t]), n_groups)
            if p is None:
                p = p_t
            elif p_t != p:
                raise ValueError(
                    f"frame {t} has {p_t} detectors, expected {p}")
            packed.append((packs, idx))
        p_pad = -(-p // lane_pad) * lane_pad
        out_dtype = np.float32 if dtype is None else dtype

        stacks, flags = [], []
        for dr in (True, False):
            na_max = max(len(idx[dr]) for _, idx in packed)
            if na_max == 0:
                continue
            # per frame: entries ordered by tap width (pads = width 0
            # first), so bucket b holds every frame's b-th Ta quantile
            per_frame = []
            for packs, idx in packed:
                ent = [(T_a, pr, sh, Pk, idx[dr][k])
                       for k, (pr, T_a, sh, Pk) in enumerate(packs[dr])]
                ent += [(0, None, None, None, views)] * (na_max - len(ent))
                ent.sort(key=lambda e: e[0])
                per_frame.append(ent)
            parts = np.array_split(np.arange(na_max),
                                   min(n_buckets, na_max))
            for part in parts:
                if not len(part):
                    continue
                T_b = max(max(per_frame[t][k][0] for k in part)
                          for t in range(nt))
                T_b = max(T_b, 1)
                W = np.zeros((nt, len(part), T_b, n_pad, p_pad), out_dtype)
                S = np.zeros((nt, len(part), n_pad), np.int32)
                P = np.zeros((nt, len(part), n_groups, p_pad), np.int32)
                Ai = np.full((nt, len(part)), views, np.int32)
                for t in range(nt):
                    for j, k in enumerate(part):
                        T_a, pr, sh, Pk, aid = per_frame[t][k]
                        if pr is None:
                            continue
                        tt, ii, dd, vv = pr
                        if not scatter_fill(tt, ii, dd, vv, W[t, j]):
                            W[t, j][tt, ii, dd] = vv
                        S[t, j] = sh
                        P[t, j, :, :p] = Pk
                        P[t, j, :, p:] = Pk[:, -1:]
                        Ai[t, j] = aid
                np.mod(P, n_pad, out=P)
                if int8:
                    sc = np.maximum(
                        np.abs(W).max(axis=(2, 3, 4)), 1e-30) / 127.0
                    Wq = np.rint(
                        W / sc[:, :, None, None, None]).astype(np.int8)
                    stacks.append((jnp.asarray(Wq), jnp.asarray(S),
                                   jnp.asarray(P), jnp.asarray(Ai),
                                   jnp.asarray(sc.astype(np.float32))))
                else:
                    stacks.append((jnp.asarray(W), jnp.asarray(S),
                                   jnp.asarray(P), jnp.asarray(Ai)))
                flags.append(not dr)
        m = sum(At.shape[0] for At in AA)
        nnz = sum(At.nnz for At in AA)
        return cls(stacks, flags, (m, nt * nx * nx), nx, p, views,
                   n_groups, nnz, nt, n_pad)


register_op(
    BucketedDynamicBandedOperator,
    ["stacks"],
    ["is_cols", "shape", "nx", "det_count", "views", "n_groups", "nnz",
     "nt", "n_pad"],
)

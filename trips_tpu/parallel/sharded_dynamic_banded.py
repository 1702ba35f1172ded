"""(time x angles)-sharded dynamic banded projector.

The dynamic block-diagonal system has two embarrassingly parallel axes:
frames (no cross-frame coupling in A — only the spacetime-TV operator
couples neighbors) and, within a frame, angles (independent forward,
additive adjoint). ``DynamicBandedOperator`` stacks per-frame banded packs
as (nt, na, T, n_pad, p_pad) arrays, which map directly onto a 2-D
('time', 'angles') mesh:

- forward: zero collectives — each device applies its (frame-slab x
  angle-slab) weights to its frames' replicated-within-time images;
- adjoint / fused A^T A: one ``psum`` over the 'angles' axis per frame
  slab (the n_pad^2 image contribution) — nothing crosses the time axis.

SURVEY §5.7's "frames across hosts x rows within a frame" realized as
frames x angles on the banded format. The spacetime-TV halo over time is handled by the L operator
(GSPMD nearest-neighbor), not here.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

from ..core.linop import LinearOperator, register_op
from ..sparse.banded import apply_group_xla
from ..sparse.dynamic_banded import DynamicBandedOperator


class ShardedDynamicBandedOperator(LinearOperator):
    """DynamicBandedOperator with frames sharded over 'time' and each
    frame's angles sharded over 'angles'."""

    def __init__(self, groups, shape, nx, p, views, n_groups, nnz, nt,
                 n_pad, mesh, t_axis, a_axis):
        (self.W_rows, self.shift_rows, self.P_rows, self.aidx_rows) = \
            groups[0]
        (self.W_cols, self.shift_cols, self.P_cols, self.aidx_cols) = \
            groups[1]
        self.shape = tuple(shape)
        self.nx = nx
        self.n_pad = n_pad
        self.det_count = p
        self.views = views
        self.n_groups = n_groups
        self.nnz = nnz
        self.nt = nt
        self.mesh = mesh
        self.t_axis = t_axis
        self.a_axis = a_axis

    @classmethod
    def from_dynamic(cls, op: DynamicBandedOperator, mesh,
                     t_axis: str = "time", a_axis: str = "angles"):
        T_dev = mesh.shape[t_axis]
        A_dev = mesh.shape[a_axis]
        if op.nt % T_dev:
            raise ValueError(
                f"nt={op.nt} must be a multiple of the '{t_axis}' mesh "
                f"axis ({T_dev}); pad the frame list.")

        def sh(a, spec):
            return jax.device_put(
                jnp.asarray(a), NamedSharding(mesh, spec))

        def prep(W, S, Pm, aidx):
            W, S, Pm, aidx = map(np.asarray, (W, S, Pm, aidx))
            na = W.shape[1]
            na_pad = max(-(-na // A_dev) * A_dev, A_dev)
            padn = na_pad - na
            if W.size == 0:
                W = np.zeros((op.nt, 0) + W.shape[2:], W.dtype)
            W = np.pad(W, ((0, 0), (0, padn)) + ((0, 0),) * (W.ndim - 2))
            S = np.pad(S, ((0, 0), (0, padn), (0, 0)))
            Pm = np.pad(Pm, ((0, 0), (0, padn), (0, 0), (0, 0)))
            # padded angles: zero weights; scatter index out of range
            aidx = np.pad(aidx, ((0, 0), (0, padn)),
                          constant_values=op.views)
            full = (t_axis, a_axis)
            return (sh(W, PartitionSpec(*full, None, None, None)),
                    sh(S, PartitionSpec(*full, None)),
                    sh(Pm, PartitionSpec(*full, None, None)),
                    sh(aidx, PartitionSpec(t_axis, None)))

        rows = prep(op.W_rows, op.shift_rows, op.P_rows, op.aidx_rows)
        cols = prep(op.W_cols, op.shift_cols, op.P_cols, op.aidx_cols)
        return cls((rows, cols), op.shape, op.nx, op.det_count, op.views,
                   op.n_groups, op.nnz, op.nt, op.n_pad, mesh, t_axis,
                   a_axis)

    @property
    def stored_bytes(self):
        return (self.W_rows.size * self.W_rows.dtype.itemsize
                + self.W_cols.size * self.W_cols.dtype.itemsize)

    def _groups(self):
        # (W, S, Pm, aidx, is_cols, scales-or-None)
        return ((self.W_rows, self.shift_rows, self.P_rows,
                 self.aidx_rows, False, None),
                (self.W_cols, self.shift_cols, self.P_cols,
                 self.aidx_cols, True, None))

    _deq = staticmethod(DynamicBandedOperator._deq)

    def _frame_fwd(self, W, S, Pm, X, sc=None):
        return apply_group_xla(self.n_pad, self.n_groups, X,
                               self._deq(W, sc), S, Pm, False, wrap=True)

    def _frame_adj(self, W, S, Pm, Yg, sc=None):
        return apply_group_xla(self.n_pad, self.n_groups, None,
                               self._deq(W, sc), S, Pm, True, y_rows=Yg,
                               wrap=True)

    def _frame_ata(self, W, S, Pm, X, sc=None):
        Wf = self._deq(W, sc)
        y = apply_group_xla(self.n_pad, self.n_groups, X, Wf, S, Pm,
                            False, wrap=True)
        return apply_group_xla(self.n_pad, self.n_groups, None, Wf, S, Pm,
                               True, y_rows=y, wrap=True)

    _vmap_frames = staticmethod(DynamicBandedOperator._vmap_frames)

    def _embed(self, x):
        n, npd = self.nx, self.n_pad
        X = x.reshape(self.nt, n, n).astype(jnp.float32)
        if npd == n:
            return X
        return jnp.zeros((self.nt, npd, npd), X.dtype).at[
            :, :n, :n].set(X)

    # -- single-program merged applies --------------------------------
    #
    # Both drive groups run inside ONE shard_map program per apply; their
    # image contributions are summed locally so exactly ONE psum over the
    # 'angles' axis crosses the mesh per adjoint/normal apply.

    def _active(self):
        return [g for g in self._groups() if g[0].size]

    def _flat_args(self, groups):
        return [a for g in groups
                for a in ((g[0], g[1], g[2])
                          + ((g[5],) if g[5] is not None else ()))]

    def _group_specs(self, groups):
        ta, aa = self.t_axis, self.a_axis
        return sum(
            ((PartitionSpec(ta, aa, None, None, None),
              PartitionSpec(ta, aa, None),
              PartitionSpec(ta, aa, None, None))
             + ((PartitionSpec(ta, aa),) if g[5] is not None else ())
             for g in groups), ())

    def matvec(self, x):
        n, p, v = self.nx, self.det_count, self.views
        X = self._embed(x)
        ta, aa = self.t_axis, self.a_axis
        y = jnp.zeros((self.nt, v, p), jnp.float32)
        groups = self._active()

        def local(X, *flat):
            outs = []
            k = 0
            for g in groups:
                is_cols, has_sc = g[4], g[5] is not None
                W, S, Pm = flat[k:k + 3]
                sc = flat[k + 3] if has_sc else None
                k += 4 if has_sc else 3
                Xg = jnp.swapaxes(X, 1, 2) if is_cols else X
                outs.append(self._vmap_frames(self._frame_fwd, W, S, Pm,
                                              Xg, sc))
            return tuple(outs)

        f = jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(PartitionSpec(ta, None, None),)
            + self._group_specs(groups),
            out_specs=tuple(PartitionSpec(ta, aa, None) for _ in groups))
        outs = f(X, *self._flat_args(groups))
        for yg, g in zip(outs, groups):
            y = jax.vmap(
                lambda yy, gg, ai: yy.at[ai].set(gg[:, :p], mode="drop")
            )(y, yg, g[3])
        return y.reshape(-1).astype(x.dtype)

    def rmatvec(self, yv):
        n, p, v = self.nx, self.det_count, self.views
        Y = yv.reshape(self.nt, v, p).astype(jnp.float32)
        ta, aa = self.t_axis, self.a_axis
        groups = self._active()

        def local(*args):
            ys, flat = args[:len(groups)], args[len(groups):]
            acc = None
            k = 0
            for i, g in enumerate(groups):
                is_cols, has_sc = g[4], g[5] is not None
                W, S, Pm = flat[k:k + 3]
                sc = flat[k + 3] if has_sc else None
                k += 4 if has_sc else 3
                c = self._vmap_frames(self._frame_adj, W, S, Pm, ys[i], sc)
                c = jnp.swapaxes(c, 1, 2) if is_cols else c
                acc = c if acc is None else acc + c
            return jax.lax.psum(acc, aa)

        ys = []
        for g in groups:
            W, aidx = g[0], g[3]
            p_pad = W.shape[4]
            Yg = jax.vmap(lambda yy, ai: jnp.take(
                yy, ai, axis=0, mode="fill", fill_value=0.0))(Y, aidx)
            ys.append(jnp.pad(Yg, ((0, 0), (0, 0), (0, p_pad - p))))
        f = jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(PartitionSpec(ta, aa, None),) * len(groups)
            + self._group_specs(groups),
            out_specs=PartitionSpec(ta, None, None))
        img = f(*ys, *self._flat_args(groups))
        return img[:, :n, :n].reshape(-1).astype(yv.dtype)

    def normal_matvec(self, x):
        """Per-angle A^T A on every (frame, angle) shard of BOTH drive
        groups, locally summed; ONE psum over the 'angles' axis per
        apply."""
        n = self.nx
        X = self._embed(x)
        ta, aa = self.t_axis, self.a_axis
        groups = self._active()

        def local(X, *flat):
            acc = None
            k = 0
            for g in groups:
                is_cols, has_sc = g[4], g[5] is not None
                W, S, Pm = flat[k:k + 3]
                sc = flat[k + 3] if has_sc else None
                k += 4 if has_sc else 3
                Xg = jnp.swapaxes(X, 1, 2) if is_cols else X
                c = self._vmap_frames(self._frame_ata, W, S, Pm, Xg, sc)
                c = jnp.swapaxes(c, 1, 2) if is_cols else c
                acc = c if acc is None else acc + c
            return jax.lax.psum(acc, aa)

        f = jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(PartitionSpec(ta, None, None),)
            + self._group_specs(groups),
            out_specs=PartitionSpec(ta, None, None))
        img = f(X, *self._flat_args(groups))
        return img[:, :n, :n].reshape(-1).astype(x.dtype)


register_op(
    ShardedDynamicBandedOperator,
    ["W_rows", "shift_rows", "P_rows", "aidx_rows",
     "W_cols", "shift_cols", "P_cols", "aidx_cols"],
    ["shape", "nx", "n_pad", "det_count", "views", "n_groups", "nnz",
     "nt", "mesh", "t_axis", "a_axis"],
)


class ShardedBucketedDynamicBandedOperator(ShardedDynamicBandedOperator):
    """(time x angles)-sharded Ta-bucketed dynamic operator
    (``BucketedDynamicBandedOperator`` on the full dynamic mesh).

    Every bucket's angle dim is padded to a multiple of the 'angles' mesh
    axis (zero-weight angles, out-of-range scatter ids) and sharded; all
    buckets of both drive groups run inside the same shard_map program per
    apply with ONE psum over 'angles' (jaxpr-pinned)."""

    def __init__(self, stacks, is_cols, shape, nx, p, views, n_groups,
                 nnz, nt, n_pad, mesh, t_axis, a_axis):
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
        self.mesh = mesh
        self.t_axis = t_axis
        self.a_axis = a_axis

    @classmethod
    def from_dynamic(cls, op, mesh, t_axis: str = "time",
                     a_axis: str = "angles"):
        """Shard a ``sparse.dynamic_banded.BucketedDynamicBandedOperator``."""
        T_dev = mesh.shape[t_axis]
        A_dev = mesh.shape[a_axis]
        if op.nt % T_dev:
            raise ValueError(
                f"nt={op.nt} must be a multiple of the '{t_axis}' mesh "
                f"axis ({T_dev}); pad the frame list.")
        def sh(a, spec):
            return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

        stacks = []
        for st in op.stacks:
            W, S, Pm, Ai = map(np.asarray, st[:4])
            sc = np.asarray(st[4]) if len(st) > 4 else None
            na = W.shape[1]
            na_pad = max(-(-na // A_dev) * A_dev, A_dev)
            padn = na_pad - na
            W = np.pad(W, ((0, 0), (0, padn)) + ((0, 0),) * (W.ndim - 2))
            S = np.pad(S, ((0, 0), (0, padn), (0, 0)))
            Pm = np.pad(Pm, ((0, 0), (0, padn), (0, 0), (0, 0)))
            Ai = np.pad(Ai, ((0, 0), (0, padn)), constant_values=op.views)
            full = (t_axis, a_axis)
            entry = (
                sh(W, PartitionSpec(*full, None, None, None)),
                sh(S, PartitionSpec(*full, None)),
                sh(Pm, PartitionSpec(*full, None, None)),
                sh(Ai, PartitionSpec(t_axis, None)))
            if sc is not None:
                entry = entry + (sh(np.pad(sc, ((0, 0), (0, padn)),
                                           constant_values=1.0),
                                    PartitionSpec(*full)),)
            stacks.append(entry)
        return cls(stacks, op.is_cols, op.shape, op.nx, op.det_count,
                   op.views, op.n_groups, op.nnz, op.nt, op.n_pad, mesh,
                   t_axis, a_axis)

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


register_op(
    ShardedBucketedDynamicBandedOperator,
    ["stacks"],
    ["is_cols", "shape", "nx", "det_count", "views", "n_groups", "nnz",
     "nt", "n_pad", "mesh", "t_axis", "a_axis"],
)

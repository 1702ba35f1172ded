"""Angle-sharded banded projector: the banded format across devices.

The shear-packed banded projector (``sparse/banded.py``) is angle-major:
every angle is independent in the forward and contributes additively in
the adjoint, so the natural mesh partition is **angles across devices**:

- forward: each device applies its local angle slab to the replicated
  image and emits its sinogram rows — no cross-device communication;
- adjoint: each device accumulates its local angles' image contribution,
  then one ``psum`` over the mesh axis replicates the image (n*n floats —
  tiny next to the weight stream).

Both drive groups (row-driven / column-driven angles) are padded to a
multiple of the mesh axis with zero-weight angles (zero contribution in
both directions). ``P`` is stored mod-n (``apply_group_xla(wrap=True)``).

Distribution is a new subsystem (reference is single-process NumPy,
SURVEY.md §2.10).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

from ..core.linop import LinearOperator, register_op
from ..sparse.banded import BandedProjector, apply_group_xla


class ShardedBandedProjector(LinearOperator):
    """BandedProjector with both drive groups angle-sharded over a 1-D
    mesh axis."""

    def __init__(self, groups, shape, nx, p, n_groups, nnz, mesh, axis,
                 n_pad=None):
        # groups: ((W, S, Pm, aidx, na_real, is_cols), ...) — arrays
        # sharded on dim 0; aidx host tuple of global angle ids
        (self.W_rows, self.shift_rows, self.P_rows,
         self._angles_rows, self._na_rows, _) = groups[0]
        (self.W_cols, self.shift_cols, self.P_cols,
         self._angles_cols, self._na_cols, _) = groups[1]
        self.shape = tuple(shape)
        self.nx = nx
        self.n_pad = nx if n_pad is None else n_pad
        self.det_count = p
        self.n_groups = n_groups
        self.nnz = nnz
        self.mesh = mesh
        self.axis = axis

    @classmethod
    def from_banded(cls, op: BandedProjector, mesh, axis: str = "rows"):
        S_dev = mesh.shape[axis]
        n = op.n_pad
        sh = lambda a: jax.device_put(
            jnp.asarray(a),
            NamedSharding(mesh, PartitionSpec(
                axis, *(None,) * (np.ndim(a) - 1))))

        def prep(W, Sf, Pm, aidx):
            W, Sf, Pm = map(np.asarray, (W, Sf, Pm))
            na = W.shape[0]
            na_pad = max(-(-na // S_dev) * S_dev, S_dev)
            padn = na_pad - na
            if W.size == 0:
                W = np.zeros((0, 1, n, 128), W.dtype)
                Sf = np.zeros((0, n), np.int32)
                Pm = np.zeros((0, op.n_groups, 128), np.int32)
            W = np.pad(W, ((0, padn),) + ((0, 0),) * (W.ndim - 1))
            Sf = np.pad(Sf, ((0, padn), (0, 0)))
            Pm = np.mod(np.pad(Pm, ((0, padn), (0, 0), (0, 0))), n)
            return (sh(W), sh(Sf), sh(Pm), tuple(aidx), na, None)

        g_rows = prep(op.W_rows, op.shift_rows, op.P_rows, op._angles_rows)
        g_cols = prep(op.W_cols, op.shift_cols, op.P_cols, op._angles_cols)
        return cls((g_rows[:5] + (False,), g_cols[:5] + (True,)),
                   op.shape, op.nx, op.det_count, op.n_groups, op.nnz,
                   mesh, axis, n_pad=op.n_pad)

    @property
    def stored_bytes(self):
        return (self.W_rows.size * self.W_rows.dtype.itemsize
                + self.W_cols.size * self.W_cols.dtype.itemsize)

    def _groups(self):
        # (W, S, Pm, angle_ids, na_real, is_cols, scales-or-None);
        # scales only for int8-stored bucketed packs
        return (
            (self.W_rows, self.shift_rows, self.P_rows,
             self._angles_rows, self._na_rows, False, None),
            (self.W_cols, self.shift_cols, self.P_cols,
             self._angles_cols, self._na_cols, True, None),
        )

    @staticmethod
    def _deq(W, sc):
        from ..sparse.banded import dequant_slab

        return dequant_slab(W, sc)

    # -- single-program merged applies --------------------------------
    #
    # Both drive groups run inside ONE shard_map program per apply; the
    # adjoint/normal contributions of the two groups are summed locally so
    # exactly ONE psum of one (n_pad, n_pad) image crosses the mesh per
    # apply (previously: one program + one full-image psum per group — 2x
    # dispatch and 2x collective volume).

    def _active(self):
        return [g for g in self._groups() if g[4] > 0]

    def _flat_args(self, groups):
        return [a for g in groups
                for a in ((g[0], g[1], g[2])
                          + ((g[6],) if g[6] is not None else ()))]

    def _flat_specs(self, groups, ax):
        return sum((((PartitionSpec(ax),) * (4 if g[6] is not None else 3))
                    for g in groups), ())

    def _embed(self, x):
        n, npd = self.nx, self.n_pad
        X0 = jnp.reshape(x, (n, n)).astype(jnp.float32)
        if npd != n:
            X0 = jnp.zeros((npd, npd), X0.dtype).at[:n, :n].set(X0)
        return X0

    def matvec(self, x):
        n, p = self.nx, self.det_count
        npd = self.n_pad
        na_tot = self.shape[0] // p
        X0 = self._embed(x)
        y = jnp.zeros((na_tot, p), jnp.float32)
        ax = self.axis
        ng = self.n_groups
        groups = self._active()

        def local_fwd(X, *flat):
            outs = []
            k = 0
            for g in groups:
                is_cols, has_sc = g[5], g[6] is not None
                W, Sf, Pm = flat[k:k + 3]
                sc = flat[k + 3] if has_sc else None
                k += 4 if has_sc else 3
                Xg = X.T if is_cols else X
                outs.append(apply_group_xla(npd, ng, Xg, self._deq(W, sc),
                                            Sf, Pm, False, wrap=True))
            return tuple(outs)

        f = jax.shard_map(
            local_fwd, mesh=self.mesh,
            in_specs=(PartitionSpec(),) + self._flat_specs(groups, ax),
            out_specs=tuple(PartitionSpec(ax) for _ in groups))
        outs = f(X0, *self._flat_args(groups))
        for yg, g in zip(outs, groups):
            aidx, na_real = g[3], g[4]
            y = y.at[jnp.asarray(aidx)].set(yg[:na_real, :p], mode="drop")
        return y.reshape(-1).astype(x.dtype)

    def normal_matvec(self, x):
        """x -> A^T A x: forward and adjoint on each device's local angle
        slab of BOTH drive groups, locally summed, then ONE psum over the
        mesh axis — exactly one collective (n_pad^2 f32) per apply."""
        n = self.nx
        npd = self.n_pad
        X0 = self._embed(x)
        ax = self.axis
        ng = self.n_groups
        groups = self._active()

        def local_ata(X, *flat):
            acc = jnp.zeros((npd, npd), jnp.float32)
            k = 0
            for g in groups:
                is_cols, has_sc = g[5], g[6] is not None
                W, Sf, Pm = flat[k:k + 3]
                sc = flat[k + 3] if has_sc else None
                k += 4 if has_sc else 3
                Xg = X.T if is_cols else X
                Wf = self._deq(W, sc)
                yg = apply_group_xla(npd, ng, Xg, Wf, Sf, Pm, False,
                                     wrap=True)
                c = apply_group_xla(npd, ng, None, Wf, Sf, Pm, True,
                                    y_rows=yg, wrap=True)
                acc = acc + (c.T if is_cols else c)
            return jax.lax.psum(acc, ax)

        f = jax.shard_map(
            local_ata, mesh=self.mesh,
            in_specs=(PartitionSpec(),) + self._flat_specs(groups, ax),
            out_specs=PartitionSpec())
        img = f(X0, *self._flat_args(groups))
        return img[:n, :n].reshape(-1).astype(x.dtype)

    def rmatvec(self, yv):
        n, p = self.nx, self.det_count
        npd = self.n_pad
        Y = jnp.reshape(yv, (-1, p)).astype(jnp.float32)
        ax = self.axis
        ng = self.n_groups
        groups = self._active()

        def local_adj(*args):
            ys, flat = args[:len(groups)], args[len(groups):]
            acc = jnp.zeros((npd, npd), jnp.float32)
            k = 0
            for i, g in enumerate(groups):
                is_cols, has_sc = g[5], g[6] is not None
                W, Sf, Pm = flat[k:k + 3]
                sc = flat[k + 3] if has_sc else None
                k += 4 if has_sc else 3
                c = apply_group_xla(npd, ng, None, self._deq(W, sc), Sf, Pm,
                                    True, y_rows=ys[i], wrap=True)
                acc = acc + (c.T if is_cols else c)
            return jax.lax.psum(acc, ax)

        f = jax.shard_map(
            local_adj, mesh=self.mesh,
            in_specs=(PartitionSpec(ax),) * len(groups)
            + self._flat_specs(groups, ax),
            out_specs=PartitionSpec())
        ys = []
        for g in groups:
            W, aidx, na_real = g[0], g[3], g[4]
            na_pad, p_pad = W.shape[0], W.shape[3]
            Yg = jnp.take(Y, jnp.asarray(aidx), axis=0, mode="fill",
                          fill_value=0.0)
            ys.append(jnp.pad(Yg, ((0, na_pad - na_real), (0, p_pad - p))))
        img = f(*ys, *self._flat_args(groups))
        return img[:n, :n].reshape(-1).astype(yv.dtype)


register_op(
    ShardedBandedProjector,
    ["W_rows", "shift_rows", "P_rows", "W_cols", "shift_cols", "P_cols"],
    ["_angles_rows", "_na_rows", "_angles_cols", "_na_cols", "shape", "nx",
     "det_count", "n_groups", "nnz", "mesh", "axis", "n_pad"],
)


class ShardedBucketedBandedProjector(ShardedBandedProjector):
    """Angle-sharded Ta-bucketed banded projector
    (``BucketedBandedProjector`` carried to the mesh).

    Each bucket's angle dim is padded to a multiple of the mesh axis with
    zero-weight angles and sharded on dim 0; all buckets of both drive
    groups run inside the SAME single shard_map program per apply, locally
    summed, so the single-psum-per-normal/adjoint-apply economy of the flat
    sharded operator is preserved (jaxpr-pinned in tests)."""

    def __init__(self, stacks, aidxs, na_reals, is_cols, shape, nx, p,
                 n_groups, nnz, mesh, axis, n_pad):
        self.stacks = tuple(tuple(s) for s in stacks)
        self.aidxs = tuple(tuple(int(a) for a in ai) for ai in aidxs)
        self.na_reals = tuple(int(v) for v in na_reals)
        self.is_cols = tuple(bool(f) for f in is_cols)
        self.shape = tuple(shape)
        self.nx = nx
        self.n_pad = n_pad
        self.det_count = p
        self.n_groups = n_groups
        self.nnz = nnz
        self.mesh = mesh
        self.axis = axis

    @classmethod
    def from_bucketed(cls, op, mesh, axis: str = "angles"):
        """Shard a ``sparse.banded_buckets.BucketedBandedProjector``
        (f32/bf16 or int8-with-scales storage)."""
        S_dev = mesh.shape[axis]

        def sh(a):
            return jax.device_put(
                jnp.asarray(a),
                NamedSharding(mesh, PartitionSpec(
                    axis, *(None,) * (np.ndim(a) - 1))))

        stacks, na_reals = [], []
        for st in op.stacks:
            W, S, P = map(np.asarray, st[:3])
            sc = np.asarray(st[3]) if len(st) > 3 else None
            na = W.shape[0]
            na_pad = max(-(-na // S_dev) * S_dev, S_dev)
            padn = na_pad - na
            W = np.pad(W, ((0, padn),) + ((0, 0),) * (W.ndim - 1))
            S = np.pad(S, ((0, padn), (0, 0)))
            P = np.pad(P, ((0, padn), (0, 0), (0, 0)))
            entry = (sh(W), sh(S), sh(P))
            if sc is not None:
                # padded angles carry zero weights; scale value is inert
                entry = entry + (sh(np.pad(sc, (0, padn),
                                           constant_values=1.0)),)
            stacks.append(entry)
            na_reals.append(na)
        return cls(stacks, op.aidxs, na_reals, op.is_cols, op.shape,
                   op.nx, op.det_count, op.n_groups, op.nnz, mesh, axis,
                   op.n_pad)

    def _groups(self):
        return tuple(
            (st[0], st[1], st[2], ai, na, isc,
             st[3] if len(st) > 3 else None)
            for st, ai, na, isc in zip(self.stacks, self.aidxs,
                                       self.na_reals, self.is_cols))

    @property
    def stored_bytes(self):
        return sum(st[0].size * st[0].dtype.itemsize
                   + st[1].size * 4 + st[2].size * 4
                   + (st[3].size * 4 if len(st) > 3 else 0)
                   for st in self.stacks)


register_op(
    ShardedBucketedBandedProjector,
    ["stacks"],
    ["aidxs", "na_reals", "is_cols", "shape", "nx", "det_count",
     "n_groups", "nnz", "mesh", "axis", "n_pad"],
)

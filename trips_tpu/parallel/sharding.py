"""Multi-chip sharding for sparse operators and dynamic CT.

The reference is a single NumPy process (SURVEY.md §2.10); distribution is a
new first-class subsystem here. Design (per BASELINE):

- 1-D mesh axis 'rows': the operator's rows (detector readings) are
  partitioned across chips; x lives replicated, y row-sharded. The forward
  SpMV is embarrassingly parallel; the adjoint apply contracts each chip's
  transpose partition against its local y-slice and psums partials — XLA
  GSPMD materializes the collectives from the sharding annotations.
- 2-D mesh ('time', 'rows') for dynamic CT: frames across 'time' (the
  embarrassingly-parallel axis the reference loops over serially), rows
  within each frame across 'rows'. The spacetime-TV time difference is the
  only cross-frame communication — a nearest-neighbor halo XLA lowers to a
  collective-permute.

Krylov scalar reductions (alpha/beta/gamma/norms) become cross-mesh psums
automatically under jit.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import round_up
from ..core.linop import LinearOperator, register_op
from ..sparse.ell import EllOperator, _ell_matvec


def make_mesh(axis_sizes: dict, devices=None):
    """Mesh from {'time': t, 'rows': r}; total must divide available devices."""
    devices = devices if devices is not None else jax.devices()
    names = tuple(axis_sizes.keys())
    sizes = tuple(axis_sizes.values())
    n = int(np.prod(sizes))
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev_array = np.array(devices[:n]).reshape(sizes)
    return Mesh(dev_array, names)


def _pad_rows(arr, target_rows):
    pad = target_rows - arr.shape[0]
    if pad:
        arr = np.pad(arr, ((0, pad),) + ((0, 0),) * (arr.ndim - 1))
    return arr


class ShardedEllOperator(LinearOperator):
    """Row-sharded padded-ELL operator over a 1-D 'rows' mesh axis.

    The forward tables are sharded by operator row; the transpose tables are
    sharded by operator column (so A^T u's output is itself row-sharded in
    x-space and the gather of the sharded u is what moves between devices — for
    tomography m << n, the cheaper direction).
    """

    def __init__(self, vals, cols, vals_t, cols_t, shape, nnz, mesh, axis):
        self.vals, self.cols = vals, cols
        self.vals_t, self.cols_t = vals_t, cols_t
        self.shape = shape
        self.nnz = nnz
        self.mesh = mesh
        self.axis = axis

    @classmethod
    def from_ell(cls, op: EllOperator, mesh: Mesh, axis: str = "rows"):
        s = mesh.shape[axis]
        m, n = op.shape
        vals = _pad_rows(np.asarray(op.vals), round_up(m, s))
        cols = _pad_rows(np.asarray(op.cols), round_up(m, s))
        vals_t = _pad_rows(np.asarray(op.vals_t), round_up(n, s))
        cols_t = _pad_rows(np.asarray(op.cols_t), round_up(n, s))
        row_sh = NamedSharding(mesh, P(axis, None))
        put = lambda a: jax.device_put(jnp.asarray(a), row_sh)
        return cls(put(vals), put(cols), put(vals_t), put(cols_t),
                   (vals.shape[0], vals_t.shape[0]), op.nnz, mesh, axis)

    def matvec(self, x):
        y = _ell_matvec(self.vals, self.cols, x)
        return jax.lax.with_sharding_constraint(
            y, NamedSharding(self.mesh, P(self.axis))
        )

    def rmatvec(self, y):
        x = _ell_matvec(self.vals_t, self.cols_t, y)
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, P(self.axis))
        )


register_op(
    ShardedEllOperator,
    ["vals", "cols", "vals_t", "cols_t"],
    ["shape", "nnz", "mesh", "axis"],
)


class ShardedDynamicOperator(LinearOperator):
    """Block-diagonal dynamic forward map over a ('time', 'rows') mesh.

    Per-frame ELL tables are stacked on a leading frame axis sharded over
    'time'; each frame's rows are sharded over 'rows'. x is frame-major
    (nt * n,), viewed as (nt, n): 'time'-sharded, replicated within 'rows'
    groups.
    """

    def __init__(self, vals, cols, vals_t, cols_t, shape, frame_shape, nnz,
                 mesh):
        self.vals, self.cols = vals, cols
        self.vals_t, self.cols_t = vals_t, cols_t
        self.shape = shape
        self.frame_shape = frame_shape  # (m_f, n_f) padded
        self.nnz = nnz
        self.mesh = mesh

    @classmethod
    def from_blocks(cls, blocks, mesh: Mesh):
        """blocks: list of scipy sparse per-frame matrices (same shape)."""
        t_sh = mesh.shape["time"]
        r_sh = mesh.shape["rows"]
        ells = [EllOperator.from_scipy(b) for b in blocks]
        nt = len(ells)
        if nt % t_sh:
            raise ValueError(f"nt={nt} must divide over time axis {t_sh}")
        m_f = round_up(max(e.vals.shape[0] for e in ells), r_sh)
        n_f = round_up(max(e.vals_t.shape[0] for e in ells), r_sh)
        w = max(e.vals.shape[1] for e in ells)
        w_t = max(e.vals_t.shape[1] for e in ells)

        def stack(attr, rows, width):
            out = np.zeros((nt, rows, width),
                           dtype=np.asarray(getattr(ells[0], attr)).dtype)
            for i, e in enumerate(ells):
                a = np.asarray(getattr(e, attr))
                out[i, : a.shape[0], : a.shape[1]] = a
            return out

        sh3 = NamedSharding(mesh, P("time", "rows", None))
        put = lambda a: jax.device_put(jnp.asarray(a), sh3)
        vals = put(stack("vals", m_f, w))
        cols = put(stack("cols", m_f, w))
        vals_t = put(stack("vals_t", n_f, w_t))
        cols_t = put(stack("cols_t", n_f, w_t))
        m0, n0 = blocks[0].shape
        return cls(vals, cols, vals_t, cols_t,
                   (nt * m0, nt * n0), (m_f, n_f), sum(e.nnz for e in ells),
                   mesh)

    @property
    def nt(self):
        return self.vals.shape[0]

    def matvec(self, x):
        nt = self.nt
        n_f_true = self.shape[1] // nt
        m_f_true = self.shape[0] // nt
        X = x.reshape(nt, n_f_true)
        X = jax.lax.with_sharding_constraint(
            X, NamedSharding(self.mesh, P("time", None))
        )
        Y = jax.vmap(_ell_matvec)(self.vals, self.cols, X)
        Y = jax.lax.with_sharding_constraint(
            Y, NamedSharding(self.mesh, P("time", "rows"))
        )
        return Y[:, :m_f_true].reshape(-1)

    def rmatvec(self, y):
        nt = self.nt
        n_f_true = self.shape[1] // nt
        m_f_true = self.shape[0] // nt
        Y = y.reshape(nt, m_f_true)
        X = jax.vmap(_ell_matvec)(self.vals_t, self.cols_t, Y)
        X = jax.lax.with_sharding_constraint(
            X, NamedSharding(self.mesh, P("time", "rows"))
        )
        return X[:, :n_f_true].reshape(-1)


register_op(
    ShardedDynamicOperator,
    ["vals", "cols", "vals_t", "cols_t"],
    ["shape", "frame_shape", "nnz", "mesh"],
)

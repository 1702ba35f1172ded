"""Jittable linear-operator protocol.

The reference (TRIPs-Py) builds on pylops ``LinearOperator`` /
``FunctionOperator`` (e.g. ``trips/test_problems/Deblurring2D.py:66-73``,
``trips/utilities/io.py:420``) with NumPy semantics. Here operators are
JAX pytrees: their array leaves (dense blocks, ELL tables, PSFs, ...) flow
through ``jit``/``shard_map`` unmodified, while shapes are static metadata.

Conventions
-----------
- ``matvec`` maps ``(n,) -> (m,)``; ``matmat`` maps ``(n, k) -> (m, k)``.
- ``op @ x`` dispatches on ``x.ndim``; ``op.T`` is the adjoint (these are
  real operators, so adjoint == transpose).
- Every concrete operator must be registered as a pytree so whole solver
  steps can be jitted with the operator as an argument.
"""
from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np


class LinearOperator:
    """Abstract base. Subclasses implement matvec/rmatvec (jit-traceable)."""

    shape: tuple  # (m, n), static

    # -- required --------------------------------------------------------
    def matvec(self, x):
        raise NotImplementedError

    def rmatvec(self, y):
        raise NotImplementedError

    # -- defaults --------------------------------------------------------
    def matmat(self, X):
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    def rmatmat(self, Y):
        return jax.vmap(self.rmatvec, in_axes=1, out_axes=1)(Y)

    # -- sugar -----------------------------------------------------------
    def __matmul__(self, x):
        if isinstance(x, LinearOperator):
            return CompositeOperator(self, x)
        x = jnp.asarray(x)
        if x.ndim == 1:
            return self.matvec(x)
        if x.ndim == 2 and x.shape[1] == 1:
            return self.matvec(x[:, 0])[:, None]
        return self.matmat(x)

    def __mul__(self, x):
        if isinstance(x, (int, float)):
            return ScaledOperator(float(x), self)
        return self.__matmul__(x)

    def __rmul__(self, alpha):
        if isinstance(alpha, (int, float)):
            return ScaledOperator(float(alpha), self)
        return NotImplemented

    @property
    def T(self):
        return AdjointOperator(self)

    @property
    def dtype(self):
        leaves = jax.tree_util.tree_leaves(self)
        return leaves[0].dtype if leaves else jnp.float32

    def todense(self):
        """Materialize as a dense jnp matrix (small operators only)."""
        n = self.shape[1]
        return self.matmat(jnp.eye(n, dtype=self.dtype))

    def to_scipy(self):
        """Dense numpy matrix for oracle tests."""
        return np.asarray(self.todense())


def register_op(cls, data_fields: Sequence[str], static_fields: Sequence[str]):
    """Register an operator dataclass-like as a JAX pytree."""

    def flatten(op):
        children = tuple(getattr(op, f) for f in data_fields)
        aux = tuple(getattr(op, f) for f in static_fields)
        return children, aux

    def unflatten(aux, children):
        op = object.__new__(cls)
        for f, v in zip(data_fields, children):
            object.__setattr__(op, f, v)
        for f, v in zip(static_fields, aux):
            object.__setattr__(op, f, v)
        return op

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


class DenseOperator(LinearOperator):
    """Dense matrix operator; projected small systems, PSF Toeplitz matrices."""

    def __init__(self, mat):
        self.mat = jnp.asarray(mat)
        self.shape = tuple(self.mat.shape)

    def matvec(self, x):
        return self.mat @ x

    def rmatvec(self, y):
        return self.mat.T @ y

    def matmat(self, X):
        return self.mat @ X

    def rmatmat(self, Y):
        return self.mat.T @ Y

    def todense(self):
        return self.mat


register_op(DenseOperator, ["mat"], ["shape"])


class IdentityOperator(LinearOperator):
    def __init__(self, n, dtype=None):
        self.shape = (n, n)
        self._dtype = dtype

    def matvec(self, x):
        return x

    rmatvec = matvec

    def matmat(self, X):
        return X

    rmatmat = matmat

    def todense(self):
        return jnp.eye(self.shape[0], dtype=self._dtype or jnp.float32)


register_op(IdentityOperator, [], ["shape", "_dtype"])


class AdjointOperator(LinearOperator):
    def __init__(self, op):
        self.op = op
        self.shape = (op.shape[1], op.shape[0])

    def matvec(self, x):
        return self.op.rmatvec(x)

    def rmatvec(self, y):
        return self.op.matvec(y)

    def matmat(self, X):
        return self.op.rmatmat(X)

    def rmatmat(self, Y):
        return self.op.matmat(Y)

    @property
    def T(self):
        return self.op


register_op(AdjointOperator, ["op"], ["shape"])


class ScaledOperator(LinearOperator):
    def __init__(self, alpha, op):
        self.alpha = alpha
        self.op = op
        self.shape = op.shape

    def matvec(self, x):
        return self.alpha * self.op.matvec(x)

    def rmatvec(self, y):
        return self.alpha * self.op.rmatvec(y)

    def matmat(self, X):
        return self.alpha * self.op.matmat(X)

    def rmatmat(self, Y):
        return self.alpha * self.op.rmatmat(Y)


register_op(ScaledOperator, ["alpha", "op"], ["shape"])


class CompositeOperator(LinearOperator):
    """A @ B."""

    def __init__(self, A, B):
        if A.shape[1] != B.shape[0]:
            raise ValueError(f"shape mismatch {A.shape} @ {B.shape}")
        self.A, self.B = A, B
        self.shape = (A.shape[0], B.shape[1])

    def matvec(self, x):
        return self.A.matvec(self.B.matvec(x))

    def rmatvec(self, y):
        return self.B.rmatvec(self.A.rmatvec(y))

    def matmat(self, X):
        return self.A.matmat(self.B.matmat(X))

    def rmatmat(self, Y):
        return self.B.rmatmat(self.A.rmatmat(Y))


register_op(CompositeOperator, ["A", "B"], ["shape"])


class VStackOperator(LinearOperator):
    """Vertical stack [op1; op2; ...] — regularization stacks.

    Reference analog: ``pylops``/``scipy.sparse.vstack`` use in
    ``trips/utilities/operators.py:30-45``.
    """

    def __init__(self, ops):
        ops = tuple(ops)
        n = ops[0].shape[1]
        for o in ops:
            if o.shape[1] != n:
                raise ValueError("inconsistent column counts in VStack")
        self.ops = ops
        self.shape = (sum(o.shape[0] for o in ops), n)

    def matvec(self, x):
        return jnp.concatenate([o.matvec(x) for o in self.ops])

    def rmatvec(self, y):
        out = None
        i = 0
        for o in self.ops:
            m = o.shape[0]
            part = o.rmatvec(y[i : i + m])
            out = part if out is None else out + part
            i += m
        return out

    def matmat(self, X):
        return jnp.concatenate([o.matmat(X) for o in self.ops], axis=0)

    def rmatmat(self, Y):
        out = None
        i = 0
        for o in self.ops:
            m = o.shape[0]
            part = o.rmatmat(Y[i : i + m])
            out = part if out is None else out + part
            i += m
        return out


register_op(VStackOperator, ["ops"], ["shape"])


class BlockDiagOperator(LinearOperator):
    """Block-diagonal operator diag(op_1, ..., op_T).

    The dynamic-CT forward maps are per-frame blocks laid out block-diagonally
    (reference: ``trips/utilities/io.py:156-158``, ``pylops.BlockDiag`` at
    ``io.py:420``). When all blocks share one structure (same projector each
    frame), prefer a batched operator instead — this generic version simply
    loops (unrolled under jit).
    """

    def __init__(self, ops):
        self.ops = tuple(ops)
        self.shape = (
            sum(o.shape[0] for o in self.ops),
            sum(o.shape[1] for o in self.ops),
        )

    def matvec(self, x):
        outs, j = [], 0
        for o in self.ops:
            outs.append(o.matvec(x[j : j + o.shape[1]]))
            j += o.shape[1]
        return jnp.concatenate(outs)

    def rmatvec(self, y):
        outs, i = [], 0
        for o in self.ops:
            outs.append(o.rmatvec(y[i : i + o.shape[0]]))
            i += o.shape[0]
        return jnp.concatenate(outs)

    def matmat(self, X):
        outs, j = [], 0
        for o in self.ops:
            outs.append(o.matmat(X[j : j + o.shape[1]]))
            j += o.shape[1]
        return jnp.concatenate(outs, axis=0)

    def rmatmat(self, Y):
        outs, i = [], 0
        for o in self.ops:
            outs.append(o.rmatmat(Y[i : i + o.shape[0]]))
            i += o.shape[0]
        return jnp.concatenate(outs, axis=0)


register_op(BlockDiagOperator, ["ops"], ["shape"])


class BatchedBlockDiagOperator(LinearOperator):
    """diag(B, B, ..., B) with T repeats of one shared operator B.

    Device replacement for per-frame Python loops: the T frames become a
    batch axis handled by one vmapped (or sharded) apply. Used for dynamic CT
    where every frame shares the projector (reference STEMPO 'real' mode,
    ``trips/utilities/io.py:423-464``).
    """

    def __init__(self, op, nt):
        self.op = op
        self.nt = nt
        self.shape = (op.shape[0] * nt, op.shape[1] * nt)

    def matvec(self, x):
        X = x.reshape(self.nt, self.op.shape[1])
        Y = jax.vmap(self.op.matvec)(X)
        return Y.reshape(-1)

    def rmatvec(self, y):
        Y = y.reshape(self.nt, self.op.shape[0])
        X = jax.vmap(self.op.rmatvec)(Y)
        return X.reshape(-1)

    def normal_matvec(self, x):
        """Per-frame A^T A, vmapped — picks up the base operator's fused
        normal apply (e.g. the banded single-stream kernel) when it has
        one, so ``cgls_normal`` works frame-batched."""
        X = x.reshape(self.nt, self.op.shape[1])
        fn = getattr(self.op, "normal_matvec",
                     lambda v: self.op.rmatvec(self.op.matvec(v)))
        return jax.vmap(fn)(X).reshape(-1)

    def matmat(self, M):
        k = M.shape[1]
        X = M.reshape(self.nt, self.op.shape[1], k)
        Y = jax.vmap(self.op.matmat)(X)
        return Y.reshape(self.nt * self.op.shape[0], k)

    def rmatmat(self, M):
        k = M.shape[1]
        Y = M.reshape(self.nt, self.op.shape[0], k)
        X = jax.vmap(self.op.rmatmat)(Y)
        return X.reshape(self.nt * self.op.shape[1], k)


register_op(BatchedBlockDiagOperator, ["op"], ["nt", "shape"])


class FunctionOperator(LinearOperator):
    """User-supplied forward/adjoint callables (API parity with
    ``pylops.FunctionOperator`` used throughout the reference test problems).

    Not a pytree of arrays — closures are static. Fine under jit as a
    captured constant.
    """

    def __init__(self, f: Callable, fadj: Callable, m: int, n: int | None = None):
        self.f = f
        self.fadj = fadj
        self.shape = (m, n if n is not None else m)

    def matvec(self, x):
        return jnp.reshape(self.f(x), (self.shape[0],))

    def rmatvec(self, y):
        return jnp.reshape(self.fadj(y), (self.shape[1],))


register_op(FunctionOperator, [], ["f", "fadj", "shape"])


def aslinearoperator(A) -> LinearOperator:
    if isinstance(A, LinearOperator):
        return A
    if hasattr(A, "toarray"):  # scipy sparse
        from ..sparse.ell import EllOperator

        return EllOperator.from_scipy(A)
    return DenseOperator(jnp.asarray(A))

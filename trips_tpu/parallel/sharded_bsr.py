"""Row-sharded BSR operators: the block-sparse format across devices.

These operators shard the BSR block stream (small dense blocks +
einsum/segment-sum apply, ``sparse/bsr.py``) with ``jax.shard_map`` and
explicit collectives:

- **Forward** (row partition): each chip owns the blocks whose block-row
  falls in its contiguous row range; x is replicated into the shard_map
  (the surrounding jit inserts the all-gather when x arrives sharded) and
  the chip emits its y-slice locally — zero cross-chip communication in
  the apply itself.
- **Adjoint** (transpose partition): a second grouping of the *same*
  blocks by block-column range. y is row-sharded; one
  ``lax.all_gather`` (tiled) rebuilds the full y per chip (for tomography
  m << n, gathering y is the cheap direction — BASELINE's "transpose
  partition kept for A^T-apply"), then each chip contracts its
  column-partition and emits its x-slice. No psum of n-sized partials.

Krylov dot products over the sharded x/y psum automatically under jit.

Per-chip padding: every chip's block list is padded to the fleet maximum
with zero blocks (zero contribution); row/col spaces are padded so each
chip owns an equal slice. ``shape`` is the padded problem (same convention
as ShardedEllOperator); zero rows/cols are inert in CGLS/GKS.

Replaces the distribution story of the reference's single-process
scipy CSR matrices (``trips/utilities/io.py:132-134`` loads the Emoji
matrix into one NumPy process; SURVEY.md §2.10 — distribution is a new
subsystem, not a port).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import round_up
from ..core.linop import LinearOperator, register_op
from ..sparse.bsr import _block_precision, _build_bsr


def _count_blocks(A, br, bc):
    """Nonzero-block count without materializing the blocks (cheap)."""
    coo = A.tocoo()
    nbk = -(-A.shape[1] // bc)
    bid = (coo.row // br).astype(np.int64) * nbk + coo.col // bc
    return len(np.unique(bid))


def _check_stored_budget(n_blocks, br, bc, itemsize, nnz, max_stored_gb,
                         what):
    """Stored-density guard (r2 STEMPO finding: (8,128) blocks at 560-wide
    parallel geometry pack at ~2% density -> 1.1 GB/frame, and the two
    sharded partitions OOM-killed a 125 GB host at 36 frames). Fail fast
    with format guidance instead."""
    stored = 2 * n_blocks * br * bc * itemsize  # forward + transpose
    if stored > max_stored_gb * 1e9:
        dens = nnz / max(n_blocks * br * bc, 1)
        raise ValueError(
            f"{what}: BSR ({br},{bc}) would store {stored/1e9:.1f} GB "
            f"across both partitions at {100*dens:.2f}% density "
            f"(limit {max_stored_gb} GB). This matrix is too diffuse for "
            f"block storage — use the banded pack "
            f"(sparse.BandedProjector) or ELL "
            f"(parallel.ShardedDynamicOperator), or raise max_stored_gb.")


def _contract(blocks, gathered, spec, acc):
    return jnp.einsum(spec, blocks, gathered.astype(blocks.dtype),
                      preferred_element_type=acc,
                      precision=_block_precision(blocks.dtype))


def _partition_blocks(blocks, key_idx, other_idx, n_chunks, chunk_blocks):
    """Group blocks by ``key_idx // chunk_blocks`` into n_chunks lists,
    localize the key index, pad every chunk to the fleet max with zero
    blocks. Returns (blocks_s, key_local_s, other_global_s): arrays with a
    leading chunk axis."""
    dev = np.minimum(key_idx // chunk_blocks, n_chunks - 1)
    order = np.argsort(dev, kind="stable")
    blocks, key_idx, other_idx, dev = (
        blocks[order], key_idx[order], other_idx[order], dev[order])
    counts = np.bincount(dev, minlength=n_chunks)
    nb_max = max(int(counts.max()), 1)
    br, bc = blocks.shape[1:]
    out_b = np.zeros((n_chunks, nb_max, br, bc), blocks.dtype)
    out_k = np.zeros((n_chunks, nb_max), np.int32)
    out_o = np.zeros((n_chunks, nb_max), np.int32)
    start = np.concatenate([[0], np.cumsum(counts)])
    for d in range(n_chunks):
        s, e = start[d], start[d + 1]
        out_b[d, : e - s] = blocks[s:e]
        out_k[d, : e - s] = key_idx[s:e] - d * chunk_blocks
        out_o[d, : e - s] = other_idx[s:e]
    return out_b, out_k, out_o


class ShardedBsrOperator(LinearOperator):
    """BSR operator row-sharded over a 1-D mesh axis (default 'rows')."""

    def __init__(self, blocks_f, brow_l, bcol_g, blocks_t, brow_g, bcol_l,
                 shape, block_shape, nnz, mesh, axis):
        self.blocks_f = blocks_f
        self.brow_l = brow_l
        self.bcol_g = bcol_g
        self.blocks_t = blocks_t
        self.brow_g = brow_g
        self.bcol_l = bcol_l
        self.shape = tuple(shape)
        self.block_shape = tuple(block_shape)
        self.nnz = nnz
        self.mesh = mesh
        self.axis = axis

    @classmethod
    def from_scipy(cls, A, mesh, axis="rows", block_shape=(32, 128),
                   block_dtype=None, max_stored_gb=16.0):
        from scipy import sparse as sp

        A = sp.csr_matrix(A).astype(np.float32)
        br, bc = block_shape
        itemsize = jnp.dtype(block_dtype or jnp.float32).itemsize
        _check_stored_budget(_count_blocks(A, br, bc), br, bc, itemsize,
                             A.nnz, max_stored_gb, "ShardedBsrOperator")
        S = mesh.shape[axis]
        m_pad = round_up(A.shape[0], S * br)
        n_pad = round_up(A.shape[1], S * bc)
        blocks, brow, bcol, _, _, _ = _build_bsr(A, br, bc)
        if block_dtype is not None:
            blocks = blocks.astype(block_dtype)
        bf, kl, og = _partition_blocks(
            blocks, brow, bcol, S, m_pad // (S * br))
        bt, klt, ogt = _partition_blocks(
            blocks, bcol, brow, S, n_pad // (S * bc))
        sh = lambda *rest: NamedSharding(mesh, P(axis, *rest))
        put = lambda a, *rest: jax.device_put(jnp.asarray(a), sh(*rest))
        return cls(put(bf, None, None, None), put(kl, None), put(og, None),
                   put(bt, None, None, None), put(ogt, None), put(klt, None),
                   (m_pad, n_pad), (br, bc), A.nnz, mesh, axis)

    @property
    def stored_bytes(self):
        return (self.blocks_f.size * self.blocks_f.dtype.itemsize
                + self.blocks_t.size * self.blocks_t.dtype.itemsize)

    def matvec(self, x):
        br, bc = self.block_shape
        m_pad, n_pad = self.shape
        S = self.mesh.shape[self.axis]
        mb_loc = m_pad // (S * br)
        acc = jnp.promote_types(x.dtype, jnp.float32)

        def fwd(blocks, brow_l, bcol_g, xv):
            blocks, brow_l, bcol_g = blocks[0], brow_l[0], bcol_g[0]
            xb = xv.reshape(-1, bc)
            prod = _contract(blocks, xb[bcol_g], "nij,nj->ni", acc)
            y = jax.ops.segment_sum(prod, brow_l, num_segments=mb_loc)
            return y.reshape(-1).astype(x.dtype)

        f = jax.shard_map(
            fwd, mesh=self.mesh,
            in_specs=(P(self.axis), P(self.axis), P(self.axis), P()),
            out_specs=P(self.axis))
        return f(self.blocks_f, self.brow_l, self.bcol_g,
                 jnp.reshape(x, (-1,)))

    def rmatvec(self, y):
        br, bc = self.block_shape
        m_pad, n_pad = self.shape
        S = self.mesh.shape[self.axis]
        nb_loc = n_pad // (S * bc)
        acc = jnp.promote_types(y.dtype, jnp.float32)
        axis = self.axis

        def adj(blocks, brow_g, bcol_l, y_loc):
            blocks, brow_g, bcol_l = blocks[0], brow_g[0], bcol_l[0]
            yv = jax.lax.all_gather(y_loc, axis, tiled=True)
            yb = yv.reshape(-1, br)
            prod = _contract(blocks, yb[brow_g], "nij,ni->nj", acc)
            xout = jax.ops.segment_sum(prod, bcol_l, num_segments=nb_loc)
            return xout.reshape(-1).astype(y.dtype)

        f = jax.shard_map(
            adj, mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=P(axis))
        return f(self.blocks_t, self.brow_g, self.bcol_l,
                 jnp.reshape(y, (-1,)))

    def matmat(self, X):
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    def rmatmat(self, Y):
        return jax.vmap(self.rmatvec, in_axes=1, out_axes=1)(Y)


register_op(
    ShardedBsrOperator,
    ["blocks_f", "brow_l", "bcol_g", "blocks_t", "brow_g", "bcol_l"],
    ["shape", "block_shape", "nnz", "mesh", "axis"],
)


class ShardedDynamicBsrOperator(LinearOperator):
    """Block-diagonal dynamic forward map over a ('time', 'rows') mesh,
    stored as per-frame BSR partitions (replaces the ELL-based
    ShardedDynamicOperator as the recommended dynamic-CT operator).

    Frames ride the 'time' axis (the embarrassingly-parallel axis the
    reference loops serially, ``io.py:156-158``); within each frame the
    block stream is row/column partitioned over 'rows' exactly as
    ShardedBsrOperator. x is frame-major (nt * n_f,).
    """

    def __init__(self, blocks_f, brow_l, bcol_g, blocks_t, brow_g, bcol_l,
                 shape, frame_shape, block_shape, nnz, mesh):
        self.blocks_f = blocks_f
        self.brow_l = brow_l
        self.bcol_g = bcol_g
        self.blocks_t = blocks_t
        self.brow_g = brow_g
        self.bcol_l = bcol_l
        self.shape = tuple(shape)          # true (nt*m0, nt*n0)
        self.frame_shape = tuple(frame_shape)  # padded (m_pad, n_pad)
        self.block_shape = tuple(block_shape)
        self.nnz = nnz
        self.mesh = mesh

    @classmethod
    def from_blocks(cls, frames, mesh, block_shape=(8, 128),
                    block_dtype=None, max_stored_gb=16.0):
        """frames: list of same-shape scipy per-frame matrices."""
        from scipy import sparse as sp

        br, bc = block_shape
        itemsize = jnp.dtype(block_dtype or jnp.float32).itemsize
        nb_total = sum(_count_blocks(sp.csr_matrix(F), br, bc)
                       for F in frames)
        _check_stored_budget(nb_total, br, bc, itemsize,
                             sum(int(sp.csr_matrix(F).nnz) for F in frames),
                             max_stored_gb, "ShardedDynamicBsrOperator")
        t_sh, r_sh = mesh.shape["time"], mesh.shape["rows"]
        nt = len(frames)
        if nt % t_sh:
            raise ValueError(f"nt={nt} must divide over time axis {t_sh}")
        m0, n0 = frames[0].shape
        m_pad = round_up(m0, r_sh * br)
        n_pad = round_up(n0, r_sh * bc)

        per = []
        for F in frames:
            F = sp.csr_matrix(F).astype(np.float32)
            blocks, brow, bcol, _, _, _ = _build_bsr(F, br, bc)
            if block_dtype is not None:
                blocks = blocks.astype(block_dtype)
            bf, kl, og = _partition_blocks(
                blocks, brow, bcol, r_sh, m_pad // (r_sh * br))
            bt, klt, ogt = _partition_blocks(
                blocks, bcol, brow, r_sh, n_pad // (r_sh * bc))
            per.append((bf, kl, og, bt, ogt, klt))

        def stack(i):
            nb = max(p[i].shape[1] for p in per)
            a0 = per[0][i]
            out = np.zeros((nt, r_sh, nb) + a0.shape[2:], a0.dtype)
            for f, p in enumerate(per):
                out[f, :, : p[i].shape[1]] = p[i]
            return out

        rest = lambda a: (None,) * (a.ndim - 2)
        put = lambda a: jax.device_put(
            jnp.asarray(a), NamedSharding(mesh, P("time", "rows", *rest(a))))
        arrs = [put(stack(i)) for i in range(6)]
        return cls(*arrs, (nt * m0, nt * n0), (m_pad, n_pad), (br, bc),
                   sum(int(sp.csr_matrix(F).nnz) for F in frames), mesh)

    @property
    def nt(self):
        return self.blocks_f.shape[0]

    def matvec(self, x):
        br, bc = self.block_shape
        m_pad, n_pad = self.frame_shape
        nt = self.nt
        m0, n0 = self.shape[0] // nt, self.shape[1] // nt
        r_sh = self.mesh.shape["rows"]
        mb_loc = m_pad // (r_sh * br)
        acc = jnp.promote_types(x.dtype, jnp.float32)
        X = jnp.pad(x.reshape(nt, n0), ((0, 0), (0, n_pad - n0)))

        def fwd(blocks, brow_l, bcol_g, Xv):
            # local: (nt_loc, 1, nb, br, bc) / Xv (nt_loc, n_pad)
            def one(bl, kl, og, xv):
                xb = xv.reshape(-1, bc)
                prod = _contract(bl, xb[og], "nij,nj->ni", acc)
                return jax.ops.segment_sum(
                    prod, kl, num_segments=mb_loc).reshape(-1)

            return jax.vmap(one)(
                blocks[:, 0], brow_l[:, 0], bcol_g[:, 0], Xv).astype(x.dtype)

        f = jax.shard_map(
            fwd, mesh=self.mesh,
            in_specs=(P("time", "rows"), P("time", "rows"),
                      P("time", "rows"), P("time")),
            out_specs=P("time", "rows"))
        Y = f(self.blocks_f, self.brow_l, self.bcol_g, X)
        return Y[:, :m0].reshape(-1)

    def rmatvec(self, y):
        br, bc = self.block_shape
        m_pad, n_pad = self.frame_shape
        nt = self.nt
        m0, n0 = self.shape[0] // nt, self.shape[1] // nt
        r_sh = self.mesh.shape["rows"]
        nb_loc = n_pad // (r_sh * bc)
        acc = jnp.promote_types(y.dtype, jnp.float32)
        Y = jnp.pad(y.reshape(nt, m0), ((0, 0), (0, m_pad - m0)))

        def adj(blocks, brow_g, bcol_l, Yv):
            # Yv arrives P('time')-sharded only: each 'rows' member holds
            # the full per-frame y (the all-gather is the resharding jit
            # inserts when y is produced 'rows'-sharded by the forward)
            def one(bl, og, kl, yv):
                yb = yv.reshape(-1, br)
                prod = _contract(bl, yb[og], "nij,ni->nj", acc)
                return jax.ops.segment_sum(
                    prod, kl, num_segments=nb_loc).reshape(-1)

            return jax.vmap(one)(
                blocks[:, 0], brow_g[:, 0], bcol_l[:, 0], Yv).astype(y.dtype)

        f = jax.shard_map(
            adj, mesh=self.mesh,
            in_specs=(P("time", "rows"), P("time", "rows"),
                      P("time", "rows"), P("time")),
            out_specs=P("time", "rows"))
        X = f(self.blocks_t, self.brow_g, self.bcol_l, Y)
        return X[:, :n0].reshape(-1)


register_op(
    ShardedDynamicBsrOperator,
    ["blocks_f", "brow_l", "bcol_g", "blocks_t", "brow_g", "bcol_l"],
    ["shape", "frame_shape", "block_shape", "nnz", "mesh"],
)

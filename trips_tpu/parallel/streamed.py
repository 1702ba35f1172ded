"""Out-of-core dynamic CT: host-resident per-frame packs streamed to the
device with a two-slot pipeline.

Full-resolution STEMPO real (2240 detectors, thinning=1,
``trips/utilities/io.py:423-464``) packs to ~GBs per frame set — beyond
HBM residency once frames multiply. This operator keeps every frame's
banded pack in HOST memory (NumPy) and streams one frame slab at a time
to the device, prefetching frame t+1 while frame t computes:

- ``jax.device_put`` is asynchronous: the transfer of the next frame's
  slab is issued BEFORE the current frame's (jitted) apply is dispatched,
  so H2D rides under compute wherever the interconnect allows;
- at most two frame slabs are device-resident (the computing one and the
  prefetched one) — device memory is O(largest frame), not O(nt);
- applies are per-frame jitted programs (the same XLA applies as
  the resident operators); the frame loop is host-level Python, which is
  the out-of-core execution mode — per-frame work at full resolution is
  hundreds of ms, so the ~ms dispatch overhead is noise.

The resident equivalents (``sparse.dynamic_banded``,
``parallel.sharded_dynamic_banded``) remain the fast path whenever the
pack fits HBM.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.linop import LinearOperator


class StreamedDynamicBandedOperator(LinearOperator):
    """Block-diag-over-time operator whose per-frame operators live on the
    host and are streamed to the device per apply.

    ``frame_ops``: list of per-frame operators (``BandedProjector`` /
    ``BucketedBandedProjector`` / any registered operator pytree) whose
    array leaves are host NumPy arrays (build them under
    ``jax.default_device(cpu)`` or from NumPy inputs).
    """

    def __init__(self, frame_ops, device=None):
        self.frame_ops = list(frame_ops)
        if not self.frame_ops:
            raise ValueError("frame_ops must contain at least one frame "
                             "operator")
        self.nt = len(self.frame_ops)
        m = sum(op.shape[0] for op in self.frame_ops)
        n = sum(op.shape[1] for op in self.frame_ops)
        self.shape = (m, n)
        self.nnz = sum(getattr(op, "nnz", 0) for op in self.frame_ops)
        self.device = device or jax.devices()[0]
        self._row_off = np.cumsum(
            [0] + [op.shape[0] for op in self.frame_ops])
        self._col_off = np.cumsum(
            [0] + [op.shape[1] for op in self.frame_ops])

    @property
    def stored_bytes(self):
        return sum(getattr(op, "stored_bytes", 0) for op in self.frame_ops)

    def _put(self, t):
        """Issue the (async) H2D transfer of frame t's pack."""
        return jax.tree_util.tree_map(
            lambda a: jax.device_put(a, self.device),
            self.frame_ops[t])

    def _pipeline(self, apply_frame, slices, x):
        """Two-slot prefetch loop: transfer t+1 while t computes.

        The block on frame t's OUTPUT before advancing is the
        backpressure that makes the two-slot bound real: device_put and
        jitted applies are both async, so without it the host loop would
        enqueue every frame's H2D transfer ahead of the (slow) compute
        and device residency would grow to O(nt) slabs."""
        outs = []
        nxt = self._put(0)
        for t in range(self.nt):
            cur, nxt = nxt, (self._put(t + 1) if t + 1 < self.nt else None)
            out = apply_frame(cur, x[slices[t]])
            jax.block_until_ready(out)
            outs.append(out)
        return jnp.concatenate([jnp.asarray(o) for o in outs])

    def matvec(self, x):
        x = jnp.reshape(x, (-1,))
        sl = [slice(self._col_off[t], self._col_off[t + 1])
              for t in range(self.nt)]
        return self._pipeline(lambda op, xt: op.matvec(xt), sl, x)

    def rmatvec(self, y):
        y = jnp.reshape(y, (-1,))
        sl = [slice(self._row_off[t], self._row_off[t + 1])
              for t in range(self.nt)]
        return self._pipeline(lambda op, yt: op.rmatvec(yt), sl, y)

    def normal_matvec(self, x):
        x = jnp.reshape(x, (-1,))
        sl = [slice(self._col_off[t], self._col_off[t + 1])
              for t in range(self.nt)]
        return self._pipeline(
            lambda op, xt: (op.normal_matvec(xt)
                            if hasattr(op, "normal_matvec")
                            else op.rmatvec(op.matvec(xt))), sl, x)


def cgls_normal_streamed(op, b, x0, n_iter, tol=0.0):
    """CGLS on the normal equations with a streamed operator: the scalar
    recurrences run on device; the frame loop inside each
    ``normal_matvec`` streams slabs host->device (out-of-core mode of
    ``krylov.cgls_normal`` — same update and same ``(x, k)`` return,
    host-level iteration loop)."""
    b = jnp.reshape(b, (-1,))
    x = jnp.reshape(x0, (-1,))
    t = op.rmatvec(b) - op.normal_matvec(x)
    norms_t0 = jnp.linalg.norm(t)
    p = t
    gamma = norms_t0**2
    k_done = 0
    # scalar updates mirror krylov.cgls._cgn_step op-for-op (incl. the
    # nonpositive-delta convergence guard and norm(t)**2 gamma), so the
    # streamed trajectory tracks the resident fused loop to roundoff
    for _ in range(int(n_iter)):
        q = op.normal_matvec(p)
        delta = jnp.vdot(p, q)
        if float(delta) <= 0:
            break
        beta = gamma / delta
        x = x + beta * p
        t = t - beta * q
        norm_t = jnp.linalg.norm(t)
        gamma_new = norm_t**2
        k_done += 1
        if float(norm_t) <= float(norms_t0) * tol:
            gamma = gamma_new
            break
        p = t + (gamma_new / gamma) * p
        gamma = gamma_new
    return x, k_done

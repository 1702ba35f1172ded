"""Collective audit of the compiled sharded programs.

Wall-clock scaling on a simulated CPU mesh carries no information about
interconnect behavior (the simulated devices share the host's cores).
What a CPU mesh can show is the **collective bytes and counts per apply
in the compiled HLO** of the real-scale sharded programs.

``collective_stats`` lowers + compiles a function on a mesh and parses
the optimized (post-SPMD-partitioner) HLO for collective ops (all-reduce /
all-gather / reduce-scatter / collective-permute / all-to-all), returning
per-op counts and payload bytes. The partitioner emits the same collective
schedule for any mesh of the same shape, so these counts do not depend on
the platform.

Distribution is a new subsystem (reference is single-process NumPy,
SURVEY.md §2.10).
"""
from __future__ import annotations

import re

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8, "u64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")

# `%all-reduce.3 = f32[640,640]{1,0} all-reduce(...)` — possibly a tuple
# result `(f32[8,16]{...}, f32[8,16]{...}) all-reduce(...)`
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_txt):
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_txt):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_hlo_collectives(hlo_text):
    """Count collective instructions and sum their result-payload bytes."""
    stats = {}
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.match(r"%?[\w.\-]+\s*=\s*(.+?)\s+([\w\-]+)\(", line)
        if not m:
            continue
        shape_txt, opname = m.groups()
        # normalize fusion/async wrappers like all-reduce-start
        base = opname.replace("-start", "").replace("-done", "")
        if base not in _COLLECTIVES or opname.endswith("-done"):
            continue
        ent = stats.setdefault(base, {"count": 0, "bytes": 0})
        ent["count"] += 1
        nbytes = _shape_bytes(shape_txt)
        if opname.endswith("-start"):
            # async starts carry tuple results that alias the operands
            # (pairs of identical shapes); counting the full tuple would
            # double the payload
            comps = [_shape_bytes(m.group(0))
                     for m in _SHAPE_RE.finditer(shape_txt)]
            half = len(comps) // 2
            if comps and len(comps) % 2 == 0 and \
                    comps[:half] == comps[half:]:
                nbytes //= 2
        ent["bytes"] += nbytes
    return stats


def collective_stats(fn, *args):
    """Lower+compile ``fn(*args)`` and return its collective schedule.

    ``args`` may be concrete (sharded) arrays or ShapeDtypeStructs with
    ``sharding`` set; operators registered as pytrees pass straight
    through. Returns {"collectives": {op: {count, bytes}}, "total_bytes",
    "total_count"}.
    """
    import jax

    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    stats = parse_hlo_collectives(compiled.as_text())
    return {
        "collectives": stats,
        "total_count": sum(e["count"] for e in stats.values()),
        "total_bytes": sum(e["bytes"] for e in stats.values()),
    }


def audit_operator(op, applies=("matvec", "rmatvec", "normal_matvec")):
    """Collective schedule of each apply of a sharded operator, plus the
    ratio of stored-matrix bytes to collective bytes per apply."""
    import jax.numpy as jnp

    out = {}
    stored = int(getattr(op, "stored_bytes", 0))
    for name in applies:
        fn = getattr(op, name, None)
        if fn is None:
            continue
        dim = op.shape[1] if name in ("matvec", "normal_matvec") else \
            op.shape[0]
        x = jnp.zeros((dim,), jnp.float32)
        st = collective_stats(lambda o, v, _n=name: getattr(o, _n)(v),
                              op, x)
        if stored:
            # one apply streams the full weight set once (fwd/adj) —
            # normal_matvec streams it once too (the fused-ATA economy)
            st["stored_stream_bytes"] = stored
            st["collective_to_stream_ratio"] = (
                st["total_bytes"] / stored if stored else None)
        out[name] = st
    return out

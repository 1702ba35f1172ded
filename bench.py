"""Benchmark: nnz/s for SpMV inside the fused CGLS loop, on one GPU.

Config: the reference's large-scale tomography demo
(demo_Tomo_large_scale.ipynb — 256x256 image, 60 fan-beam views; SURVEY.md
§6). Each CGLS iteration performs one A·p and one A^T·r, so the metric is
iterations * 2 * nnz / wall_seconds, measured over a fused device-side CGLS
loop (one program per run, ended by ``block_until_ready``), median of 3
runs after a compile run.

Every operator path that lowers on the GPU runs. Each carries
``matrix_class`` ∈ {"exact", "recomputed", "quantized", "surrogate"}:

- ``exact``     — applies the stored Siddon fan-beam matrix in f32 (ELL,
                  BSR, banded f32). Its apply must match scipy in float64
                  to ``EXACT_RTOL`` or the run fails: a TF32 product gives
                  ~1e-3;
- ``recomputed``— the on-the-fly generator computes the same entries per
                  apply; f32 rounding of the ray geometry puts it ~1e-4
                  from the matrix (float64: ~1e-11);
- ``quantized`` — same matrix, values stored bf16/int8 (<1%-of-norm recon
                  deviation, pinned by tests);
- ``surrogate`` — the ShearFanProjector's own discretization of the same
                  fan geometry (recon-parity-tested, not matrix-equal); its
                  rate uses the Siddon matrix's nnz as "effective nnz/s".

Per path the report also holds the forward apply's relative error against
scipy in float64, and the device time of one forward and one adjoint apply
(one normal apply for ``_ata`` paths) from a ``jax.profiler`` trace of
``TRACE_REPS`` back-to-back applies of that apply alone. For stored
matrices it adds the bytes that apply reads and their rate's share of the
card's data-sheet bandwidth (``PEAK_BYTES_PER_S``, keyed by
``device_kind``; no share for a card not listed). A 1 GiB copy gives the
attainable bandwidth. The exact formats and the on-the-fly projector also
run at the ``dynamic560`` shape (8 frames of 560², 11 frame-varying fan
views each, as ``chip_smoke.py``'s dynamic phase); those rows go to the
report only.

The summary line reports ``value`` (best overall) and
``value_exact_matrix`` (best exact-class path). Stored-matrix paths record
``stored_mb`` and ``gbps`` (stored bytes streamed per second, assuming two
streams per iteration, one for ``_ata`` paths).

Baseline: scipy.sparse CSR CGLS on the host CPU — the reference's compute
substrate (``trips/solvers/CGLS.py:57-83`` recurrence).

    python bench.py

Prints exactly ONE JSON line to stdout; the per-path report goes to
``BENCH_report.json``, the traces under ``bench_traces/`` and progress to
stderr. Needs a GPU: on any other backend it exits non-zero.
``BENCH_ITERS`` sets the CGLS iterations at tomo256x60 (default 100).
"""
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ITERS = int(os.environ.get("BENCH_ITERS", "100"))
DYNAMIC_ITERS = 20
EXACT_RTOL = 1e-5
TRACE_REPS = 10
TRACE_DIR = "bench_traces"
# Data-sheet HBM bandwidth (NVIDIA H100 SXM5 data sheet).
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def scipy_cgls_rate(A, b, iters):
    x = np.zeros(A.shape[1], dtype=A.dtype)
    r = b - A @ x
    p = t = A.T @ r
    gamma = float(t @ t)
    t0 = time.perf_counter()
    for _ in range(iters):
        w = A @ p
        delta = float(w @ w) or np.finfo(float).eps
        beta = gamma / delta
        x = x + beta * p
        r = r - beta * w
        t = A.T @ r
        gamma_new = float(t @ t)
        p = t + (gamma_new / gamma) * p
        gamma = gamma_new
    return iters * 2 * A.nnz / (time.perf_counter() - t0)


def measure(solver, op, b, nnz, streams, iters):
    """Compile run, then the median of 3 timed runs -> info dict."""
    import jax
    import jax.numpy as jnp

    x0 = jnp.zeros(op.shape[1], b.dtype)
    t0 = time.perf_counter()
    _, k = jax.block_until_ready(solver(op, b, x0, iters, 0.0))
    info = {"compile_s": round(time.perf_counter() - t0, 2),
            "iters_done": int(k)}
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(solver(op, b, x0, iters, 0.0))
        rates.append(int(k) * 2 * nnz / (time.perf_counter() - t0))
    info["runs_gnnzps"] = [r / 1e9 for r in rates]
    info["gnnzps"] = float(np.median(rates)) / 1e9
    info["cgls_us_per_it"] = 2 * nnz / (info["gnnzps"] * 1e9) * 1e6
    stored = getattr(op, "stored_bytes", 0)
    if stored:
        info["stored_mb"] = stored / 1e6
        wall = int(k) * 2 * nnz / (info["gnnzps"] * 1e9)
        info["gbps"] = streams * int(k) * stored / wall / 1e9
    return info


def device_seconds(fn, args, trace_dir):
    """Device time of one call of ``fn``: the summed kernel durations on
    the GPU planes' stream lines ("Stream #N(Compute)") of a fresh trace of
    ``TRACE_REPS`` back-to-back calls, over ``TRACE_REPS``."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    shutil.rmtree(trace_dir, ignore_errors=True)
    with jax.profiler.trace(trace_dir):
        for _ in range(TRACE_REPS):
            out = fn(*args)
        jax.block_until_ready(out)
    total = 0
    for path in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True):
        for plane in ProfileData.from_file(path).planes:
            if plane.name.startswith("/device:GPU"):
                total += sum(ev.duration_ns for line in plane.lines
                             if line.name.startswith("Stream")
                             for ev in line.events)
    if not total:
        raise RuntimeError(f"no GPU stream events in {trace_dir}")
    return total * 1e-9 / TRACE_REPS


def table_bytes(op):
    """Bytes one forward / adjoint / normal apply reads from stored tables
    (0 for matrix-free operators)."""
    from trips_tpu.sparse import EllOperator

    if isinstance(op, EllOperator):
        return {"fwd": op.vals.nbytes + op.cols.nbytes,
                "adj": op.vals_t.nbytes + op.cols_t.nbytes}
    stored = getattr(op, "stored_bytes", 0)
    return {"fwd": stored, "adj": stored, "ata": stored}


def apply_info(op, A, normal, trace_dir, peak):
    """Forward error against scipy in float64, and per-apply device time,
    bytes and bandwidth share."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    y = rng.standard_normal(A.shape[0]).astype(np.float32)
    got = np.asarray(op.matvec(jnp.asarray(x)), np.float64)
    ref = A.astype(np.float64) @ x.astype(np.float64)
    info = {"matvec_rel_err": float(np.linalg.norm(got - ref)
                                    / np.linalg.norm(ref))}
    applies = ({"ata": (lambda o, v: o.normal_matvec(v), x)} if normal else
               {"fwd": (lambda o, v: o.matvec(v), x),
                "adj": (lambda o, v: o.rmatvec(v), y)})
    nbytes = table_bytes(op)
    for name, (f, v) in applies.items():
        s = device_seconds(jax.jit(f), (op, jnp.asarray(v)),
                           os.path.join(trace_dir, name))
        info[f"{name}_us"] = s * 1e6
        if nbytes[name]:
            info[f"{name}_bytes"] = nbytes[name]
            if peak:
                info[f"{name}_peak_share"] = nbytes[name] / s / peak
    return info


def tomo_paths(A, nx, views):
    """(name, matrix_class, builder, solver name, streams per iteration)."""
    import jax.numpy as jnp

    from trips_tpu.operators import OnTheFlyFanProjector, ShearFanProjector
    from trips_tpu.sparse import (BsrOperator, BucketedBandedProjector,
                                  EllOperator)

    def buck(dtype):
        return lambda: BucketedBandedProjector.from_scipy_fan(
            A, nx, views, n_groups=32, n_buckets=4, dtype=dtype)

    return [
        ("ell_f32", "exact", lambda: EllOperator.from_scipy(A), "cgls", 2),
        ("bsr_f32", "exact", lambda: BsrOperator.from_scipy(A), "cgls", 2),
        ("banded_f32_buck", "exact", buck(None), "cgls", 2),
        ("banded_f32_buck_ata", "exact", buck(None), "cgls_normal", 1),
        ("onthefly_fan", "recomputed",
         lambda: OnTheFlyFanProjector(nx, views=views, dtype=jnp.float32),
         "cgls", 0),
        ("bsr_bf16", "quantized", lambda: BsrOperator.from_scipy(
            A, block_shape=(32, 128), block_dtype=jnp.bfloat16), "cgls", 2),
        ("bsr_int8", "quantized", lambda: BsrOperator.from_scipy(
            A, block_shape=(32, 128), block_dtype=jnp.int8), "cgls", 2),
        ("banded_bf16_buck_ata", "quantized", buck(jnp.bfloat16),
         "cgls_normal", 1),
        ("banded_int8_buck_ata", "quantized", buck("int8"), "cgls_normal",
         1),
        ("shear_fan", "surrogate", lambda: ShearFanProjector(
            nx, views=views, dtype=jnp.float32, g_dtype=jnp.bfloat16),
         "cgls", 0),
    ]


def dynamic_paths(A, frames, nx, angles):
    import jax.numpy as jnp

    from trips_tpu.core.linop import BlockDiagOperator
    from trips_tpu.operators import OnTheFlyFanProjector
    from trips_tpu.sparse import (BsrOperator, DynamicBandedOperator,
                                  EllOperator)

    return [
        ("ell_f32", "exact", lambda: EllOperator.from_scipy(A), "cgls", 2),
        ("bsr_f32", "exact", lambda: BsrOperator.from_scipy(A), "cgls", 2),
        ("banded_f32", "exact", lambda: DynamicBandedOperator.from_frames(
            frames, nx, angles), "cgls", 2),
        ("onthefly_fan", "recomputed", lambda: BlockDiagOperator(
            [OnTheFlyFanProjector(nx, angles=a, dtype=jnp.float32)
             for a in angles]), "cgls", 0),
    ]


def run_paths(shape, paths, A, b, iters, peak, card, report):
    """Measure every path at one shape into ``report["paths"]``; returns
    the names of exact-class paths whose apply missed ``EXACT_RTOL``."""
    from trips_tpu import krylov

    bad = []
    for name, cls, build, solver, streams in paths:
        key = name if shape == "tomo256x60" else f"{shape}/{name}"
        op = build()
        info = apply_info(op, A, solver == "cgls_normal",
                          os.path.join(TRACE_DIR, key.replace("/", "_")),
                          peak)
        info.update(measure(getattr(krylov, solver), op, b, A.nnz, streams,
                            iters))
        info["matrix_class"] = cls
        report["paths"][key] = info
        log(f"{key}: {info['gnnzps']:.3f} Gnnz/s (runs "
            f"{info['runs_gnnzps']}), matvec rel err "
            f"{info['matvec_rel_err']:.3e} [{card}]")
        if cls == "exact" and not info["matvec_rel_err"] <= EXACT_RTOL:
            bad.append(key)
        del op
    return bad


def main():
    import jax
    import jax.numpy as jnp

    from trips_tpu.config import enable_compile_cache
    from trips_tpu.problems.dynamic import generate_synthetic_dynamic
    from trips_tpu.problems.phantoms import grains
    from trips_tpu.problems.projector import fan_beam_matrix

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU; JAX found {dev.platform}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    peak = PEAK_BYTES_PER_S.get(dev.device_kind)
    report = {"device_kind": dev.device_kind, "device_count":
              len(jax.devices()), "card": card, "iters": ITERS,
              "peak_bytes_per_s": peak, "paths": {}}

    big = jnp.ones(2 ** 28, jnp.float32)  # 1 GiB
    t = device_seconds(jax.jit(lambda v: v * 2.0), (big,),
                       os.path.join(TRACE_DIR, "copy"))
    report["copy_bytes_per_s"] = 2 * big.nbytes / t
    log(f"copy 1 GiB: {report['copy_bytes_per_s'] / 1e9:.1f} GB/s [{card}]")
    del big

    nx, views = 256, 60
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    x_true = grains(nx, seed=0).reshape(-1).astype(np.float32)
    b_host = (A @ x_true).astype(np.float32)
    report["nnz"] = int(A.nnz)
    runs = [scipy_cgls_rate(A.astype(np.float64), b_host.astype(np.float64),
                            ITERS) for _ in range(3)]
    report["baseline_gnnzps"] = float(np.median(runs)) / 1e9
    log(f"scipy CSR baseline: {report['baseline_gnnzps']:.4f} Gnnz/s")
    bad = run_paths("tomo256x60", tomo_paths(A, nx, views), A,
                    jnp.asarray(b_host), ITERS, peak, card, report)

    Ad, bd, frames, _, nxd, _, _, _, _, angles = generate_synthetic_dynamic(
        nx=560, nt=8, views=11, noise_level=0.01, seed=0,
        return_angles=True)
    Ad = Ad.astype(np.float32)
    bad += run_paths("dynamic560", dynamic_paths(Ad, frames, nxd, angles),
                     Ad, jnp.asarray(bd, jnp.float32), DYNAMIC_ITERS, peak,
                     card, report)

    with open("BENCH_report.json", "w") as f:
        json.dump(report, f, indent=1)
    if bad:
        sys.exit(f"bench: exact-class applies off scipy float64 by more "
                 f"than {EXACT_RTOL:g}: {bad}")
    tomo = {k: v for k, v in report["paths"].items() if "/" not in k}
    best = max(tomo, key=lambda k: tomo[k]["gnnzps"])
    best_exact = max((k for k in tomo if tomo[k]["matrix_class"] == "exact"),
                     key=lambda k: tomo[k]["gnnzps"])
    print(json.dumps({
        "metric": "spmv_nnz_per_s_cgls_tomo256x60",
        "value": tomo[best]["gnnzps"] * 1e9,
        "unit": "nnz/s",
        "vs_baseline": tomo[best]["gnnzps"] / report["baseline_gnnzps"],
        "best_path": best,
        "value_exact_matrix": tomo[best_exact]["gnnzps"] * 1e9,
        "best_path_exact_matrix": best_exact,
        "baseline_gnnzps": report["baseline_gnnzps"],
        "device_kind": dev.device_kind,
        "card": card,
        "nnz": report["nnz"],
        "iters": ITERS,
    }), flush=True)


if __name__ == "__main__":
    main()

"""Global configuration for trips-tpu.

The reference library (TRIPs-Py) runs float64 NumPy on the CPU. On the GPU
the working dtype is float32; tests run on a CPU backend with x64 enabled to
match the reference oracles tightly.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

# Fixed in-checkout compile-cache directory, used when
# JAX_COMPILATION_CACHE_DIR is unset. The path is part of the cache key, so
# it must not move between runs.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def default_dtype():
    """float64 when jax x64 is enabled (CPU oracle tests), else float32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, names the directory; otherwise
    the cache goes to ``DEFAULT_CACHE_DIR``. Entry points
    (``chip_smoke.py``, ``bench.py``, the demos) call this once before
    their first compile."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m

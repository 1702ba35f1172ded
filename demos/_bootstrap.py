"""Demo bootstrap: make trips_tpu importable when running from the repo and
turn on the persistent compile cache. Demos run on JAX's default backend
(the GPU where there is one; JAX_PLATFORMS=cpu selects the CPU)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from trips_tpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

"""trips-tpu: regularization of linear ill-posed inverse problems in JAX.

Capability surface of TRIPs-Py (deblurring, CT, dynamic CT; direct, hybrid
Krylov and majorization-minimization solvers; GCV/DP/L-curve parameter
selection), redesigned for JAX/XLA on GPUs. See README.md and PARITY.md.
"""

__version__ = "0.1.0"

import jax

# Exact f32: on a GPU an f32 dot or convolution that names no precision may
# run in TF32 (about three decimal digits). The solvers, Krylov bases, blur
# and framelet products rely on the default, so the package pins it to true
# f32 once, here. Quantized (bf16/int8) paths pass their own precision.
jax.config.update("jax_default_matmul_precision", "highest")

from . import core, krylov, operators, parallel, problems, regparam, solvers, sparse, utils  # noqa: E402,F401,E501
from .core import LinearOperator, aslinearoperator  # noqa: E402,F401

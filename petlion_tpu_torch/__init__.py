"""petlion_tpu_torch — the PyTorch/CUDA port of the JAX P2D battery
simulation package that sits beside it as its reference.

Same module names as the JAX package; batch-first tensors throughout, with
the JAX package's three TPU kernels as CUDA kernels (`csrc/`: the
Gauss-Jordan inverse, the stacked small inverses and the fused nested Schur
chain; bound in `ops/gj_kernel.py`, `ops/gj_blocks.py`, `ops/dchain.py`).
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .chemistry import LCO
from .config import (Bounds, Discretizations, EXIT_REASONS, Numerics,
                     SimOptions)
from .convert import model_from_numpy
from .layout import StateLayout
from .parallel.batch import batch_simulate
from .physics.residuals import ModelConfig, calc_I1C, residual_core
from .sim import Model, petlion

__all__ = [
    "LCO", "Bounds", "Discretizations", "EXIT_REASONS", "Numerics",
    "SimOptions", "model_from_numpy", "StateLayout", "batch_simulate",
    "ModelConfig", "calc_I1C", "residual_core", "Model", "petlion",
]

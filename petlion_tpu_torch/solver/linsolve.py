"""Linear-solver pieces for the Newton iterations (counterpart of
the JAX package's ``solver/linsolve.py``): equilibrated explicit inverses, so every
solve is one batched matvec.

Dispatch of the inverse mirrors the JAX package: n ≤ 16 takes the plain
scalar Gauss-Jordan; larger matrices go to ``ops.gj_kernel.gj_inverse_hot``,
which launches the CUDA kernel for a CUDA tensor and takes the plain blocked
version for a CPU tensor.
"""

from __future__ import annotations

import torch

from ..ops.gj_kernel import (_best_bs, gj_inverse, gj_inverse_blocked,  # noqa: F401
                             gj_inverse_hot)


def _equilibrate(J):
    col = torch.clamp_min(J.abs().amax(dim=-2), 1e-30)
    Jc = J / col[..., None, :]
    row = torch.clamp_min(Jc.abs().amax(dim=-1), 1e-30)
    return Jc / row[..., :, None], row, col


def equilibrated_inv_factor(J):
    """Row/col-equilibrated explicit inverse of (..., n, n); the scalings
    keep the f32 inverse accurate across the P2D Jacobian's magnitudes."""
    Js, row, col = _equilibrate(J)
    if J.shape[-1] <= 16:
        inv = gj_inverse(Js)
    else:
        inv = gj_inverse_hot(Js)
    return (inv, row, col)


def equilibrated_inv_solve(fac, b):
    inv, row, col = fac
    return torch.matmul(inv, (b / row)[..., None])[..., 0] / col

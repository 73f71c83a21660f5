"""Linear-solver pieces for the Newton iterations (counterpart of
the JAX package's ``solver/linsolve.py``): equilibrated explicit inverses, so every
solve is one batched matvec; the refined pivoted LU of float32 thermal
runs; and the dense pivoted LU, plain or equilibrated, of the dense routes
(``fast_solver=False``, ``get_plan(..., use_schur=False)``), which the JAX
package computes with ``jax.scipy.linalg`` outside any Pallas kernel.

Dispatch of the inverse mirrors the JAX package: n ≤ 16 takes the plain
scalar Gauss-Jordan; larger matrices go to ``ops.gj_kernel.gj_inverse_hot``,
which launches the CUDA kernel for a CUDA tensor and takes the plain blocked
version for a CPU tensor.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from ..ops.gj_kernel import (_best_bs, gj_inverse, gj_inverse_blocked,  # noqa: F401
                             gj_inverse_hot)
from ..ops.jacobian import dense_jacobian, newton_system


def _equilibrate(J):
    col = torch.clamp_min(J.abs().amax(dim=-2), 1e-30)
    Jc = J / col[..., None, :]
    row = torch.clamp_min(Jc.abs().amax(dim=-1), 1e-30)
    return Jc / row[..., :, None], row, col


class EquilibratedInv(NamedTuple):
    """Explicit inverse of the row/column-equilibrated matrix, and its
    scalings: a solve is one batched matvec."""
    inv: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor


def equilibrated_inv_factor(J):
    """Row/col-equilibrated explicit inverse of (..., n, n); the scalings
    keep the f32 inverse accurate across the P2D Jacobian's magnitudes."""
    Js, row, col = _equilibrate(J)
    if J.shape[-1] <= 16:
        inv = gj_inverse(Js)
    else:
        inv = gj_inverse_hot(Js)
    return EquilibratedInv(inv, row, col)


def equilibrated_inv_solve(fac, b):
    if isinstance(fac, RefinedLU):
        return refined_lu_solve(fac, b)
    inv, row, col = fac
    return torch.matmul(inv, (b / row)[..., None])[..., 0] / col


class RefinedLU(NamedTuple):
    """Row/column-equilibrated pivoted LU and the matrix itself, so that
    every solve takes one refinement step x += M⁻¹(b − J x).

    The float32 thermal factorization: with a dT-hold row cond(J) reaches
    1e14–1e16, where pivot-free elimination loses every digit and the
    pivoted float32 solve alone leaves Newton at the edge of convergence;
    the refinement step brings it to ~1e-6 relative."""
    LU: torch.Tensor
    pivots: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    J: torch.Tensor


# pivoted LU factorizations (torch.linalg.lu_factor_ex calls) since the last
# reset, over every thread: the LU routes' count beside the kernels' launches
LU_FACTORS = [0]
_LU_LOCK = threading.Lock()


def pivoted_lu(A):
    """(LU, pivots) of a batch of matrices by `torch.linalg.lu_factor_ex`,
    which does not synchronize the host. A matrix that is not finite
    (LAPACK is not given it: an identity stands in) or meets an exact zero
    pivot (info ≠ 0) gets a NaN factor, so its solves are NaN and its
    Newton iteration fails, as a singular inverse does."""
    with _LU_LOCK:
        LU_FACTORS[0] += 1
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A = torch.where(bad[..., None, None], eye, A)
    if A.is_cuda or A.shape[0] == 1 or torch.get_num_threads() == 1:
        LU, pivots, info = torch.linalg.lu_factor_ex(A)
    else:
        # on the CPU with more than one thread, one matrix at a time: the
        # batched call of PyTorch 2.13.0+cpu (oneMKL 2024.2) never returns
        # for two or more float32 (351, 351) thermal Newton matrices at
        # 4 threads, after "oneMKL ERROR: Parameter 6 was incorrect on
        # entry to SLASWP"; at 1 thread it returns (ROADMAP C)
        LU, pivots, info = (torch.cat(x) for x in zip(
            *(torch.linalg.lu_factor_ex(A[b:b + 1]) for b in range(A.shape[0]))))
    LU = torch.where((bad | (info != 0))[..., None, None],
                     torch.full_like(LU, float("nan")), LU)
    return LU, pivots


def _lu_solve(LU, pivots, b):
    return torch.linalg.lu_solve(LU, pivots, b[..., None])[..., 0]


def refined_lu_factor(J):
    Js, row, col = _equilibrate(J)
    LU, pivots = pivoted_lu(Js)
    return RefinedLU(LU=LU, pivots=pivots, row=row, col=col, J=J)


class DenseLU(NamedTuple):
    """Pivoted LU of the dense Newton matrix."""
    LU: torch.Tensor
    pivots: torch.Tensor


def dense_factor(J):
    return DenseLU(*pivoted_lu(J))


def dense_solve(fac: DenseLU, b):
    return _lu_solve(fac.LU, fac.pivots, b)


class EquilibratedLU(NamedTuple):
    """Pivoted LU of the row/column-equilibrated dense Newton matrix and
    its scalings: the default factorization without a plan."""
    LU: torch.Tensor
    pivots: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor


def equilibrated_factor(J):
    """Row/column-equilibrated dense pivoted LU. The P2D Newton matrix
    mixes magnitudes from c_s (~5e4) down to j (~1e-5); unit max-norm rows
    and columns keep a float32 LU accurate."""
    Js, row, col = _equilibrate(J)
    return EquilibratedLU(*pivoted_lu(Js), row, col)


def equilibrated_solve(fac: EquilibratedLU, b):
    return _lu_solve(fac.LU, fac.pivots, b / fac.row) / fac.col


def make_dense_jacfwd(F, data: dict, factor=dense_factor):
    """jac_and_factor(t, y_pred, c0, psi_over_h) for ``bdf.Stepper``: the
    dense Newton matrix ∂F/∂y + c0 ∂F/∂yp as the Jacobian of
    y ↦ F(t, y, c0·y + const), in one stacked pass over identity seeds
    (``ops.jacobian.dense_jacobian``), then `factor` (the JAX package's
    ``make_dense_jacfwd``, with `jax.jacfwd`). F(t, y, yp, data) is
    batch-first; `data` holds its per-cell tensors."""
    def jac_and_factor(t, y_pred, c0, psi_over_h):
        g, d = newton_system(F, data, t, y_pred, c0, psi_over_h)
        return factor(dense_jacobian(g, y_pred, d))
    return jac_and_factor


def row_sums_in_column_order(P):
    """Σ_j P[..., i, j]: each row's products summed pairwise in column
    order (neighbouring columns first), in the working precision. The
    Newton matrix's rows are stencils whose neighbouring terms cancel
    down to the residual, and summed neighbour to neighbour they cancel
    before they meet the rest of the row. The refined float32 solve then
    matches the JAX package's (its XLA matvec on the CPU); with the
    residual from `torch.matmul` (MKL's gemv) it had 5× that error on
    dT-hold matrices (ROADMAP C.3). Elementwise adds only: the same bits
    on the CPU and on CUDA, and no TF32."""
    while P.shape[-1] > 1:
        if P.shape[-1] % 2:
            P = torch.nn.functional.pad(P, (0, 1))
        P = P[..., 0::2] + P[..., 1::2]
    return P[..., 0]


def refined_lu_solve(fac: RefinedLU, b):
    def base(rhs):
        return _lu_solve(fac.LU, fac.pivots, rhs / fac.row) / fac.col

    x = base(b)
    # one refinement step, its residual b − J x in the working precision
    # (float32 on the LU route, as the JAX package's)
    r = b - row_sums_in_column_order(fac.J * x[..., None, :])
    return x + base(r)

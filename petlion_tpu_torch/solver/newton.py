"""Consistent DAE initialization — Newton on the algebraic states
(counterpart of the JAX package's ``solver/newton.py``).

1. With YP = 0, iterate Newton on the algebraic sub-vector until
   ‖ΔY‖ < reltol_init (≤ maxiter iterations), per cell. The control row is
   evaluated a second time with YP_diff := the differential residual, so
   that a row that reads YP (the derivative holds, user residuals)
   constrains the algebraic states at initialization.
2. YP_diff ← differential residual at YP = 0 (the residual is rhs − YP).
3. YP_alg from a finite-difference probe through the last factorization.

Batch-first: every cell iterates until its own test passes; a converged
cell's state is frozen (masked), exactly as the JAX while_loop under vmap
freezes it. The host checks once per iteration whether any cell is still
iterating.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.jacobian import dense_jacobian
from . import linsolve


class InitResult(NamedTuple):
    y: torch.Tensor
    yp: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor


def _select(mask, a, b):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def algebraic_residual(F: Callable, n_diff: int):
    """alg_res(y_alg, d): the algebraic rows of F at YP = 0, (M, n_alg), with
    the differential states in d["_y_diff"] and the time in d["_t_init"];
    its last row is the control row with YP_diff := rhs (the residual at
    YP = 0 is the rhs, since res = rhs − YP), as the JAX package substitutes
    it."""
    nd = n_diff

    def alg_res(y_alg, d):
        y = torch.cat([d["_y_diff"], y_alg], dim=-1)
        t = d["_t_init"][:, 0]
        yp0 = torch.zeros_like(y)
        r = F(t, y, yp0, d)
        yp_eff = torch.cat([r[:, :nd], yp0[:, nd:]], dim=-1)
        r2 = F(t, y, yp_eff, d)
        return torch.cat([r[:, nd:-1], r2[:, -1:]], dim=-1)
    return alg_res


def consistent_init(F: Callable, y0, n_diff: int, data: dict, *,
                    reltol_init=1e-3, maxiter=100, c_e0=1000.0, t0=None,
                    jac_plan=None, th=None, cells=None) -> InitResult:
    """F(t, y, yp, data) -> full residual (B, N) with the control row; `data`
    holds the per-cell tensors F reads (θ, setpoint). y0: (B, N) guess; t0:
    each cell's initialization time, (B,) (0 by default; a re-initialization
    after a discontinuity passes the cells' jump times). With θ (`th`, (B, 1)
    tensors) the plan may assemble the algebraic block analytically; without
    a plan the block is the dense Jacobian of the algebraic residual, by one
    stacked pass over identity seeds, and its equilibrated inverse (K1 on
    the card), as the JAX package's `jax.jacfwd` route (in float32 thermal
    runs too: the dense route takes no refined LU).
    `cells` (B,) bool: the cells whose iteration the loop waits for (all by
    default); the others take the first iteration only."""
    nd = n_diff
    dtype = y0.dtype
    if t0 is None:
        t0 = torch.zeros(y0.shape[0], dtype=dtype, device=y0.device)
    data = dict(data, _t_init=t0[:, None])
    alg_res = algebraic_residual(F, nd)

    def body(y):
        y_diff, y_alg = y[:, :nd], y[:, nd:]
        d = dict(data, _y_diff=y_diff)
        r = alg_res(y_alg, d)
        if jac_plan is not None:
            lu = jac_plan.factor_alg(alg_res, y_alg, d, y_diff=y_diff, th=th)
        else:
            lu = linsolve.equilibrated_inv_factor(dense_jacobian(alg_res, y_alg, d))
        step = linsolve.equilibrated_inv_solve(lu, r)
        # trust-region cap against astronomically long steps (f32 noise
        # floors, extreme setpoints); convergent iterations are unchanged
        rel = torch.sqrt(torch.mean((step / (1.0 + y_alg.abs())) ** 2, dim=-1))
        step = step * torch.clamp_max(10.0 / torch.clamp_min(rel, 1e-30),
                                      1.0)[:, None]
        step = torch.nan_to_num(step, nan=0.0, posinf=0.0, neginf=0.0)
        y_new = torch.cat([y_diff, y_alg - step], dim=-1)
        return y_new, torch.linalg.vector_norm(step, dim=-1), lu

    # one unconditional iteration, then per-cell masked iterations
    y, dnorm, lu = body(y0)
    it = torch.ones(y0.shape[0], dtype=torch.int64, device=y0.device)
    wait = (torch.ones_like(dnorm, dtype=torch.bool) if cells is None else cells)
    while True:
        live = wait & (it < maxiter) & (dnorm >= reltol_init)
        if not bool(live.any()):
            break
        y_n, dnorm_n, lu_n = body(y)
        y = _select(live, y_n, y)
        dnorm = torch.where(live, dnorm_n, dnorm)
        lu = type(lu_n)._make(_select(live, a, b) for a, b in zip(lu_n, lu))
        it = it + live.to(it.dtype)
    converged = dnorm < reltol_init

    # differential derivatives: residual rows at YP=0 equal the rhs
    yp = torch.zeros_like(y)
    r_full = F(t0, y, yp, data)
    yp[:, :nd] = r_full[:, :nd]

    # finite-difference estimate of dY_alg/dt
    eps = torch.finfo(dtype).eps
    dt = max(10.0 * reltol_init,
             float(torch.sqrt(torch.tensor(eps * c_e0, dtype=dtype))))
    y_t = y + dt * yp
    r_alg = F(t0 + dt, y_t, yp, data)[:, nd:]
    yp[:, nd:] = -linsolve.equilibrated_inv_solve(lu, r_alg) / dt
    return InitResult(y=y, yp=yp, converged=converged,
                      iterations=it.to(torch.int32))

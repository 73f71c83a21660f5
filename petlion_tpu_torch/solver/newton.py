"""Consistent DAE initialization — Newton on the algebraic states
(counterpart of the JAX package's ``solver/newton.py``).

1. With YP = 0, iterate Newton on the algebraic sub-vector until
   ‖ΔY‖ < reltol_init (≤ maxiter iterations), per cell.
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

from . import linsolve


class InitResult(NamedTuple):
    y: torch.Tensor
    yp: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor


def _select(mask, a, b):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def consistent_init(F: Callable, y0, n_diff: int, data: dict, *,
                    reltol_init=1e-3, maxiter=100, c_e0=1000.0, t0=0.0,
                    jac_plan=None, th=None) -> InitResult:
    """F(t, y, yp, data) -> full residual (B, N) with the control row; `data`
    holds the per-cell tensors F reads (θ, setpoint). y0: (B, N) guess. With
    θ (`th`, (B, 1) tensors) the plan may assemble the algebraic block
    analytically."""
    nd = n_diff
    dtype = y0.dtype

    def alg_res(y_alg, d):
        # The JAX package evaluates the control row a second time with
        # yp_diff := r_diff for controls that read YP; constant-current
        # control does not, so that row equals the first evaluation's.
        y = torch.cat([d["_y_diff"], y_alg], dim=-1)
        return F(t0, y, torch.zeros_like(y), d)[:, nd:]

    def body(y):
        y_diff, y_alg = y[:, :nd], y[:, nd:]
        d = dict(data, _y_diff=y_diff)
        r = alg_res(y_alg, d)
        lu = jac_plan.factor_alg(alg_res, y_alg, d, y_diff=y_diff, th=th)
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
    while True:
        live = (it < maxiter) & (dnorm >= reltol_init)
        if not bool(live.any()):
            break
        y_n, dnorm_n, lu_n = body(y)
        y = _select(live, y_n, y)
        dnorm = torch.where(live, dnorm_n, dnorm)
        lu = tuple(_select(live, a, b) for a, b in zip(lu_n, lu))
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

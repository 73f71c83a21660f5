"""Parameter estimation: the voltage at fixed times as a function of θ, its
sensitivities, and a Gauss–Newton fit (counterpart of the JAX package's
``estimation.py``).

The JAX package takes one ``jax.jacfwd`` through the whole solve —
consistent initialization, adaptive BDF, Newton, the linear interpolation of
the trace. The port takes the same derivative in forward mode
(``torch.autograd.forward_ad``), and runs the k directions as k rows of one
batch-first run: θ repeated, row i carrying the tangent eᵢ. That is one host
loop for all directions, as jacfwd is one pass; rows that are copies of one
cell take the same steps (checked: a run whose rows part raises). The
tangent flows where JAX's does: through the Newton matrix and its inverse
(the kernels' tangent Functions, ``ops/dual.py``: K1ᵗ and K3ᵗ on the card),
the step sizes, and so the time grid the interpolation reads. Host floats
(tf, tolerances) are constants, as Python constants are in JAX.

    voltage, th0 = make_voltage_model(p, ["D_sp"], t_eval=t, I_crate=-1)
    J, th0 = sensitivities(p, ["D_sp"], t, I_crate=-1, SOC=0.5)  # ∂V(t)/∂θ
    theta = fit(p, ["D_sp", "k_n"], t_data, V_data, I_crate=-1)  # {key: value}
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .ops.dual import fast_zero_tangents, primal
from .ops.plan import get_plan
from .physics.initial_guess import initial_guess
from .sim import Model
from .solver import control, events
from .solver.run import run_once


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` row by row, in its arithmetic: x (M,), xp
    and fp (B, K) with each xp row increasing; (B, M). Differentiable in xp
    and fp, as JAX's."""
    B, K = xp.shape
    X = x.expand(B, -1).contiguous()
    i = torch.clamp(torch.searchsorted(primal(xp).contiguous(), X, right=True), 1, K - 1)
    x_lo, x_hi = xp.gather(1, i - 1), xp.gather(1, i)
    f_lo, f_hi = fp.gather(1, i - 1), fp.gather(1, i)
    dx = x_hi - x_lo
    eps = np.spacing(np.finfo(np.float32 if xp.dtype == torch.float32 else np.float64).eps)
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f_lo, f_lo + ((X - x_lo) / torch.where(dx0, 1.0, dx))
                    * (f_hi - f_lo))
    f = torch.where(X < xp[:, :1], fp[:, :1], f)
    return torch.where(X > xp[:, -1:], fp[:, -1:], f)


class VoltageModel:
    """V(θ_fit) at fixed times: ``voltage(theta)`` for one (k,) vector of the
    fitted parameters, ``voltage.rows(theta)`` for a (B, k) batch, which also
    returns the run."""

    def __init__(self, p: Model, fit_keys, t_eval, I_crate, SOC, opts, jac_plan):
        self.p, self.fit_keys = p, list(fit_keys)
        self.kw = dict(dtype=p.dtype, device=p.device)
        t_np = np.asarray(t_eval, dtype=np.float64)
        self.t_eval = torch.as_tensor(t_np, **self.kw)
        self.tf = float(np.max(t_np)) * 1.0000001
        self.I_crate, self.SOC = float(I_crate), float(SOC)
        self.opts, self.jac_plan = opts, jac_plan

    def rows(self, theta):
        """(V (B, M), the run's RunResultDev) for θ_fit rows (B, k)."""
        p, kw = self.p, self.kw
        X = torch.as_tensor(theta, **kw).reshape(-1, len(self.fit_keys))
        B = X.shape[0]
        th = {k: v.to(**kw).reshape(1, 1).expand(B, 1) for k, v in p.theta.items()}
        for i, k in enumerate(self.fit_keys):
            th[k] = X[:, i:i + 1]
        soc0 = torch.full((B,), self.SOC, **kw)
        # bound exits off, so that the trace covers t_eval
        bounds = {k: torch.full((B,), math.nan, **kw) for k in events.BOUND_KEYS}
        with torch.no_grad():
            res = run_once(y_start=initial_guess(soc0, th, p.cfg), soc0=soc0,
                           value=torch.full((B,), self.I_crate, **kw), tf=self.tf,
                           th=th, bounds=bounds, cfg=p.cfg,
                           spec=control.ControlSpec("I"), opts=self.opts,
                           jac_plan=self.jac_plan)
            t, n = res.bufs["t"], res.n_saved.long()[:, None]
            # the unused buffer tail masked, so that the grid stays monotone
            ar = torch.arange(t.shape[1], device=t.device)[None, :]
            t = torch.where(ar < n, t, t.gather(1, n - 1) + 1e30)
            return interp(self.t_eval, t, res.bufs["V"]), res

    def __call__(self, theta):
        x = torch.as_tensor(theta, **self.kw)
        V = self.rows(x)[0]
        return V[0] if x.ndim == 1 else V


def make_voltage_model(p: Model, fit_keys: Sequence[str], *, t_eval,
                       I_crate: float, SOC: float = 1.0, reltol=1e-5,
                       abstol=1e-7, max_save: int = 512, fast_solver: bool = True,
                       route=None):
    """Build V(θ_fit) -> the voltage at `t_eval` (the linear interpolation
    of the adaptive solver's trace), differentiable in forward mode.

    Returns (voltage, theta0): ``voltage`` maps a (k,) tensor of the values
    of `fit_keys` to V (M,) (``VoltageModel``), theta0 is θ[fit_keys] of `p`.
    `route`: the Newton matrix's assembly and factorization
    (``ops.plan.Route``; default: the PETLION_* environment variables)."""
    opts = p.opts.replace(max_save=max_save, reltol=reltol, abstol=abstol)
    jac_plan = get_plan(p.cfg, p.theta_floats(), route) if fast_solver else None
    voltage = VoltageModel(p, fit_keys, t_eval, I_crate, SOC, opts, jac_plan)
    theta0 = torch.stack([p.theta[k] for k in fit_keys]).to(**voltage.kw)
    return voltage, theta0


def check_same_steps(res):
    """Raise RuntimeError unless every row of the run took the same steps: the
    same counts of steps, rejections and records, at times equal to within
    1e-6 of the run's span. Copies of one cell round apart on the CPU,
    where vectorized functions round by an element's position, and the step
    control carries that on: over the 1700 s of the JAX package's fit the
    rows' times drift up to 8e-9 of the span apart on the CPU."""
    counts = torch.stack([res.n_steps, res.n_rejected, res.n_saved]).long()
    t = primal(res.bufs["t"])
    apart = float((t - t[:1]).abs().max()) if t.shape[0] > 1 else 0.0
    if not bool((counts == counts[:, :1]).all()) or apart > 1e-6 * float(t.abs().max()):
        raise RuntimeError(f"the rows of the forward-mode run took different steps: "
                           f"steps, rejections, records {counts.tolist()}, times up "
                           f"to {apart:.3e} s apart")


def value_and_jacobian(voltage: VoltageModel, x, transform=None):
    """(V, ∂V/∂x, run): V (M,) at θ = transform(x), its (M, k) Jacobian in
    x and the run's RunResultDev, by forward mode in one run of k rows (x
    repeated, row i carrying the tangent eᵢ). Raises RuntimeError if the
    rows did not take the same steps (``check_same_steps``)."""
    k = x.shape[0]
    with fwAD.dual_level(), fast_zero_tangents():
        X = fwAD.make_dual(x.expand(k, k).contiguous(),
                           torch.eye(k, dtype=x.dtype, device=x.device))
        V, res = voltage.rows(X if transform is None else transform(X))
        Vp, Vt = fwAD.unpack_dual(V)
        check_same_steps(res)
    J = torch.zeros_like(Vp).T if Vt is None else Vt.T
    return Vp[0], J.contiguous(), res


def fit(p: Model, fit_keys: Sequence[str], t_data, V_data, *,
        I_crate: float, SOC: float = 1.0, iters: int = 8,
        log_params: bool = True, damping: float = 1e-10,
        verbose: bool = False, **model_kw) -> Dict[str, float]:
    """Gauss–Newton fit of θ[fit_keys] to a measured voltage trace, in
    log-parameter space by default (transport and kinetic parameters span
    decades and stay positive). Returns the fitted parameter dict."""
    voltage, theta0 = make_voltage_model(p, fit_keys, t_eval=t_data,
                                         I_crate=I_crate, SOC=SOC, **model_kw)
    V_data = torch.as_tensor(np.asarray(V_data, dtype=np.float64), **voltage.kw)
    x = torch.log(theta0) if log_params else theta0
    transform = torch.exp if log_params else None
    eye = torch.eye(len(x), **voltage.kw)
    for it in range(iters):
        V, J, _ = value_and_jacobian(voltage, x, transform)
        r = V - V_data
        step = torch.linalg.solve(J.T @ J + damping * eye, J.T @ r)
        x = x - step
        if verbose:
            print(f"  GN iter {it}: rms={float(torch.sqrt(torch.mean(r ** 2))):.3e}")
        if float(torch.linalg.norm(step)) < 1e-10:
            break
    theta_fit = torch.exp(x) if log_params else x
    return {k: float(v) for k, v in zip(fit_keys, theta_fit)}


def sensitivities(p: Model, fit_keys: Sequence[str], t_eval, *,
                  I_crate: float, SOC: float = 1.0, **model_kw):
    """∂V(t)/∂θ for the given parameters, (M, k), and θ0 (k,), as numpy:
    one forward-mode run through the solver."""
    voltage, theta0 = make_voltage_model(p, fit_keys, t_eval=t_eval,
                                         I_crate=I_crate, SOC=SOC, **model_kw)
    J = value_and_jacobian(voltage, theta0)[1]
    return J.cpu().numpy(), theta0.cpu().numpy()

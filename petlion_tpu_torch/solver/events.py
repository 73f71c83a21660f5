"""Stop conditions (bounds) with back-interpolation fractions, batch-first
(counterpart of the JAX package's ``solver/events.py``).

Each accepted step compares the monitored quantities against their bounds;
a crossing sets the exit flag and records the linear interpolation fraction
t_frac ∈ (0, 1] of the crossing inside the step. The flag codes and the
"smallest t_frac wins" arbitration are the JAX package's. Every quantity
carries the cells axis, so cells stop independently.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import EXIT_SIMULATING
from ..physics.residuals import ModelConfig
from .control import cell_values


class BoundsPrev(NamedTuple):
    """Previous-step values of monitored quantities, each (B,)."""
    t_frac: torch.Tensor
    V: torch.Tensor
    SOC: torch.Tensor
    T: torch.Tensor
    c_s_n: torch.Tensor
    I: torch.Tensor
    eta_plating: torch.Tensor
    c_e_min: torch.Tensor
    dfilm: torch.Tensor
    stop_g: torch.Tensor

    @staticmethod
    def init(like):
        def f(v):
            return torch.full_like(like, v)
        return BoundsPrev(t_frac=f(1.0), V=f(-1.0), SOC=f(-1.0), T=f(-1.0),
                          c_s_n=f(-1.0), I=f(-1.0), eta_plating=f(-1.0),
                          c_e_min=f(-1.0), dfilm=f(-1.0), stop_g=f(-1.0))


def check_stop(t, y, yp, soc, prev: BoundsPrev, flag, bounds: dict, th,
               cfg: ModelConfig, spec_method: str, *, reltol: float,
               tf, check_bounds: bool = True, is_rest: bool = False,
               is_temperature_hold: bool = False, stop_fn=None):
    """One stop-condition sweep over all cells. Returns (new_prev, new_flag).

    `flag` is EXIT_SIMULATING (-1) while running; `bounds` is a dict of (B,)
    tensors (NaN disables: NaN comparisons are False). `is_temperature_hold`
    turns the temperature bound off; it matters only to the thermal model,
    which the port does not have yet, and is threaded through as in the JAX
    package. `stop_fn(t, y, yp, soc, th)` is the user's stop hook, batch-first:
    a boolean result fires flag 12 on the accepted step; any other result is
    a signed margin that fires flag 12 where it crosses 0 upward, in the same
    smallest-t_frac arbitration as the built-in bounds."""
    L = cfg.layout
    eps = torch.where(t < 1.0, torch.full_like(t, reltol), torch.zeros_like(t))

    flag = torch.where((flag == EXIT_SIMULATING) & (t >= tf),
                       torch.zeros_like(flag), flag)

    if not check_bounds or is_rest:
        return prev, flag

    I = L.I(y)
    dI = L.I(yp)
    V = L.V(y)
    dV = L.V(yp)

    state = dict(flag=flag, t_frac=prev.t_frac)

    def fire(state, cond, prev_v, bound_v, cur_v, code):
        tf_new = (prev_v - bound_v) / (prev_v - cur_v)
        tf_new = torch.nan_to_num(torch.clamp(tf_new, 0.0, 1.0), nan=1.0)
        take = cond & (tf_new < state["t_frac"])
        return dict(
            flag=torch.where(take, torch.full_like(state["flag"], code),
                             state["flag"]),
            t_frac=torch.where(take, tf_new, state["t_frac"]),
        )

    if spec_method != "I":
        state = fire(state, (I - bounds["I_max"] > eps) & (dI > 0),
                     prev.I, bounds["I_max"], I, 7)
        state = fire(state, (bounds["I_min"] - I > eps) & (dI < 0),
                     prev.I, bounds["I_min"], I, 8)

    if spec_method != "V":
        state = fire(state, (bounds["V_min"] - V > eps) & (dV < 0),
                     prev.V, bounds["V_min"], V, 1)
        state = fire(state, (V - bounds["V_max"] > eps) & (dV > 0),
                     prev.V, bounds["V_max"], V, 2)

    state = fire(state, (bounds["SOC_min"] - soc > eps) & (I < 0),
                 prev.SOC, bounds["SOC_min"], soc, 3)
    state = fire(state, (soc - bounds["SOC_max"] > eps) & (I > 0),
                 prev.SOC, bounds["SOC_max"], soc, 4)

    # isothermal: no temperature bound (the JAX package checks T_max only
    # with temperature=True)
    T_mean = prev.T

    c_max_n = th["c_max_n"][:, 0]
    c_s_n_max = torch.amax(L.c_s_surf(y, "n"), dim=-1)
    state = fire(state,
                 (I > 0) & (c_s_n_max - bounds["c_s_n_max"] * c_max_n > eps),
                 prev.c_s_n, bounds["c_s_n_max"] * c_max_n, c_s_n_max, 6)

    c_e_min = torch.amin(L.get(y, "c_e"), dim=-1)
    state = fire(state, (bounds["c_e_min"] - c_e_min > eps),
                 prev.c_e_min, bounds["c_e_min"], c_e_min, 9)

    eta_pl = L.eta_plating(y)
    d_eta = L.eta_plating(yp)
    state = fire(state, (bounds["eta_plating_min"] - eta_pl > eps) & (d_eta < 0),
                 prev.eta_plating, bounds["eta_plating_min"], eta_pl, 11)

    stop_g = prev.stop_g
    if stop_fn is not None:
        out = cell_values(stop_fn(t, y, yp, soc, th), y)
        if out.dtype == torch.bool:
            state["flag"] = torch.where(
                out & (state["flag"] == EXIT_SIMULATING),
                torch.full_like(state["flag"], 12), state["flag"])
        else:
            stop_g = out
            state = fire(state, stop_g > eps, prev.stop_g,
                         torch.zeros_like(stop_g), stop_g, 12)

    new_prev = BoundsPrev(
        t_frac=state["t_frac"], V=V, SOC=soc, T=T_mean, c_s_n=c_s_n_max,
        I=I, eta_plating=eta_pl, c_e_min=c_e_min, dfilm=prev.dfilm,
        stop_g=stop_g)
    return new_prev, state["flag"]


BOUND_KEYS = ("V_max", "V_min", "SOC_max", "SOC_min", "T_max", "c_s_n_max",
              "I_max", "I_min", "eta_plating_min", "c_e_min", "dfilm_max")


def bounds_dict(bounds) -> dict:
    """A Bounds dataclass as a dict of plain floats."""
    return {k: float(getattr(bounds, k, math.nan)) for k in BOUND_KEYS}

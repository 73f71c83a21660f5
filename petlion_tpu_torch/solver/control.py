"""Control modes — the scalar (last) DAE row (counterpart of the JAX
package's ``solver/control.py``).

The last DAE row pins the run's controlled quantity — current, voltage,
power, plating overpotential, or an arbitrary user residual — to its
target. A run is a static ``ControlSpec`` (method, an optional user
function, an optional per-run setup hook) plus a per-cell setpoint
``value`` (B,).

User functions are batch-first, which is where the port's API differs from
the JAX package's per-cell scalars. ``f(t, y, yp, th)`` receives

* ``t``: the cells' times, (B,);
* ``y``, ``yp``: the cells' states and their derivatives, (B, N);
* ``th``: the dict of (B, 1) θ tensors, including any extra
  ``theta_batch`` key (``th["t_pulse_off"][:, 0]`` is each cell's own value),

and returns a (B,) tensor on the run's device, or a Python number (the same
for every cell). Shorter signatures ``f(t)``, ``f(t, th)`` and
``f(t, y, th)`` are accepted, as in the JAX package (``normalize_func``).
For example, a 1C pulse that ends at each cell's own time:

    I = lambda t, y, yp, th: torch.where(t < th["t_pulse_off"][:, 0], -1.0, 0.0)

A function that returns a numpy array, or a tensor on another device than
the run's (a CPU tensor for a CUDA run), raises: the run never copies a
result between devices.
"""

from __future__ import annotations

import dataclasses
import inspect
import numbers
from typing import Callable, Optional

import numpy as np
import torch

from ..physics.residuals import ModelConfig, calc_I1C, residual_core

METHODS = ("I", "V", "P", "eta_p", "res")


def normalize_func(f: Callable) -> Callable:
    """Accept f(t), f(t, th), f(t, y, th) or f(t, y, yp, th)."""
    try:
        n = len(inspect.signature(f).parameters)
    except (TypeError, ValueError):
        n = 4
    if n >= 4:
        return f
    if n == 3:
        return lambda t, y, yp, th: f(t, y, th)
    if n == 2:
        return lambda t, y, yp, th: f(t, th)
    if n == 1:
        return lambda t, y, yp, th: f(t)
    raise ValueError("control function needs at least one argument (t)")


def cell_values(v, like: torch.Tensor) -> torch.Tensor:
    """A user function's result as a (B,) tensor for the rows of `like`
    (B, N): a tensor of one or B elements on `like`'s device, or a Python
    number. A boolean result stays boolean; any other takes `like`'s dtype."""
    B = like.shape[0]
    if isinstance(v, torch.Tensor):
        if v.device != like.device:
            raise TypeError(
                f"a user function returned a tensor on {v.device} for a run on "
                f"{like.device}; compute it from the tensors it is given")
        if v.dtype != torch.bool:
            v = v.to(like.dtype)
        if v.numel() == 1:
            return v.reshape(()).expand(B)
        if v.numel() == B:
            return v.reshape(B)
        raise ValueError(f"a user function returned shape {tuple(v.shape)} for "
                         f"{B} cells; return (B,) or a scalar")
    if isinstance(v, (bool, np.bool_)):
        return torch.full((B,), bool(v), dtype=torch.bool, device=like.device)
    if isinstance(v, numbers.Real) and not isinstance(v, np.ndarray):
        return torch.full((B,), float(v), dtype=like.dtype, device=like.device)
    raise TypeError(
        f"a user function returned {type(v).__name__}; return a torch tensor on "
        f"the run's device ({like.device}) or a Python number")


@dataclasses.dataclass(frozen=True)
class ControlSpec:
    """Static description of one run's control mode.

    method: one of METHODS. func: optional function whose output is the
    setpoint; for method "res" it is the residual expression itself.

    init_aux: optional per-run setup hook ``f(y_start, th) -> tensor`` whose
    result is put in θ as ``th["_ctrl_aux"]`` before any residual
    evaluation. The derivative holds (dc_s_*/dc_e_*) use it to pick, per
    cell, the extremal node of the run's starting state."""

    method: str
    func: Optional[Callable] = None
    init_aux: Optional[Callable] = None

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(self.method)


def control_value(spec: ControlSpec, value, t, y, yp, th):
    """The instantaneous setpoint of the run, (B,)."""
    if spec.func is not None:
        return cell_values(spec.func(t, y, yp, th), y)
    return value


def measured(spec: ControlSpec, y, th, cfg: ModelConfig):
    """The controlled quantity evaluated from the state, (B,)."""
    L = cfg.layout
    m = spec.method
    if m == "I":
        return L.I(y)
    if m == "V":
        return L.V(y)
    if m == "P":
        return L.I(y) * calc_I1C(th)[:, 0] * L.V(y)
    if m == "eta_p":
        return L.eta_plating(y)
    raise ValueError(m)


def scalar_residual(spec: ControlSpec, value, t, y, yp, th, cfg: ModelConfig):
    """res[end] = measured(Y) − setpoint, (B,); for method "res" the row is
    value − func(t, Y, YP, θ)."""
    if spec.method == "res":
        return value - cell_values(spec.func(t, y, yp, th), y)
    return measured(spec, y, th, cfg) - control_value(spec, value, t, y, yp, th)


def full_residual(spec: ControlSpec, value, t, y, yp, th, cfg: ModelConfig):
    """Physics residual with the control row filled in, (B, N_tot)."""
    r = residual_core(t, y, yp, th, cfg)
    sr = scalar_residual(spec, value, t, y, yp, th, cfg)
    return torch.cat([r[:, :-1], sr[:, None]], dim=-1)

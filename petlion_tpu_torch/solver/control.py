"""Control modes — the scalar (last) DAE row (counterpart of
the JAX package's ``solver/control.py``).

A run is a static ``ControlSpec`` plus a per-cell setpoint ``value``
(``(B,)``). This package implements constant-current control (method "I");
the other methods raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..physics.residuals import ModelConfig, residual_core

METHODS = ("I", "V", "P", "eta_p", "res")


@dataclasses.dataclass(frozen=True)
class ControlSpec:
    method: str
    func: Optional[Callable] = None
    init_aux: Optional[Callable] = None

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(self.method)
        if self.method != "I":
            raise NotImplementedError(f"control method {self.method!r}")
        if self.func is not None:
            raise NotImplementedError("function inputs (I=callable)")
        if self.init_aux is not None:
            raise NotImplementedError("ControlSpec.init_aux")


def measured(spec: ControlSpec, y, th, cfg: ModelConfig):
    """The controlled quantity evaluated from the state, (B,)."""
    return cfg.layout.I(y)


def scalar_residual(spec: ControlSpec, value, t, y, yp, th, cfg: ModelConfig):
    """res[end] = measured(Y) − setpoint, (B,)."""
    return measured(spec, y, th, cfg) - value


def full_residual(spec: ControlSpec, value, t, y, yp, th, cfg: ModelConfig):
    """Physics residual with the control row filled in, (B, N_tot)."""
    r = residual_core(t, y, yp, th, cfg)
    sr = scalar_residual(spec, value, t, y, yp, th, cfg)
    return torch.cat([r[:, :-1], sr[:, None]], dim=-1)

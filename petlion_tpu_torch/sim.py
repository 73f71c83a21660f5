"""Top-level user API: the model factory (counterpart of
the JAX package's ``sim.py``; `petlion`, `Model` and the constant-current control
of `_build_control`).

    p   = petlion(LCO)                          # on CUDA, float64
    p   = petlion(LCO, device="cpu")            # the CPU, as the tests run
    res = batch_simulate(p, 3.9e3, I=-1, SOC=1, theta_batch={...})

Entry points run on ``cuda`` unless the caller passes another device; asking
for CUDA where there is none raises. Nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .chemistry import LCO
from .config import Bounds, Discretizations, Numerics, SimOptions
from .layout import StateLayout
from .physics.residuals import ModelConfig, calc_I1C, check_supported
from .solver import control as ctrl

_OPT_KEYS = ("outputs", "abstol", "abstol_T", "reltol", "abstol_init",
             "reltol_init", "maxiters", "check_bounds", "reinit", "verbose",
             "interp_final", "interp_bc", "max_order", "max_save",
             "newton_maxiter", "init_maxiter", "dt0", "dtmax", "save_start",
             "stop_function", "jac_reuse", "step_control")
_METHOD_KEYS = ("I", "V", "P", "eta_p", "res", "dT",
                "dc_s_p_max", "dc_s_p_min", "dc_s_n_max", "dc_s_n_min",
                "dc_e_max", "dc_e_min", "T")


def resolve_device(device, dtype: torch.dtype) -> torch.device:
    """The run's device. CUDA must exist when asked for, and a float32 run
    there needs full-precision float32 products: it raises while TF32 is on
    for matmuls, as the elimination's products must not round to TF32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "a float32 run on CUDA needs torch.backends.cuda.matmul."
                "allow_tf32 = False (TF32 rounds the elimination's products)")
    return dev


@dataclasses.dataclass
class Model:
    """Parameters + static model structure. θ is a dict of 0-d tensors on
    the model's device and dtype."""
    theta: dict
    bounds: Bounds
    opts: SimOptions
    N: Discretizations
    numerics: Numerics
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype

    @property
    def layout(self) -> StateLayout:
        return self.cfg.layout

    @property
    def I1C(self) -> float:
        th = {k: v.reshape(1, 1) for k, v in self.theta.items()}
        return float(calc_I1C(th))

    def theta_floats(self) -> dict:
        return {k: float(v) for k, v in self.theta.items()}


def make_model(theta: dict, bounds: Bounds, opts: SimOptions,
               N: Discretizations, numerics: Numerics, *, device,
               dtype) -> Model:
    cfg = ModelConfig.build(N, numerics)
    check_supported(cfg)
    dev = resolve_device(device, dtype)
    th = {k: torch.tensor(float(v), dtype=dtype, device=dev)
          for k, v in theta.items()}
    return Model(theta=th, bounds=bounds, opts=opts, N=N, numerics=numerics,
                 cfg=cfg, device=dev, dtype=dtype)


def petlion(chemistry: Callable = LCO, *, device="cuda",
            dtype: torch.dtype = torch.float64, **kwargs) -> Model:
    """Model factory: `chemistry(**kwargs)` gives (θ, bounds, opts, N,
    numerics); θ becomes tensors on `device` in `dtype`."""
    theta, bounds, opts, N, numerics = chemistry(**kwargs)
    return make_model(theta, bounds, opts, N, numerics, device=device,
                      dtype=dtype)


def _build_control(p: Model, sol, kwargs):
    """Identify the control method and build (name, spec, value, is_rest,
    is_temperature_hold). Only a constant current (I=<number>) is ported."""
    given = [k for k in _METHOD_KEYS if k in kwargs]
    if len(given) != 1:
        raise ValueError(
            f"choose exactly one input from {_METHOD_KEYS}; got {given}")
    name = given[0]
    inp = kwargs.pop(name)
    if name != "I":
        raise NotImplementedError(f"control input {name}=")
    if callable(inp):
        raise NotImplementedError("function inputs (I=callable)")
    if isinstance(inp, str):
        raise NotImplementedError(f"I={inp!r}")
    return name, ctrl.ControlSpec("I"), float(inp), False, False

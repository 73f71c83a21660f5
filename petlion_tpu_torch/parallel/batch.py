"""Batched simulation over cells (counterpart of
the JAX package's ``parallel/batch.py:batch_simulate``).

The JAX package vmaps a single-cell run; here the run itself is batch-first
(solver/run.py), so a fleet of cells is one call whose tensors carry a
leading cells axis. Cells never couple.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.plan import Route, get_plan
from ..physics.initial_guess import initial_guess
from ..sim import Model, _OPT_KEYS, _build_control, resolve_device
from ..solver import events
from ..solver.run import RunResultDev, run_once


def batch_simulate(p: Model,
                   tf: float = 1e6,
                   *,
                   n_cells: Optional[int] = None,
                   theta_batch: Optional[dict] = None,
                   SOC=None,
                   value_batch=None,
                   device=None,
                   dtype: Optional[torch.dtype] = None,
                   route: Optional[Route] = None,
                   **kwargs) -> RunResultDev:
    """Run the same control segment over a batch of cells.

    theta_batch: dict of θ overrides with a leading batch dim (other θ keys
    broadcast); a key the model does not have rides along for user
    functions, which read it as ``th[key]``, (B, 1). The control is any
    input of ``simulate`` but "hold" (I=, V=, P=, eta_p=, res=, dc_*=,
    constants or batch-first functions). SOC / value_batch (the setpoint of
    a constant input, per cell) may be scalars or (B,) arrays. `device`
    and `dtype` default to the model's. `route` selects the Newton-matrix
    assembly and factorization (``ops.plan.Route``; default: the
    PETLION_* environment variables, as in the JAX package). Returns
    RunResultDev with a leading cells axis on every field.
    """
    dtype = p.dtype if dtype is None else dtype
    dev = resolve_device(p.device if device is None else device, dtype)
    kw = dict(dtype=dtype, device=dev)

    if theta_batch:
        sizes = {int(np.shape(v)[0]) for v in theta_batch.values()}
        if len(sizes) != 1:
            raise ValueError("inconsistent batch sizes in theta_batch")
        B = sizes.pop()
    elif n_cells is not None:
        B = int(n_cells)
    else:
        raise ValueError("need n_cells or theta_batch")

    th = {k: v.to(**kw).reshape(1, 1).expand(B, 1) for k, v in p.theta.items()}
    for k, v in (theta_batch or {}).items():
        th[k] = torch.as_tensor(np.asarray(v, dtype=np.float64), **kw).reshape(B, 1)

    tstops_in = kwargs.pop("tstops", None)
    tdiscon_in = kwargs.pop("tdiscon", None)

    bdict = events.bounds_dict(p.bounds)
    for k in events.BOUND_KEYS:
        if k in kwargs:
            bdict[k] = kwargs.pop(k)
    bounds = {k: torch.as_tensor(np.asarray(v, dtype=np.float64), **kw)
              .expand(B).contiguous() for k, v in bdict.items()}

    opts = p.opts
    overrides = {k: kwargs.pop(k) for k in list(kwargs) if k in _OPT_KEYS}
    if overrides:
        opts = opts.replace(**overrides)
    _, spec, value, is_rest, is_th = _build_control(p, None, kwargs)
    if kwargs:
        raise TypeError(f"unknown keyword arguments: {sorted(kwargs)}")

    if value_batch is not None:
        value = torch.as_tensor(np.asarray(value_batch, dtype=np.float64), **kw)
    value = torch.as_tensor(value, **kw).expand(B).contiguous()

    soc0 = torch.as_tensor(np.asarray(p.opts.SOC if SOC is None else SOC,
                                      dtype=np.float64), **kw)
    soc0 = soc0.expand(B).contiguous()

    parts = []
    if tstops_in is not None:
        parts.append(_stop_times(tstops_in, kw))
    if tdiscon_in is not None:
        parts.append(_stop_times(tdiscon_in, kw) - opts.reltol / 2)
    parts = [a.expand(B, -1) if a.ndim == 1 else a for a in parts]
    if any(a.ndim != 2 or a.shape[0] != B for a in parts):
        raise ValueError(f"tstops/tdiscon: need (K,) or ({B}, K), got "
                         f"{[tuple(a.shape) for a in parts]}")
    tstops = torch.cat(parts, dim=-1) if parts else None

    with torch.no_grad():
        y_start = initial_guess(soc0, th, p.cfg)
        plan = get_plan(p.cfg, p.theta_floats(), route)
        return run_once(y_start=y_start, soc0=soc0, value=value, tf=tf, th=th,
                        bounds=bounds, cfg=p.cfg, spec=spec, opts=opts,
                        jac_plan=plan, is_rest=is_rest,
                        is_temperature_hold=is_th, tstops=tstops)


def _stop_times(ts, kw):
    """Stop times as a (K,) or (B, K) tensor in the run's dtype."""
    return torch.atleast_1d(torch.as_tensor(np.asarray(ts, dtype=np.float64), **kw))

"""User-facing protocol entry points: one cell or a batch of cells through
a multi-segment protocol (counterpart of the JAX package's
``protocols.py``).

    sol = simulate_protocol(p, [
        dict(I=4, V_max=4.1, T_max=313.15),
        dict(dT="hold", V_max=4.1),
        dict(V="hold"),
    ], SOC=0.0)

runs the thermal CC-CT-CV fast charge of one cell; `batch_protocol` runs a
protocol over a batch of cells with per-cell θ, each cell switching segment
at its own time, the segments in lockstep (``solver/protocol.py``).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from .ops.plan import Route, get_plan
from .parallel.batch import _mesh_device, cell_theta, cell_values, run_split
from .physics.initial_guess import initial_guess
from .sim import _OPT_KEYS, Model, append_run, resolve_device
from .solution import Solution
from .solver.protocol import build_segments, protocol_core


def _prep(p: Model, segment_dicts, opts_overrides):
    ov = {k: v for k, v in opts_overrides.items() if k in _OPT_KEYS}
    unknown = set(opts_overrides) - set(ov)
    if unknown:
        raise TypeError(f"unknown keyword arguments: {sorted(unknown)}")
    opts = p.opts.replace(**ov) if ov else p.opts
    return (opts,) + build_segments(p, segment_dicts)


def _run(p, segment_dicts, th, soc0, opts_overrides, fast_solver, route):
    """Every segment over the cells of `th` (B, 1) from SOC `soc0` (B,), on
    soc0's device."""
    opts, segments, values, tfs, bounds_list = _prep(p, segment_dicts,
                                                     opts_overrides)
    B = soc0.shape[0]
    kw = dict(dtype=soc0.dtype, device=soc0.device)
    bounds_list = tuple({k: cell_values(v, B, kw) for k, v in b.items()}
                        for b in bounds_list)
    with torch.no_grad():
        y0 = initial_guess(soc0, th, p.cfg)
        plan = get_plan(p.cfg, p.theta_floats(), route) if fast_solver else None
        results = protocol_core(y0, soc0, values, tfs, th, bounds_list, p.cfg,
                                segments, opts, plan)
    return opts, segments, results


def simulate_protocol(p: Model, segment_dicts, *, SOC: Optional[float] = None,
                      fast_solver: bool = True,
                      dtype: Optional[torch.dtype] = None, device=None,
                      route: Optional[Route] = None,
                      **opts_overrides) -> Solution:
    """Run a multi-segment protocol on one cell: a Solution with one
    RunResult per segment (T in kelvin, as `simulate`'s). `dtype` and
    `device` default to the model's; `route` selects the Newton-matrix
    assembly and factorization (``ops.plan.Route``; default: the PETLION_*
    environment variables); `fast_solver` False takes the dense route (the
    dense Jacobian and the equilibrated pivoted LU, no plan)."""
    dtype = p.dtype if dtype is None else dtype
    dev = resolve_device(p.device if device is None else device, dtype)
    kw = dict(dtype=dtype, device=dev)
    th = cell_theta(p, None, 1, kw)
    soc0 = cell_values(p.opts.SOC if SOC is None else SOC, 1, kw)
    opts, segments, results = _run(p, segment_dicts, th, soc0, opts_overrides,
                                   fast_solver, route)

    sol = Solution()
    t_offset = 0.0
    for k, (seg, res) in enumerate(zip(segments, results)):
        h, meta = append_run(sol, res, p, seg.spec.method, seg.value_mode, t_offset)
        if meta["truncated"]:
            warnings.warn(
                f"protocol segment {k} accepted {meta['n_steps']} steps but "
                f"max_save={opts.max_save} output slots: the recorded tail "
                f"was overwritten (raise max_save= to keep everything)")
        t_offset += float(h["t_final"]) + 1e-12
    sol._outputs = opts.outputs
    return sol


def batch_protocol(p: Model, segment_dicts, *,
                   theta_batch: Optional[dict] = None,
                   n_cells: Optional[int] = None,
                   SOC=None, mesh=None, axis_name: str = "cells",
                   fast_solver: bool = True,
                   dtype: Optional[torch.dtype] = None, device=None,
                   route: Optional[Route] = None, **opts_overrides) -> list:
    """A protocol over a batch of cells: θ from `theta_batch` (a leading
    cells axis per entry) or `n_cells` copies of the model's, SOC a number
    or one per cell. Returns the per-segment list of RunResultDev, each with
    a leading cells axis (y_final is the solver's state: with the thermal
    model its T block is T − T_amb). `mesh` (``make_cell_mesh``, its axis
    named `axis_name`) splits the cells as in ``batch_simulate``: one
    contiguous shard a mesh device, each from a host thread of its own, the
    segments' results concatenated on the mesh's first device."""
    dtype = p.dtype if dtype is None else dtype
    if mesh is not None:
        device = _mesh_device(mesh, axis_name, device)
    dev = resolve_device(p.device if device is None else device, dtype)
    kw = dict(dtype=dtype, device=dev)
    th = cell_theta(p, theta_batch, n_cells, kw)
    soc0 = cell_values(p.opts.SOC if SOC is None else SOC, th["l_p"].shape[0], kw)

    def go(c):
        return _run(p, segment_dicts, c["th"], c["soc0"], opts_overrides,
                    fast_solver, route)[2]
    if mesh is None:
        return go(dict(th=th, soc0=soc0))
    plan = get_plan(p.cfg, p.theta_floats(), route) if fast_solver else None
    return run_split(mesh, go, dict(th=th, soc0=soc0), plan)

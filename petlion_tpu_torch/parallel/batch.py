"""Batched simulation over cells (counterpart of the JAX package's
``parallel/batch.py``: ``batch_simulate``, ``batch_cost_analysis``,
``make_cell_mesh``).

The JAX package vmaps a single-cell run; here the run itself is batch-first
(solver/run.py), so a fleet of cells is one call whose tensors carry a
leading cells axis. Cells never couple.

Where the JAX package shards the cells axis over a ``jax.sharding.Mesh``,
the port cuts it into contiguous equal shards, one per device of a
``CellMesh``, and runs each shard on its device from a host thread of its
own; the shards' results are concatenated along the cells axis on the
mesh's first device. A device may appear more than once in a mesh (the
stand-in for the JAX tests' virtual CPU devices).
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import cost
from ..ops.plan import Route, get_plan
from ..physics.initial_guess import initial_guess
from ..sim import Model, _OPT_KEYS, _build_control, resolve_device
from ..solver import events
from ..solver import run as runner
from ..solver.run import RunResultDev, run_once


class CellMesh(NamedTuple):
    """Devices the cells axis is split over, in shard order, and the axis's
    name (``make_cell_mesh``)."""
    devices: tuple
    axis_name: str = "cells"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_cell_mesh(axis_name: str = "cells", devices=None) -> CellMesh:
    """A 1-D mesh of `devices` (default: every visible CUDA device) for
    splitting a batch's cells. A device may repeat: each entry is one shard.
    Raises when no CUDA device is visible and none is given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_cell_mesh: no CUDA device is visible; pass "
                               "devices= (e.g. ['cpu', 'cpu']) to split over others")
        devices = range(torch.cuda.device_count())
    devs = []
    for d in devices:
        d = torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        devs.append(d)
    if not devs:
        raise ValueError("make_cell_mesh: no devices")
    return CellMesh(tuple(devs), axis_name)


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
                   y_start=None,
                   fast_solver: bool = True,
                   mesh: Optional[CellMesh] = None,
                   axis_name: str = "cells",
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
    PETLION_* environment variables, as in the JAX package). `y_start`
    (B, N) continues from the solver's own states, such as an earlier
    result's ``y_final`` (with the thermal model their T block is
    T − T_amb), with that result's ``soc_final`` as SOC: a long run in
    chunks. `fast_solver` False takes the dense route (the dense Jacobian
    and the equilibrated pivoted LU, no plan; `route` does not apply).
    `mesh` (``make_cell_mesh``, its axis named `axis_name`) splits the
    cells into one contiguous shard per mesh device, each run from a host
    thread of its own (B must divide by the mesh's size; `device` is the
    mesh's). Returns RunResultDev with a leading cells axis on every field
    (with `mesh`, on the mesh's first device).
    """
    dtype = p.dtype if dtype is None else dtype
    if mesh is not None:
        device = _mesh_device(mesh, axis_name, device)
    dev = resolve_device(p.device if device is None else device, dtype)
    kw = dict(dtype=dtype, device=dev)

    th = cell_theta(p, theta_batch, n_cells, kw)
    B = th["l_p"].shape[0]

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

    soc0 = cell_values(p.opts.SOC if SOC is None else SOC, B, kw)

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
        if y_start is None:
            y_start = initial_guess(soc0, th, p.cfg)
        else:
            y_start = torch.as_tensor(y_start, **kw).reshape(B, -1)
    plan = get_plan(p.cfg, p.theta_floats(), route) if fast_solver else None
    cells = dict(y_start=y_start, soc0=soc0, value=value, th=th, bounds=bounds,
                 tstops=tstops)

    def go(c):
        return run_once(**c, tf=tf, cfg=p.cfg, spec=spec, opts=opts, jac_plan=plan,
                        is_rest=is_rest, is_temperature_hold=is_th)
    if mesh is not None:
        return run_split(mesh, go, cells, plan)
    with torch.no_grad():
        return go(cells)


def batch_cost_analysis(p: Model, tf: float = 1e6, **kwargs) -> dict:
    """Operations and bytes of one trip of the host loop (one BDF attempt
    with its Newton iterations and its factorization, over the whole batch):
    the first trip after consistent initialization of
    ``batch_simulate(p, tf, **kwargs)``, which stops there.

    Returns XLA's key names, ``"flops"`` and ``"bytes accessed"``, beside
    ``"ops"`` (aten ops dispatched: the trip's eager launches and host ops)
    and ``"kernels"`` ({name: {launches, flops, bytes}} of the hand-written
    kernels in the trip, each launch by its formula in ``ops/cost.py``).
    Counting rules: ``ops.cost.Counter``. A trip counts the same on the CPU
    (where plain versions stand in for the kernels) and on the card.
    Multiply by the run's trips to estimate a run's work."""
    if kwargs.get("mesh") is not None:
        raise ValueError("batch_cost_analysis counts one batch on one device: drop mesh=")
    counter = cost.Counter()
    counting = [False]

    def at_trip(i):
        counting[0] = i == 0
        if i == 0:
            counter.__enter__()
        else:
            counter.__exit__(None, None, None)
            raise _TripCounted

    runner._TRIP_HOOK.fn = at_trip
    try:
        batch_simulate(p, tf, **kwargs)
    except _TripCounted:
        return counter.result()
    finally:
        runner._TRIP_HOOK.fn = None
        if counting[0]:
            counter.__exit__(None, None, None)
    raise ValueError("batch_cost_analysis: the run ended before its first trip")


class _TripCounted(Exception):
    """Ends the run that batch_cost_analysis counts after its first trip."""


def _mesh_device(mesh: CellMesh, axis_name: str, device):
    """The device a split run's inputs are made on: the mesh's first."""
    if not isinstance(mesh, CellMesh):
        raise TypeError(f"mesh= takes a make_cell_mesh() mesh, got {type(mesh).__name__}")
    if mesh.axis_name != axis_name:
        raise ValueError(f"mesh axis {mesh.axis_name!r} is not axis_name {axis_name!r}")
    if device is not None:
        raise ValueError("give mesh= or device=, not both")
    return mesh.devices[0]


def run_split(mesh: CellMesh, run, cells: dict, plan=None):
    """`run(shard)` on each of the mesh's devices, each from a host thread of
    its own: `cells` is a dict (nested dicts allowed, None kept) of tensors
    with a leading cells axis, cut into contiguous equal shards moved to
    their devices. The plan's device tables and the kernels' libraries are
    made before the threads start. Returns the shards' results concatenated
    along the cells axis on the mesh's first device."""
    B = next(x for x in _leaves(cells)).shape[0]
    if B % mesh.size:
        raise ValueError(f"{B} cells do not divide over the mesh's {mesh.size} devices")
    m = B // mesh.size
    shards = [_map(lambda x, i=i, d=d: x[i * m:(i + 1) * m].to(d), cells)
              for i, d in enumerate(mesh.devices)]
    dtype = next(x for x in _leaves(cells) if x.is_floating_point()).dtype
    _prepare(plan, mesh.devices, dtype)
    with ThreadPoolExecutor(max_workers=mesh.size,
                            thread_name_prefix="petlion-shard") as pool:
        futures = [pool.submit(_on_device, d, run, c)
                   for d, c in zip(mesh.devices, shards)]
        results = [f.result() for f in futures]
    return _concat(results, mesh.devices[0])


def _on_device(device, run, cells):
    ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
    with ctx, torch.no_grad():      # grad mode is per thread
        return run(cells)


def _prepare(plan, devices, dtype):
    """Make what the shards' threads would otherwise make at first use."""
    for d in dict.fromkeys(devices):
        if plan is not None:
            plan.prepare(torch.empty(0, dtype=dtype, device=d))
        if d.type == "cuda":
            from ..ops import gj_kernel
            gj_kernel.build()
            if plan is not None and plan.route.blocks:
                from ..ops import gj_blocks
                gj_blocks.build()
            if plan is not None and plan.route.dchain:
                from ..ops import dchain
                dchain.build()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _concat(parts: list, device):
    """The shards' results joined along the cells axis: tensors, dicts,
    lists and (named) tuples of them."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([x.to(device) for x in parts])
    if isinstance(first, dict):
        return {k: _concat([x[k] for x in parts], device) for k in first}
    joined = [_concat(list(xs), device) for xs in zip(*parts)]
    return type(first)(*joined) if hasattr(first, "_fields") else type(first)(joined)


def cell_theta(p: Model, theta_batch: Optional[dict], n_cells: Optional[int],
               kw: dict) -> dict:
    """θ of a batch as (B, 1) tensors: `theta_batch`'s entries (a leading
    cells axis each) over the model's, or the model's for `n_cells`."""
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
    return th


def cell_values(v, B: int, kw: dict):
    """A number or (B,) array as a (B,) tensor."""
    return torch.as_tensor(np.asarray(v, dtype=np.float64), **kw).expand(B).contiguous()


def _stop_times(ts, kw):
    """Stop times as a (K,) or (B, K) tensor in the run's dtype."""
    return torch.atleast_1d(torch.as_tensor(np.asarray(ts, dtype=np.float64), **kw))

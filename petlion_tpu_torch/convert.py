"""Carry a model's parameters across from the JAX package.

`model_from_numpy` takes θ and bounds as plain floats and numpy values and
the options, mesh and numerics as any objects with the same field names (or
dicts), and returns this package's `Model`. Physics closures are matched by function
name against this package's physics modules. Nothing of the JAX package is
imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import Bounds, Discretizations, Numerics, SimOptions
from .physics import kinetics, ocv, transport
from .sim import Model, make_model

_PHYSICS_MODULES = (ocv, kinetics, transport)


def _fields(obj, cls) -> dict:
    names = [f.name for f in dataclasses.fields(cls)]
    if isinstance(obj, dict):
        return {k: obj[k] for k in names if k in obj}
    return {k: getattr(obj, k) for k in names if hasattr(obj, k)}


def _port_function(fn):
    name = fn if isinstance(fn, str) else getattr(fn, "__name__", None)
    for mod in _PHYSICS_MODULES:
        if name and hasattr(mod, name):
            return getattr(mod, name)
    raise NotImplementedError(f"physics function {name!r} is not ported")


def model_from_numpy(theta: dict, bounds, N, numerics, *, opts=None, device,
                     dtype) -> Model:
    """This package's Model from θ (str → float or 0-d numpy), bounds,
    options (default ``SimOptions()``), mesh and numerics given by field
    name."""
    th = {k: float(np.asarray(v)) for k, v in theta.items()}
    b = Bounds(**{k: float(v) for k, v in _fields(bounds, Bounds).items()})
    mesh = Discretizations(**{k: int(v) for k, v in
                              _fields(N, Discretizations).items()})
    nf = _fields(numerics, Numerics)
    for f in dataclasses.fields(Numerics):
        if f.name in nf and callable(f.default):
            nf[f.name] = _port_function(nf[f.name])
    num = Numerics(**nf)
    so = SimOptions(**_fields(opts, SimOptions)) if opts is not None else SimOptions()
    return make_model(th, b, so, mesh, num, device=device, dtype=dtype)

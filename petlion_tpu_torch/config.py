"""Static configuration objects (counterpart of the JAX package's ``config.py``).

* ``Discretizations`` — mesh sizes per section.
* ``Numerics``        — structure-defining physics options, including the
  swappable physics closures (OCV curves, kinetics, transport) as plain
  torch functions.
* ``SimOptions``      — per-simulation solver options.
* ``Bounds``          — stop conditions; NaN deactivates a bound.

The field names, defaults and exit codes are those of the JAX package, so a
configuration carries across by name (see ``convert.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

from .physics import kinetics as _kinetics
from .physics import ocv as _ocv
from .physics import transport as _transport


@dataclasses.dataclass(frozen=True)
class Discretizations:
    """Mesh sizes per cell section."""

    p: int = 10       # cathode volumes
    s: int = 10       # separator volumes
    n: int = 10       # anode volumes
    a: int = 10       # positive current collector (temperature only)
    z: int = 10       # negative current collector (temperature only)
    r_p: int = 10     # cathode particle radial nodes (Fickian only)
    r_n: int = 10     # anode particle radial nodes (Fickian only)


@dataclasses.dataclass(frozen=True)
class Numerics:
    """Structure-defining options. Hash/eq compare the closures by identity,
    so a configuration is a usable cache key."""

    temperature: bool = False
    solid_diffusion: str = "Fickian"      # "Fickian" | "quadratic" | "polynomial"
    Fickian_method: str = "finite_difference"  # | "spectral"
    aging: Optional[str] = None           # None | "SEI" | "stress"
    cathode: str = "LCO"
    anode: str = "LiC6"
    rxn_p: Callable = _kinetics.rxn_BV
    rxn_n: Callable = _kinetics.rxn_BV
    OCV_p: Callable = _ocv.OCV_LCO
    OCV_n: Callable = _ocv.OCV_LiC6
    D_s_eff: Callable = _transport.D_s_eff
    rxn_rate: Callable = _transport.rxn_rate
    D_eff: Callable = _transport.D_eff_linear
    K_eff: Callable = _transport.K_eff
    thermodynamic_factor: Callable = _transport.thermodynamic_factor_linear

    def __post_init__(self):
        if self.solid_diffusion not in ("Fickian", "quadratic", "polynomial"):
            raise ValueError(f"solid_diffusion={self.solid_diffusion!r}")
        if self.Fickian_method not in ("finite_difference", "spectral"):
            raise ValueError(f"Fickian_method={self.Fickian_method!r}")
        if self.aging not in (None, "SEI", "stress"):
            raise ValueError(f"aging={self.aging!r}")


@dataclasses.dataclass(frozen=True)
class Bounds:
    """Stop conditions; NaN disables a bound.

    Flag codes: 0 t>=tf, 1 V_min, 2 V_max, 3 SOC_min, 4 SOC_max, 5 T_max,
    6 c_s_n_max, 7 I_max, 8 I_min, 9 c_e_min, 10 dfilm_max,
    11 eta_plating_min.
    """

    V_max: float = math.nan
    V_min: float = math.nan
    SOC_max: float = math.nan
    SOC_min: float = math.nan
    T_max: float = math.nan
    c_s_n_max: float = math.nan     # fraction of c_max_n
    I_max: float = math.nan         # C-rate
    I_min: float = math.nan         # C-rate
    eta_plating_min: float = math.nan
    c_e_min: float = math.nan
    dfilm_max: float = math.nan

    def replace(self, **kw) -> "Bounds":
        return dataclasses.replace(self, **kw)


EXIT_REASONS: Tuple[str, ...] = (
    "Final time reached",              # 0
    "Below min. voltage",              # 1
    "Above max. voltage",              # 2
    "Below min. SOC",                  # 3
    "Above max. SOC",                  # 4
    "Above max. temperature",          # 5
    "Above max. c_s_n",                # 6
    "Above max. C-rate",               # 7
    "Below min. C-rate",               # 8
    "Below min. c_e",                  # 9
    "Above max. film growth rate",     # 10
    "Below min. η_plating",            # 11
    "Stop function triggered",         # 12
)
EXIT_SIMULATING = -1          # run still within bounds
EXIT_FAILED = -2              # integrator failure (Newton/maxiters)


@dataclasses.dataclass(frozen=True)
class SimOptions:
    """Per-run solver options (same fields and defaults as the JAX package;
    the options this slice does not implement raise where they are read)."""

    SOC: float = 1.0
    outputs: Tuple[str, ...] = ("t", "V")
    abstol: float = 1e-6
    reltol: float = 1e-3
    abstol_init: Optional[float] = None
    reltol_init: Optional[float] = None
    abstol_T: Optional[float] = None
    maxiters: int = 10_000
    check_bounds: bool = True
    reinit: bool = True
    verbose: bool = False
    interp_final: bool = True
    interp_bc: str = "interpolate"
    save_start: bool = False
    stop_function: Optional[Callable] = None
    max_order: int = 5
    max_save: int = 1024
    newton_maxiter: int = 4
    jac_reuse: int = 0
    step_control: str = "greedy"
    init_maxiter: int = 100
    dt0: Optional[float] = None
    dtmax: Optional[float] = None

    def __post_init__(self):
        # outputs may be given as one name or a list; stored as a tuple
        o = self.outputs
        object.__setattr__(self, "outputs", (o,) if isinstance(o, str) else tuple(o))

    @property
    def abstol_init_(self) -> float:
        return self.abstol if self.abstol_init is None else self.abstol_init

    @property
    def reltol_init_(self) -> float:
        return self.reltol if self.reltol_init is None else self.reltol_init

    def replace(self, **kw) -> "SimOptions":
        return dataclasses.replace(self, **kw)

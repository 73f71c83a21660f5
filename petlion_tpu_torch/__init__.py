"""petlion_tpu_torch — the PyTorch/CUDA port of the JAX P2D battery
simulation package that sits beside it as its reference.

Same module names as the JAX package; batch-first tensors throughout, with
the JAX package's three TPU kernels as CUDA kernels (`csrc/`: the
Gauss-Jordan inverse, the stacked small inverses and the fused nested Schur
chain; bound in `ops/gj_kernel.py`, `ops/gj_blocks.py`, `ops/dchain.py`).
Entry points run on CUDA unless the caller passes ``device="cpu"``.

    p   = petlion(LCO)                          # on CUDA, float64
    sol = simulate(p, I=-1, SOC=1)              # one cell → Solution
    res = batch_simulate(p, 3.9e3, I=-1, SOC=1, theta_batch={...})
    sol = simulate_protocol(p, [dict(I=2, V_max=4.1), dict(V="hold")], SOC=0)
    rs  = batch_protocol(p, [...], SOC=0, theta_batch={...})  # per segment
    J, th0 = estimation.sensitivities(p, ["D_sp"], t, I_crate=-1)  # ∂V/∂θ
    res = batch_simulate(p, ..., mesh=make_cell_mesh())   # cells over cards
    batch_cost_analysis(p, 3.9e3, I=-1, SOC=1, n_cells=64)  # one trip's work
"""

from .chemistry import LCO, NMC, NMC_LGM50
from .config import (Bounds, Discretizations, EXIT_REASONS, Numerics,
                     SimOptions)
from .convert import model_from_numpy
from .layout import StateLayout
from .physics import kinetics, ocv, transport
from .physics.kinetics import rxn_BV, rxn_MHC, rxn_BV_gamma_mod_01, MHC_kfunc
from .physics.ocv import (OCV_LCO, OCV_LiC6, OCV_NMC, OCV_LiC6_with_NMC,
                          OCV_NMC_LGM50, OCV_LiC6_LGM50)
from .physics.transport import (D_s_eff, D_s_eff_isothermal, rxn_rate,
                                rxn_rate_isothermal, D_eff, D_eff_linear,
                                D_eff_linear_one_term, K_eff, K_eff_isothermal,
                                thermodynamic_factor,
                                thermodynamic_factor_linear)
from .parallel.batch import batch_cost_analysis, batch_simulate, make_cell_mesh
from .physics.residuals import ModelConfig, calc_I1C, residual_core
from .protocols import batch_protocol, simulate_protocol
from .sim import (Model, calc_OCV, calc_R_internal, default_dtype, petlion,
                  simulate, simulate_cont)
from .solution import RunResult, Solution, reset_t
from . import estimation


__version__ = "0.1.0"


def final_exit_reason(sol: Solution) -> str:
    return sol.final_exit_reason()


def exit_reasons(sol: Solution):
    return sol.exit_reasons()


__all__ = [
    "LCO", "NMC", "NMC_LGM50", "Bounds", "Discretizations", "EXIT_REASONS", "Numerics",
    "SimOptions", "model_from_numpy", "StateLayout", "batch_simulate",
    "ModelConfig", "calc_I1C", "residual_core", "Model", "petlion",
    "simulate", "simulate_cont", "Solution", "RunResult", "reset_t",
    "final_exit_reason", "exit_reasons", "calc_OCV", "calc_R_internal",
    "rxn_BV", "rxn_MHC", "rxn_BV_gamma_mod_01", "MHC_kfunc",
    "OCV_LCO", "OCV_LiC6", "OCV_NMC", "OCV_LiC6_with_NMC", "OCV_NMC_LGM50",
    "OCV_LiC6_LGM50", "D_s_eff", "D_s_eff_isothermal", "rxn_rate",
    "rxn_rate_isothermal", "D_eff", "D_eff_linear", "D_eff_linear_one_term",
    "K_eff", "K_eff_isothermal", "thermodynamic_factor",
    "thermodynamic_factor_linear", "kinetics", "ocv", "transport",
    "simulate_protocol", "batch_protocol", "default_dtype", "estimation",
    "batch_cost_analysis", "make_cell_mesh",
]

# the JAX package's reference-name aliases, for what is ported
boundary_stop_conditions = Bounds
options_simulation = SimOptions
discretizations_per_section = Discretizations
options_numerical = Numerics
rxn_BV_gamma_mod = rxn_BV_gamma_mod_01
solution = Solution
Params = petlion
run_model = simulate
run_model_cont = simulate_cont
options_model = SimOptions
model_output = Solution

__all__ += [
    "boundary_stop_conditions", "options_simulation",
    "discretizations_per_section", "options_numerical",
    "rxn_BV_gamma_mod", "solution",
    "Params", "run_model", "run_model_cont", "options_model", "model_output",
]

"""Built-in chemistry parameter sets (counterpart of
the JAX package's ``chemistry/cells.py``; LCO/LiC6 only in this package so far).

A chemistry is a function returning ``(theta, bounds, opts, N, numerics)``
for the user-facing mesh/numerics kwargs. θ values are plain floats; the
model factory turns them into tensors on the run's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..config import Bounds, Discretizations, Numerics, SimOptions
from ..physics import kinetics, ocv, transport


def _mesh(N_p, N_s, N_n, N_a, N_z, N_r_p, N_r_n):
    return Discretizations(p=N_p, s=N_s, n=N_n, a=N_a, z=N_z, r_p=N_r_p, r_n=N_r_n)


def LCO(
    *,
    SOC: float = 1.0,
    N_p=10, N_s=10, N_n=10, N_a=10, N_z=10, N_r_p=10, N_r_n=10,
    temperature: bool = False,
    solid_diffusion: str = "Fickian",
    Fickian_method: str = "finite_difference",
    aging: Optional[str] = None,
    anode: str = "LiC6",
    D_s_eff: Callable = transport.D_s_eff,
    rxn_rate: Callable = transport.rxn_rate,
    D_eff: Callable = transport.D_eff_linear,
    K_eff: Callable = transport.K_eff,
    thermodynamic_factor: Callable = transport.thermodynamic_factor_linear,
    rxn_p: Callable = kinetics.rxn_BV,
    rxn_n: Callable = kinetics.rxn_BV,
    OCV_p: Callable = ocv.OCV_LCO,
    OCV_n: Callable = ocv.OCV_LiC6,
):
    if anode != "LiC6":
        raise NotImplementedError(
            f"LCO(anode={anode!r}): only the LiC6 anode is ported")
    theta: Dict[str, float] = {
        # cathode (LCO)
        "D_sp": 1e-14, "D_p": 7.5e-10, "k_p": 2.334e-11,
        "lambda_MHC_p": 6.26e-20,
        "theta_min_p": 0.99174, "theta_max_p": 0.49550,
        "l_p": 80e-6, "sigma_p": 100.0, "eps_p": 0.385, "eps_fp": 0.025,
        "brugg_p": 4.0, "c_max_p": 51554.0, "Rp_p": 2e-6,
        "lam_p": 2.1, "rho_p": 2500.0, "Cp_p": 700.0,
        "Ea_D_sp": 5000.0, "Ea_k_p": 5000.0,
        # anode (LiC6)
        "D_sn": 3.9e-14, "D_n": 7.5e-10, "k_n": 5.0310e-11,
        "lambda_MHC_n": 6.26e-20,
        "theta_max_n": 0.85510, "theta_min_n": 0.01429,
        "l_n": 88e-6, "sigma_n": 100.0, "eps_n": 0.485, "eps_fn": 0.0326,
        "brugg_n": 4.0, "c_max_n": 30555.0, "Rp_n": 2e-6,
        "lam_n": 1.7, "rho_n": 2500.0, "Cp_n": 700.0,
        "Ea_D_sn": 5000.0, "Ea_k_n": 5000.0,
        # aging
        "R_SEI": 0.01, "M_n": 7.3e-4, "k_n_aging": 1.0,
        "i_0_jside": 1.5e-6, "Uref_s": 0.4, "w": 2.0,
        # system
        "D_s": 7.5e-10,
        "l_s": 25e-6, "l_a": 10e-6, "l_z": 10e-6,
        "sigma_a": 3.55e7, "sigma_z": 5.96e7,
        "eps_s": 0.724, "brugg_s": 4.0, "t_plus": 0.364,
        "c_e0": 1000.0, "T0": 298.15, "T_amb": 298.15,
        "lam_s": 0.16, "lam_a": 237.0, "lam_z": 401.0,
        "rho_s": 1100.0, "rho_a": 2700.0, "rho_z": 8940.0,
        "Cp_s": 700.0, "Cp_a": 897.0, "Cp_z": 385.0,
        "h_cell": 1.0,
    }
    bounds = Bounds(V_min=2.5, V_max=4.3, SOC_min=0.0, SOC_max=1.0,
                    T_max=55 + 273.15)
    opts = SimOptions(SOC=SOC, outputs=("t", "V"), abstol=1e-6, reltol=1e-3)
    N = _mesh(N_p, N_s, N_n, N_a, N_z, N_r_p, N_r_n)
    numerics = Numerics(
        temperature=temperature, solid_diffusion=solid_diffusion,
        Fickian_method=Fickian_method, aging=aging,
        cathode="LCO", anode="LiC6",
        rxn_p=rxn_p, rxn_n=rxn_n, OCV_p=OCV_p, OCV_n=OCV_n,
        D_s_eff=D_s_eff, rxn_rate=rxn_rate, D_eff=D_eff, K_eff=K_eff,
        thermodynamic_factor=thermodynamic_factor,
    )
    return theta, bounds, opts, N, numerics

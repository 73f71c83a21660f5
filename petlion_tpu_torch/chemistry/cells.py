"""Built-in chemistry parameter sets (counterpart of
the JAX package's ``chemistry/cells.py``: LCO/LiC6, NMC/LiC6 and
NMC_LGM50/LiC6_LGM50, each of LCO and NMC_LGM50 also as a half cell on a
lithium-foil anode).

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


def Li_metal_theta():
    """Lithium-foil anode parameter set."""
    return {
        "D_sn": 0.0, "k_n": 1e-4, "lambda_MHC_n": 0.0,
        "theta_max_n": 0.0, "theta_min_n": 1.0,
        "l_n": 25e-6, "sigma_n": 1e6, "eps_n": 0.25, "eps_fn": 0.0,
        "brugg_n": 1.5, "c_max_n": 33133.0, "Rp_n": 5.86e-6,
        "lam_n": 1.7, "rho_n": 1657.0, "Cp_n": 700.0,
        "Ea_D_sn": 3.03e4, "Ea_k_n": 35000.0,
        "c_EC_bulk_n": 4541.0, "delta0": 5e-9, "Vbar_SEI": 9.585e-5,
        "alpha_SEI": 0.5, "R_SEI": 2e5, "E_n": 15e9, "nu_n": 0.2,
        "Omega_n": 3.1e-6, "sigma_critical_n": 60e6, "U_SEI": 0.4,
        "k_SEI": 1e-17, "D_SEI": 2e-18,
    }


def _li_metal_overlay(theta: dict):
    """Overlay the foil-anode θ for the half cell, with the values that make
    it a runnable configuration (as the JAX package does): the foil has the
    full stoichiometric range (θ_min_n, θ_max_n = 0, 1), the molar density
    of lithium metal as c_max_n (76945 mol/m³, so the 1C rate is cathode
    limited) and no electrolyte inside the foil (eps_n = 0)."""
    theta.update(Li_metal_theta())
    theta.update({
        "theta_max_n": 1.0, "theta_min_n": 0.0,
        "c_max_n": 76945.0,
        "eps_n": 0.0, "eps_fn": 0.0,
    })


def LCO(
    *,
    SOC: float = 1.0,
    N_p=10, N_s=10, N_n=10, N_a=10, N_z=10, N_r_p=10, N_r_n=10,
    temperature: bool = False,
    solid_diffusion: str = "Fickian",
    Fickian_method: str = "finite_difference",
    aging: Optional[str] = None,
    anode: str = "LiC6",          # "LiC6" | "Li_metal" (half cell)
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
    if anode == "Li_metal":
        _li_metal_overlay(theta)
        OCV_n = ocv.OCV_Li_metal
    bounds = Bounds(V_min=2.5, V_max=4.3, SOC_min=0.0, SOC_max=1.0,
                    T_max=55 + 273.15)
    opts = SimOptions(SOC=SOC, outputs=("t", "V"), abstol=1e-6, reltol=1e-3)
    N = _mesh(N_p, N_s, N_n, N_a, N_z, N_r_p, N_r_n)
    numerics = Numerics(
        temperature=temperature, solid_diffusion=solid_diffusion,
        Fickian_method=Fickian_method, aging=aging,
        cathode="LCO", anode=anode if anode == "Li_metal" else "LiC6",
        rxn_p=rxn_p, rxn_n=rxn_n, OCV_p=OCV_p, OCV_n=OCV_n,
        D_s_eff=D_s_eff, rxn_rate=rxn_rate, D_eff=D_eff, K_eff=K_eff,
        thermodynamic_factor=thermodynamic_factor,
    )
    return theta, bounds, opts, N, numerics


def NMC(
    *,
    SOC: float = 1.0,
    N_p=10, N_s=10, N_n=10, N_a=10, N_z=10, N_r_p=10, N_r_n=10,
    temperature: bool = False,
    solid_diffusion: str = "Fickian",
    Fickian_method: str = "finite_difference",
    aging: Optional[str] = None,
    D_s_eff: Callable = transport.D_s_eff,
    rxn_rate: Callable = transport.rxn_rate,
    D_eff: Callable = transport.D_eff,
    K_eff: Callable = transport.K_eff,
    thermodynamic_factor: Callable = transport.thermodynamic_factor_linear,
    rxn_p: Callable = kinetics.rxn_BV,
    rxn_n: Callable = kinetics.rxn_BV,
    OCV_p: Callable = ocv.OCV_NMC,
    OCV_n: Callable = ocv.OCV_LiC6_with_NMC,
):
    theta: Dict[str, float] = {
        # cathode (NMC)
        "D_sp": 2e-14, "k_p": 6.3066e-10,
        "theta_min_p": 0.955473, "theta_max_p": 0.359749,
        "l_p": 41.6e-6, "sigma_p": 100.0, "eps_p": 0.3, "eps_fp": 0.12,
        "brugg_p": 1.5, "c_max_p": 51830.0, "Rp_p": 7.5e-6,
        "Ea_D_sp": 2.5e4, "Ea_k_p": 3e4,
        # anode (LiC6)
        "D_sn": 1.5e-14, "k_n": 6.3466e-10,
        "theta_max_n": 0.790813, "theta_min_n": 0.001,
        "l_n": 48e-6, "sigma_n": 100.0, "eps_n": 0.3, "eps_fn": 0.038,
        "brugg_n": 1.5, "c_max_n": 31080.0, "Rp_n": 10e-6,
        "Ea_D_sn": 4e4, "Ea_k_n": 3e4,
        # SEI aging, the LiC6 values of the LCO cell
        "R_SEI": 0.01, "M_n": 7.3e-4, "k_n_aging": 1.0,
        "i_0_jside": 1.5e-6, "Uref_s": 0.4, "w": 2.0, "rho_n": 2500.0,
        # system
        "l_s": 25e-6, "eps_s": 0.4, "brugg_s": 1.5, "t_plus": 0.38,
        "c_e0": 1200.0, "T0": 298.15, "T_amb": 298.15,
    }
    bounds = Bounds(V_min=2.8, V_max=4.2, SOC_min=0.0, SOC_max=1.0)
    opts = SimOptions(SOC=SOC, outputs=("t", "V"), abstol=1e-6, reltol=1e-3)
    N = _mesh(N_p, N_s, N_n, N_a, N_z, N_r_p, N_r_n)
    numerics = Numerics(
        temperature=temperature, solid_diffusion=solid_diffusion,
        Fickian_method=Fickian_method, aging=aging,
        cathode="NMC", anode="LiC6_NMC",
        rxn_p=rxn_p, rxn_n=rxn_n, OCV_p=OCV_p, OCV_n=OCV_n,
        D_s_eff=D_s_eff, rxn_rate=rxn_rate, D_eff=D_eff, K_eff=K_eff,
        thermodynamic_factor=thermodynamic_factor,
    )
    return theta, bounds, opts, N, numerics


def NMC_LGM50(
    *,
    SOC: float = 1.0,
    N_p=10, N_s=10, N_n=10, N_a=10, N_z=10, N_r_p=10, N_r_n=10,
    temperature: bool = True,
    solid_diffusion: str = "Fickian",
    Fickian_method: str = "finite_difference",
    aging: Optional[str] = None,
    anode: str = "LiC6_LGM50",     # | "Li_metal" (half cell)
    D_s_eff: Callable = transport.D_s_eff,
    rxn_rate: Callable = transport.rxn_rate,
    D_eff: Callable = transport.D_eff_LGM50,
    K_eff: Callable = transport.K_eff_LGM50,
    thermodynamic_factor: Callable = transport.thermodynamic_factor_linear,
    rxn_p: Callable = kinetics.rxn_BV,
    rxn_n: Callable = kinetics.rxn_BV,
    OCV_p: Callable = ocv.OCV_NMC_LGM50,
    OCV_n: Callable = ocv.OCV_LiC6_LGM50,
):
    """The LG M50 cell, thermal by default (``temperature=True``), as in the
    JAX package."""
    theta: Dict[str, float] = {
        # cathode (NMC811)
        "D_sp": 4e-15, "k_p": 3.5445802224420315e-11, "lambda_MHC_p": 0.0,
        "theta_min_p": 0.8395, "theta_max_p": 17038.0 / 63104.0,
        "l_p": 75.6e-6, "sigma_p": 0.18, "eps_p": 0.335, "eps_fp": 0.0,
        "brugg_p": 1.5, "c_max_p": 63104.0, "Rp_p": 5.22e-6,
        "lam_p": 2.1, "rho_p": 3262.0, "Cp_p": 700.0,
        "Ea_D_sp": 0.0, "Ea_k_p": 17800.0,
        # cathode stress
        "E_p": 375e9, "nu_p": 0.3, "Omega_p": -7.28e-7,
        "sigma_critical_p": 375e6,
        # anode (graphite)
        "D_sn": 3.3e-14, "k_n": 6.716046737258585e-12, "lambda_MHC_n": 0.0,
        "theta_max_n": 29866.0 / 33133.0, "theta_min_n": 0.0481727,
        "l_n": 85.2e-6, "sigma_n": 215.0, "eps_n": 0.25, "eps_fn": 0.0,
        "brugg_n": 1.5, "c_max_n": 33133.0, "Rp_n": 5.86e-6,
        "lam_n": 1.7, "rho_n": 1657.0, "Cp_n": 700.0,
        "Ea_D_sn": 3.03e4, "Ea_k_n": 35000.0,
        # anode SEI/stress
        "c_EC_bulk_n": 4541.0, "delta0": 5e-9, "Vbar_SEI": 9.585e-5,
        "alpha_SEI": 0.5, "R_SEI": 2e5, "E_n": 15e9, "nu_n": 0.2,
        "Omega_n": 3.1e-6, "sigma_critical_n": 60e6, "U_SEI": 0.4,
        "k_SEI": 1e-17, "D_SEI": 2e-18,
        # SEI aging dynamics
        "M_n": 7.3e-4, "k_n_aging": 1.0, "i_0_jside": 1.5e-6,
        "Uref_s": 0.4, "w": 2.0,
        # system
        "D_e": 8.794e-11,
        "l_s": 12e-6, "l_a": 16e-6, "l_z": 12e-6,
        "sigma_a": 36.914e6, "sigma_z": 58.41e6,
        "eps_s": 0.47, "brugg_s": 1.5, "t_plus": 0.2594,
        "c_e0": 1000.0, "T0": 298.15, "T_amb": 298.15,
        "lam_s": 0.16, "lam_a": 237.0, "lam_z": 401.0,
        "rho_s": 397.0, "rho_a": 2700.0, "rho_z": 8960.0,
        "Cp_s": 700.0, "Cp_a": 897.0, "Cp_z": 385.0,
        "h_cell": 1.0,
        "m_LAM": 2.0, "beta_LAM": 1.9e-6,
    }
    if anode == "Li_metal":
        _li_metal_overlay(theta)
        OCV_n = ocv.OCV_Li_metal
    bounds = Bounds(V_min=2.5, V_max=4.2, SOC_min=0.0, SOC_max=1.0,
                    T_max=55 + 273.15)
    opts = SimOptions(SOC=SOC, outputs=("t", "V"), abstol=1e-6, reltol=1e-3)
    N = _mesh(N_p, N_s, N_n, N_a, N_z, N_r_p, N_r_n)
    numerics = Numerics(
        temperature=temperature, solid_diffusion=solid_diffusion,
        Fickian_method=Fickian_method, aging=aging,
        cathode="NMC_LGM50", anode=anode,
        rxn_p=rxn_p, rxn_n=rxn_n, OCV_p=OCV_p, OCV_n=OCV_n,
        D_s_eff=D_s_eff, rxn_rate=rxn_rate, D_eff=D_eff, K_eff=K_eff,
        thermodynamic_factor=thermodynamic_factor,
    )
    return theta, bounds, opts, N, numerics

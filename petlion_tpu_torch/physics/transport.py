"""Transport-property closures (counterpart of
the JAX package's ``physics/transport.py``).

Each function takes section-wise ``(B, n)`` tensors plus θ (``(B, 1)``
tensors). The Arrhenius factor is skipped exactly when T == T_ref, so
isothermal runs keep exact parity.
"""

from __future__ import annotations

import torch

from ..constants import IDEAL_GAS as R, T_REF


def _arrhenius(Ea, T):
    """exp(-Ea/R (1/T - 1/T_ref)), with the T==T_ref shortcut."""
    return torch.where(T == T_REF, torch.ones_like(T),
                       torch.exp(-Ea / R * (1.0 / T - 1.0 / T_REF)))


def D_s_eff_isothermal(c_s_p, c_s_n, T_p, T_n, th):
    return (th["D_sp"] * torch.ones_like(T_p), th["D_sn"] * torch.ones_like(T_n))


def D_s_eff(c_s_p, c_s_n, T_p, T_n, th):
    D_sp = th["D_sp"] * _arrhenius(th["Ea_D_sp"], T_p)
    D_sn = th["D_sn"] * _arrhenius(th["Ea_D_sn"], T_n)
    return D_sp, D_sn


def rxn_rate_isothermal(T_p, T_n, c_s_p, c_s_n, th):
    return th["k_p"] * torch.ones_like(T_p), th["k_n"] * torch.ones_like(T_n)


def rxn_rate(T_p, T_n, c_s_p, c_s_n, th):
    k_p = th["k_p"] * _arrhenius(th["Ea_k_p"], T_p)
    k_n = th["k_n"] * _arrhenius(th["Ea_k_n"], T_n)
    return k_p, k_n


def D_eff_linear(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th):
    return (
        th["D_p"] * th["eps_p"] ** th["brugg_p"] * torch.ones_like(c_e_p),
        th["D_s"] * th["eps_s"] ** th["brugg_s"] * torch.ones_like(c_e_s),
        th["D_n"] * th["eps_n"] ** th["brugg_n"] * torch.ones_like(c_e_n),
    )


def D_eff_linear_one_term(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th):
    De = th["D_e"]
    return (
        De * th["eps_p"] ** th["brugg_p"] * torch.ones_like(c_e_p),
        De * th["eps_s"] ** th["brugg_s"] * torch.ones_like(c_e_s),
        De * th["eps_n"] ** th["brugg_n"] * torch.ones_like(c_e_n),
    )


def _D_eff_scalar(c_e, T):
    # empirical correlation
    return 1e-4 * 10.0 ** (-4.43 - 54.0 / (T - 229.0 - 5e-3 * c_e) - 0.22e-3 * c_e)


def D_eff(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th):
    return (
        th["eps_p"] ** th["brugg_p"] * _D_eff_scalar(c_e_p, T_p),
        th["eps_s"] ** th["brugg_s"] * _D_eff_scalar(c_e_s, T_s),
        th["eps_n"] ** th["brugg_n"] * _D_eff_scalar(c_e_n, T_n),
    )


def _D_eff_LGM50_scalar(c_e, T, th):
    x = c_e / 1000.0
    return th["D_e"] * (x * x - 4.516715942688196 * x + 5.5287696156470325)


def D_eff_LGM50(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th):
    return (
        th["eps_p"] ** th["brugg_p"] * _D_eff_LGM50_scalar(c_e_p, T_p, th),
        th["eps_s"] ** th["brugg_s"] * _D_eff_LGM50_scalar(c_e_s, T_s, th),
        th["eps_n"] ** th["brugg_n"] * _D_eff_LGM50_scalar(c_e_n, T_n, th),
    )


def _K_eff_scalar(c_e, T):
    return 1e-4 * c_e * (
        (-10.5 + 0.668e-3 * c_e + 0.494e-6 * c_e**2)
        + (0.074 - 1.78e-5 * c_e - 8.86e-10 * c_e**2) * T
        + (-6.96e-5 + 2.8e-8 * c_e) * T**2
    ) ** 2


def K_eff(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th):
    return (
        th["eps_p"] ** th["brugg_p"] * _K_eff_scalar(c_e_p, T_p),
        th["eps_s"] ** th["brugg_s"] * _K_eff_scalar(c_e_s, T_s),
        th["eps_n"] ** th["brugg_n"] * _K_eff_scalar(c_e_n, T_n),
    )


def _K_eff_iso_scalar(c_e):
    return (4.1253e-2 + 5.007e-4 * c_e - 4.7212e-7 * c_e**2
            + 1.5094e-10 * c_e**3 - 1.6018e-14 * c_e**4)


def K_eff_isothermal(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th):
    return (
        th["eps_p"] ** th["brugg_p"] * _K_eff_iso_scalar(c_e_p),
        th["eps_s"] ** th["brugg_s"] * _K_eff_iso_scalar(c_e_s),
        th["eps_n"] ** th["brugg_n"] * _K_eff_iso_scalar(c_e_n),
    )


def _K_eff_LGM50_scalar(c_e):
    x = c_e / 1000.0
    return 0.1297 * x**3 - 2.51 * x**1.5 + 3.329 * x


def K_eff_LGM50(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th):
    return (
        th["eps_p"] ** th["brugg_p"] * _K_eff_LGM50_scalar(c_e_p),
        th["eps_s"] ** th["brugg_s"] * _K_eff_LGM50_scalar(c_e_s),
        th["eps_n"] ** th["brugg_n"] * _K_eff_LGM50_scalar(c_e_n),
    )


def thermodynamic_factor_linear(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th):
    return (torch.ones_like(c_e_p), torch.ones_like(c_e_s),
            torch.ones_like(c_e_n))


def _tf_scalar(c_e, T):
    x = c_e / 1000.0
    return 0.601 - 0.24 * torch.sqrt(x) + 0.982 * (1 - 0.0052 * (T - 293.0)) * x**1.5


def thermodynamic_factor(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th):
    return (_tf_scalar(c_e_p, T_p), _tf_scalar(c_e_s, T_s), _tf_scalar(c_e_n, T_n))

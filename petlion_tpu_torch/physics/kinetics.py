"""Electrode reaction-rate models (counterpart of
the JAX package's ``physics/kinetics.py``: Butler-Volmer, Marcus-Hush-Chidsey
and the activity-modified Butler-Volmer law).

Signature, as in the JAX package:
    rxn(c_s_star, c_e, T, eta, k_eff, lambda_MHC, c_s_max, th) -> j
"""

from __future__ import annotations

import torch

from ..constants import FARADAY as F, IDEAL_GAS as R


def _sqrt_relu(x, minval=0.0):
    # torch.maximum, not clamp: the derivative at a tie is 1/2 as in JAX
    return torch.sqrt(torch.maximum(x, torch.full_like(x, minval)))


def _log_relu(x, minval=1e-4):
    return torch.log(torch.maximum(x, torch.full_like(x, minval)))


def _clip(x, lo, hi):
    """jnp.clip as minimum(maximum(·)) so ties differentiate like JAX's."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def rxn_BV(c_s_star, c_e, T, eta, k_i, lambda_MHC, c_s_max, th):
    """Butler-Volmer with α=0.5. The sinh argument is clamped to ±30 so a
    diverging Newton iterate cannot overflow f32 and poison the batch."""
    arg = _clip(0.5 * F * eta / (R * T), -30.0, 30.0)
    return (2.0 * k_i
            * _sqrt_relu(c_e * c_s_star * (c_s_max - c_s_star))
            * torch.sinh(arg))


def MHC_kfunc(eta, lam):
    """Zeng-Smith-Bai-Bazant MHC rate helper."""
    lam = torch.as_tensor(lam, dtype=eta.dtype, device=eta.device)
    a = 1.0 + torch.sqrt(lam)
    return (torch.sqrt(torch.pi * lam)
            * (1.0 - torch.erf((lam - torch.sqrt(a + eta**2)) / (2.0 * torch.sqrt(lam))))
            / (1.0 + torch.exp(-eta)))


def rxn_MHC(c_s_star, c_e, T, eta, k_i, lambda_MHC, c_s_max, th):
    """Marcus-Hush-Chidsey kinetics, α=0.5 branch."""
    eta_hat = eta * (F / (R * T))
    theta_i = c_s_star / c_s_max
    c_e0 = th["c_e0"]
    c_e_hat = c_e / c_e0

    eta_f = eta_hat + _log_relu(c_e_hat / theta_i, minval=1e-4)

    lam = torch.as_tensor(lambda_MHC, dtype=eta.dtype, device=eta.device)
    a = 1.0 + torch.sqrt(lam)
    k0 = k_i / ((1.0 - torch.erf((lam - torch.sqrt(a)) / (2.0 * torch.sqrt(lam)))) / 2.0)
    coeff_rd_ox = k0 * (1.0 - torch.erf((lam - torch.sqrt(a + eta_f**2))
                                        / (2.0 * torch.sqrt(lam))))
    return (coeff_rd_ox
            * (1.0 / (1.0 + torch.exp(-eta_f)) * c_e0 * c_s_star
               - 1.0 / (1.0 + torch.exp(+eta_f)) * c_e * c_s_max)
            * _sqrt_relu((1.0 - c_s_star / c_s_max) / c_e0))


def rxn_BV_gamma_mod_01(c_s_star, c_e, T, eta, k_i, lambda_MHC, c_s_max, th):
    """Activity-corrected Butler-Volmer."""
    alpha = 0.5
    theta_i = c_s_star / c_s_max
    c_e_hat = c_e / th["c_e0"]
    eta_hat = eta * (F / (R * T))
    act_R = theta_i / (1.0 - theta_i)
    gamma_ts = 1.0 / (theta_i * (1.0 - theta_i))
    ecd = k_i * c_e_hat ** (1 - alpha) * act_R**alpha / gamma_ts
    j_i = ecd * (torch.exp(-alpha * eta_hat) - torch.exp((1.0 - alpha) * eta_hat))
    return j_i * (-th["c_e0"] ** (1.0 - alpha) * c_s_max)


# the reference's export name
rxn_BV_gMod_01 = rxn_BV_gamma_mod_01

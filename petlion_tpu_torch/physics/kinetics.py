"""Electrode reaction-rate models (counterpart of
the JAX package's ``physics/kinetics.py``; Butler-Volmer, the LCO cell's law).

Signature, as in the JAX package:
    rxn(c_s_star, c_e, T, eta, k_eff, lambda_MHC, c_s_max, th) -> j
"""

from __future__ import annotations

import torch

from ..constants import FARADAY as F, IDEAL_GAS as R


def _sqrt_relu(x, minval=0.0):
    # torch.maximum, not clamp: the derivative at a tie is 1/2 as in JAX
    return torch.sqrt(torch.maximum(x, torch.full_like(x, minval)))


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

"""Open-circuit-voltage curves U(θ) and their temperature sensitivities
(counterpart of the JAX package's ``physics/ocv.py``: the curves of the LCO,
NMC, LG M50 and lithium-metal cells). Every curve returns ``(U, dU/dT)``;
the (T − T_ref)·dU/dT correction is skipped exactly when T == T_ref.
"""

from __future__ import annotations

import torch

from ..constants import T_REF


def _sqrt_relu(x, minval=0.0):
    """sqrt(max(minval, x)). `torch.maximum` (not `clamp`) so the derivative
    at a tie is split 1/2–1/2, as `jnp.maximum` does."""
    return torch.sqrt(torch.maximum(x, torch.full_like(x, minval)))


def ipow(x, k: int):
    """x**k for an integer k ≥ 1 by binary exponentiation, in the order of
    JAX's integer_pow (x³ = x·x², x¹⁰ = x²·x⁸, ...). The entropy
    coefficients (dU/dT) use it: their polynomials cancel to 1e-4 of their
    terms, so each power's rounding must be the JAX package's for the heat
    sources to agree to 1e-12. (dU/dT enters only the thermal model.)"""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def _temp_correct(U, dUdT, T):
    return U + torch.where(T == T_REF, torch.zeros_like(U), dUdT * (T - T_REF))


def OCV_LCO(theta_p, T, th=None):
    """LiCoO2 cathode OCV."""
    x = theta_p
    U = (
        (-4.656 + 88.669 * x**2 - 401.119 * x**4 + 342.909 * x**6
         - 462.471 * x**8 + 433.434 * x**10)
        / (-1.0 + 18.933 * x**2 - 79.532 * x**4 + 37.311 * x**6
           - 73.083 * x**8 + 95.96 * x**10)
    )
    dUdT = -0.001 * (
        (0.199521039 - 0.928373822 * x + 1.364550689000003 * x**2
         - 0.6115448939999998 * ipow(x, 3))
        / (1.0 - 5.661479886999997 * x + 11.47636191 * x**2
           - 9.82431213599998 * ipow(x, 3) + 3.048755063 * ipow(x, 4))
    )
    return _temp_correct(U, dUdT, T), dUdT


def OCV_LiC6(theta_n, T, th=None):
    """Graphite anode OCV."""
    x = theta_n
    U = (0.7222 + 0.1387 * x + 0.029 * _sqrt_relu(x) - 0.0172 / x
         + 0.0019 / (_sqrt_relu(x, minval=1e-4) * x)
         + 0.2808 * torch.exp(0.9 - 15.0 * x)
         - 0.7984 * torch.exp(0.4465 * x - 0.4108))
    num = (0.005269056 + 3.299265709 * x - 91.79325798 * x**2
           + 1004.911008 * ipow(x, 3) - 5812.278127 * ipow(x, 4)
           + 19329.7549 * ipow(x, 5) - 37147.8947 * ipow(x, 6)
           + 38379.18127 * ipow(x, 7) - 16515.05308 * ipow(x, 8))
    den = (1.0 - 48.09287227 * x + 1017.234804 * x**2 - 10481.80419 * ipow(x, 3)
           + 59431.3 * ipow(x, 4) - 195881.6488 * ipow(x, 5)
           + 374577.3152 * ipow(x, 6) - 385821.1607 * ipow(x, 7)
           + 165705.8597 * ipow(x, 8))
    dUdT = 0.001 * num / den
    return _temp_correct(U, dUdT, T), dUdT


def OCV_NMC(theta_p, T, th=None):
    """NMC cathode OCV."""
    x = theta_p
    U = -10.72 * x**4 + 23.88 * x**3 - 16.77 * x**2 + 2.595 * x + 4.563
    return U, torch.zeros_like(U)


def OCV_LiC6_with_NMC(theta_n, T, th=None):
    """Graphite OCV paired with NMC."""
    x = theta_n
    U = (0.1493 + 0.8493 * torch.exp(-61.79 * x) + 0.3824 * torch.exp(-665.8 * x)
         - torch.exp(39.42 * x - 41.92)
         - 0.03131 * torch.arctan(25.59 * x - 4.099)
         - 0.009434 * torch.arctan(32.49 * x - 15.74))
    return U, torch.zeros_like(U)


def OCV_NMC_LGM50(theta_p, T, th=None):
    """LG M50 NMC811 cathode OCV."""
    x = theta_p
    U = (-0.8090 * x + 4.4875 - 0.0428 * torch.tanh(18.5138 * (x - 0.5542))
         - 17.7326 * torch.tanh(15.7890 * (x - 0.3117))
         + 17.5842 * torch.tanh(15.9308 * (x - 0.3120)))
    return U, torch.zeros_like(U)


def OCV_LiC6_LGM50(theta_n, T, th=None):
    """LG M50 graphite anode OCV (also the lithium-metal anode's curve)."""
    x = theta_n
    U = (1.9793 * torch.exp(-39.3631 * x) + 0.15561
         - 0.0909 * torch.tanh(29.8538 * (x - 0.1234))
         - 0.04478 * torch.tanh(14.9159 * (x - 0.2769))
         - 0.0205 * torch.tanh(30.4444 * (x - 0.6103))
         - 0.09259 * torch.tanh(17.08 * (x - 1.0)))
    return U, torch.zeros_like(U)


OCV_Li_metal = OCV_LiC6_LGM50

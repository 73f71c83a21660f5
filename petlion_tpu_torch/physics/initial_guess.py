"""Initial state-vector guess (counterpart of
the JAX package's ``physics/initial_guess.py``)."""

from __future__ import annotations

import torch

from .residuals import ModelConfig


def initial_guess(SOC, th, cfg: ModelConfig):
    """Build Y0 ``(B, N_tot)`` for fresh runs at state-of-charge `SOC`
    (a ``(B,)`` tensor) with θ entries of shape ``(B, 1)``.

    Differential states at equilibrium values; algebraic states at their
    zero-current solution (Φ_s = OCV, Φ_e = 0, j = 0, I = 0).
    """
    num, L = cfg.numerics, cfg.layout
    SOC = SOC.reshape(-1, 1)

    c_s_p = th["c_max_p"] * (SOC * (th["theta_max_p"] - th["theta_min_p"])
                             + th["theta_min_p"])
    c_s_n = th["c_max_n"] * (SOC * (th["theta_max_n"] - th["theta_min_n"])
                             + th["theta_min_n"])

    T0 = th["T0"]
    U_p, _ = num.OCV_p(c_s_p / th["c_max_p"], T0, th)
    U_n, _ = num.OCV_n(c_s_n / th["c_max_n"], T0, th)

    B = max(SOC.shape[0], th["c_max_p"].shape[0])
    y = torch.zeros((B, L.N_tot), dtype=SOC.dtype, device=SOC.device)
    y[:, L.sl("c_e")] = th["c_e0"]
    y[:, L.sl("c_s_avg", "p")] = c_s_p
    y[:, L.sl("c_s_avg", "n")] = c_s_n
    if num.temperature:
        # the state carries T − T_amb (see residuals.build_auxiliary)
        y[:, L.sl("T")] = th["T0"] - th["T_amb"]
    if num.aging == "SEI":
        y[:, L.sl("SOH")] = 1.0
        # film and j_s stay 0
    if num.aging == "stress":
        y[:, L.sl("eps_s", "p")] = 1.0 - (th["eps_fp"] + th["eps_p"])
        y[:, L.sl("eps_s", "n")] = 1.0 - (th["eps_fn"] + th["eps_n"])
    # Q stays 0 (polynomial); a half cell's anode slices are empty
    y[:, L.sl("Phi_s", "p")] = U_p
    y[:, L.sl("Phi_s", "n")] = U_n
    # j, Φ_e and I stay 0 — I is overwritten by the run's initial current
    return y

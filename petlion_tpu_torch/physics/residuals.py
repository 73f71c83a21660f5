"""The P2D (DFN) residual as one batch-first torch function (counterpart of
the JAX package's ``physics/residuals.py``).

    residual_core(t, y, yp, th, cfg) -> r        (B, N_tot)

`y` and `yp` are ``(B, N_tot)``; every θ entry is a ``(B, 1)`` tensor, so
each cell carries its own parameters and cells never couple. The FVM
assembly is written as flux-difference stencils, the same arithmetic as the
JAX package, row for row. The last DAE row (the control row) is left at 0;
``solver.control`` fills it.

This package implements the main-path configuration: isothermal, Fickian
finite-difference radial diffusion, no aging, full cell. Every other
variant raises ``NotImplementedError`` naming the option.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..config import Discretizations, Numerics
from ..constants import FARADAY as F, IDEAL_GAS as R
from ..layout import StateLayout


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static bundle: mesh + numerics + computed layout. Hashable."""

    N: Discretizations
    numerics: Numerics
    layout: StateLayout

    @staticmethod
    def build(N: Discretizations, numerics: Numerics) -> "ModelConfig":
        return ModelConfig(N=N, numerics=numerics,
                           layout=StateLayout.build(N, numerics))

    @property
    def half_cell(self) -> bool:
        return self.numerics.anode == "Li_metal"


def check_supported(cfg: ModelConfig):
    """Raise for the physics variants this package does not implement yet."""
    num = cfg.numerics
    if num.temperature:
        raise NotImplementedError("temperature=True (thermal model)")
    if num.solid_diffusion != "Fickian":
        raise NotImplementedError(f"solid_diffusion={num.solid_diffusion!r}")
    if num.Fickian_method != "finite_difference":
        raise NotImplementedError(f"Fickian_method={num.Fickian_method!r}")
    if num.aging is not None:
        raise NotImplementedError(f"aging={num.aging!r}")
    if cfg.half_cell:
        raise NotImplementedError("anode='Li_metal' (half-cell)")


# ---------------------------------------------------------------------------
# 1C current density
# ---------------------------------------------------------------------------

def active_material(th):
    eps_sp = 1.0 - (th["eps_fp"] + th["eps_p"])
    eps_sn = 1.0 - (th["eps_fn"] + th["eps_n"])
    return eps_sp, eps_sn


def calc_I1C(th):
    """1C current density [A/m²] from the limiting electrode."""
    eps_sp, eps_sn = active_material(th)
    return (F / 3600.0) * torch.minimum(
        eps_sp * th["l_p"] * th["c_max_p"] * (th["theta_min_p"] - th["theta_max_p"]),
        eps_sn * th["l_n"] * th["c_max_n"] * (th["theta_max_n"] - th["theta_min_n"]),
    )


# ---------------------------------------------------------------------------
# grid helpers
# ---------------------------------------------------------------------------

def harmonic_mean(beta, x1, x2):
    return x1 * x2 / (beta * x2 + (1.0 - beta) * x1)


def cell_widths_psn(N: Discretizations, th):
    """Per-CV widths h over the concatenated (p,s,n) grid [m], (B, n)."""
    B = th["l_p"].shape[0]
    return torch.cat([(th["l_p"] / N.p).expand(B, N.p),
                      (th["l_s"] / N.s).expand(B, N.s),
                      (th["l_n"] / N.n).expand(B, N.n)], dim=-1)


def edge_interp(x, h):
    """Harmonic-mean interpolation of cell values to internal edges."""
    beta = h[..., :-1] / (h[..., :-1] + h[..., 1:])
    return harmonic_mean(beta, x[..., :-1], x[..., 1:])


def edge_grad(x, h):
    """Gradient at internal edges with centre distances (h_l+h_r)/2."""
    d = 0.5 * (h[..., :-1] + h[..., 1:])
    return (x[..., 1:] - x[..., :-1]) / d


def flux_divergence(flux, h):
    """(flux_R − flux_L)/h per cell, zero flux at the outer boundaries."""
    z = torch.zeros(flux.shape[:-1] + (1,), dtype=flux.dtype, device=flux.device)
    padded = torch.cat([z, flux, z], dim=-1)
    return (padded[..., 1:] - padded[..., :-1]) / h


# ---------------------------------------------------------------------------
# radial FD operators for Fickian solid diffusion
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def fd_first_order(n: int):
    """8th-order first-derivative matrix on n uniform nodes over [0,1];
    d/dr ≈ coeff · (M @ c)."""
    if n < 9:
        raise ValueError("Fickian radial FD requires N_r >= 9")
    dx = 1.0 / (n - 1)
    coeff = 1.0 / (40320.0 * dx)
    first = np.array([
        [-109584.0, 322560, -564480, 752640, -705600, 451584, -188160, 46080, -5040],
        [-5040.0, -64224, 141120, -141120, 117600, -70560, 28224, -6720, 720],
        [720.0, -11520, -38304, 80640, -50400, 26880, -10080, 2304, -240],
        [-240.0, 2880, -20160, -18144, 50400, -20160, 6720, -1440, 144],
    ])
    mid = np.array([144.0, -1536, 8064, -32256, 0, 32256, -8064, 1536, -144])
    last = np.array([
        [-144.0, 1440, -6720, 20160, -50400, 18144, 20160, -2880, 240],
        [240.0, -2304, 10080, -26880, 50400, -80640, 38304, 11520, -720],
        [-720.0, 6720, -28224, 70560, -117600, 141120, -141120, 64224, 5040],
        [5040.0, -46080, 188160, -451584, 705600, -752640, 564480, -322560, 109584],
    ])
    M = np.zeros((n, n))
    M[:4, :9] = first
    for r, i in enumerate(range(4, n - 4)):
        M[i, r:r + 9] = mid
    M[-4:, -9:] = last
    return M, coeff, dx


@lru_cache(maxsize=None)
def fd_second_order(n: int):
    """4th-order second-derivative matrix."""
    if n < 6:
        raise ValueError("Fickian radial FD requires N_r >= 6")
    dx = 1.0 / (n - 1)
    coeff = 1.0 / (12.0 * dx * dx)
    first = np.array([
        [-415.0 / 6, 96, -36, 32.0 / 3, -3.0 / 2, 0],
        [10.0, -15, -4, 14, -6, 1],
    ])
    mid = np.array([-1.0, 16, -30, 16, -1])
    last = np.array([
        [1.0, -6, 14, -4, -15, 10],
        [0.0, -3.0 / 2, 32.0 / 3, -36, 96, -415.0 / 6],
    ])
    M = np.zeros((n, n))
    M[:2, :6] = first
    for r, i in enumerate(range(2, n - 2)):
        M[i, r:r + 5] = mid
    M[-2:, -6:] = last
    return M, coeff, dx


@lru_cache(maxsize=None)
def _radial_operators(n_r: int, device: torch.device, dtype: torch.dtype):
    """(M1ᵀ, M2ᵀ, 2/r) as tensors on the run's device, built once."""
    M1, _, _ = fd_first_order(n_r)
    M2, _, _ = fd_second_order(n_r)
    r_nodes = torch.tensor(np.linspace(1.0 / (n_r - 1), 1.0, n_r - 1),
                           dtype=dtype, device=device)
    return (torch.tensor(M1.T, dtype=dtype, device=device),
            torch.tensor(M2.T, dtype=dtype, device=device),
            2.0 / r_nodes)


# ---------------------------------------------------------------------------
# auxiliary states
# ---------------------------------------------------------------------------

def build_auxiliary(t, y, th, cfg: ModelConfig):
    """Derived fields needed by the residual kernels (main-path config)."""
    check_supported(cfg)
    N, num, L = cfg.N, cfg.numerics, cfg.layout
    B = y.shape[0]

    c_e = L.get(y, "c_e")
    c_e_p, c_e_s, c_e_n = (L.get(y, "c_e", s) for s in ("p", "s", "n"))
    j = L.get(y, "j")
    Phi_e = L.get(y, "Phi_e")
    Phi_s = L.get(y, "Phi_s")

    # isothermal: T ≡ T0 over (a,p,s,n,z)
    n_all = N.a + N.p + N.s + N.n + N.z
    T_off = torch.zeros((B, n_all), dtype=y.dtype, device=y.device)
    T_full = th["T0"].expand(B, n_all)
    T_p = T_full[:, N.a:N.a + N.p]
    T_s = T_full[:, N.a + N.p:N.a + N.p + N.s]
    T_n = T_full[:, N.a + N.p + N.s:N.a + N.p + N.s + N.n]

    j_s = torch.zeros((B, N.n), dtype=y.dtype, device=y.device)
    j_total = j

    I1C = calc_I1C(th)
    I_density = L.get(y, "I") * I1C  # (B, 1) [A/m²]

    eps_sp, eps_sn = active_material(th)
    a_p = 3.0 * eps_sp / th["Rp_p"]
    a_n = 3.0 * eps_sn / th["Rp_n"]

    porosity = torch.cat([
        (1.0 - (th["eps_fp"] + eps_sp)).expand(B, N.p),
        th["eps_s"].expand(B, N.s),
        (1.0 - (th["eps_fn"] + eps_sn)).expand(B, N.n),
    ], dim=-1)

    sigma_eff_p = th["sigma_p"] * eps_sp
    sigma_eff_n = th["sigma_n"] * eps_sn

    c_s_star_p = L.c_s_surf(y, "p")
    c_s_star_n = L.c_s_surf(y, "n")
    D_s_p, D_s_n = num.D_s_eff(c_s_star_p, c_s_star_n, T_p, T_n, th)

    U_p, dUdT_p = num.OCV_p(c_s_star_p / th["c_max_p"], T_p, th)
    U_n, dUdT_n = num.OCV_n(c_s_star_n / th["c_max_n"], T_n, th)

    eta_p = Phi_s[:, :N.p] - Phi_e[:, :N.p] - U_p
    eta_n = Phi_s[:, N.p:] - Phi_e[:, N.p + N.s:] - U_n
    if "R_film_n" in th:
        eta_n = eta_n - j[:, N.p:] * F * th["R_film_n"]

    K_eff = torch.cat(num.K_eff(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th), dim=-1)
    D_eff = torch.cat(num.D_eff(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th), dim=-1)
    nu = num.thermodynamic_factor(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th)

    return dict(
        c_e=c_e, j=j, j_s=j_s, j_total=j_total, Phi_e=Phi_e, Phi_s=Phi_s,
        T_full=T_full, T_off=T_off, T_p=T_p, T_s=T_s, T_n=T_n,
        I1C=I1C, I_density=I_density,
        a_p=a_p, a_n=a_n, porosity=porosity,
        sigma_eff_p=sigma_eff_p, sigma_eff_n=sigma_eff_n,
        c_s_star_p=c_s_star_p, c_s_star_n=c_s_star_n,
        D_s_p=D_s_p, D_s_n=D_s_n,
        U_p=U_p, U_n=U_n, dUdT_p=dUdT_p, dUdT_n=dUdT_n,
        eta_p=eta_p, eta_n=eta_n,
        K_eff=K_eff, D_eff=D_eff, nu=nu,
    )


# ---------------------------------------------------------------------------
# residual kernels
# ---------------------------------------------------------------------------

def _zeros(like, n):
    return torch.zeros((like.shape[0], n), dtype=like.dtype, device=like.device)


def _res_c_e(aux, yp, th, cfg: ModelConfig):
    """Electrolyte diffusion."""
    N, L = cfg.N, cfg.layout
    h = cell_widths_psn(N, th)
    c_e = aux["c_e"]
    D_edge = edge_interp(aux["D_eff"], h)
    flux = D_edge * edge_grad(c_e, h)
    rhs = flux_divergence(flux, h)

    nu_p, nu_s, nu_n = aux["nu"]
    src = torch.cat([
        (1.0 - th["t_plus"]) * nu_p * aux["a_p"] * aux["j_total"][:, :N.p],
        _zeros(c_e, N.s),
        (1.0 - th["t_plus"]) * nu_n * aux["a_n"] * aux["j_total"][:, N.p:],
    ], dim=-1)
    rhs = (rhs + src) / aux["porosity"]
    return rhs - yp[:, L.sl("c_e")]


def _fickian_rhs(c_s, j, Rp, D_s, n_el: int, n_r: int):
    """Radial Fickian diffusion RHS for one electrode, batched over cells
    and volumes. c_s: (B, n_el*n_r); j, D_s: (B, n_el); Rp: (B, 1)."""
    _, coef1, dr = fd_first_order(n_r)
    _, coef2, _ = fd_second_order(n_r)
    M1t, M2t, two_over_r = _radial_operators(n_r, c_s.device, c_s.dtype)

    C = c_s.reshape(c_s.shape[0], n_el, n_r)
    # subtracting the per-particle mean is exact (both stencils annihilate
    # constants) and shrinks the f32 cancellation noise ~100x. Its exact
    # derivative contribution is zero, so it stays out of the AD graph: the
    # rounding noise of differentiating it would otherwise turn structural
    # zeros of the Jacobian into detected nonzeros.
    Cv = C - C.mean(dim=-1, keepdim=True).detach()
    d1 = torch.matmul(Cv, M1t) * coef1
    # BCs on the first derivative: no flux at the centre, j at the surface
    d1 = torch.cat([torch.zeros_like(d1[..., :1]), d1[..., 1:-1],
                    (-j / D_s * Rp)[..., None]], dim=-1)
    d2 = torch.matmul(Cv, M2t) * coef2
    # Neumann correction at r=1
    d2 = torch.cat([d2[..., :-1],
                    d2[..., -1:] + 50.0 * dr * d1[..., -1:] * coef2], dim=-1)

    inner = torch.cat([
        3.0 * d2[..., :1],
        d2[..., 1:] + two_over_r * d1[..., 1:],
    ], dim=-1)
    rhs = (D_s / Rp**2)[..., None] * inner
    return rhs.reshape(c_s.shape[0], n_el * n_r)


def _res_c_s_avg(aux, y, yp, th, cfg: ModelConfig):
    """Solid diffusion."""
    N, L = cfg.N, cfg.layout
    j = aux["j"]
    rhs_p = _fickian_rhs(L.get(y, "c_s_avg", "p"), j[:, :N.p], th["Rp_p"],
                         aux["D_s_p"], N.p, N.r_p)
    rhs_n = _fickian_rhs(L.get(y, "c_s_avg", "n"), j[:, N.p:], th["Rp_n"],
                         aux["D_s_n"], N.n, N.r_n)
    return torch.cat([rhs_p, rhs_n], dim=-1) - yp[:, L.sl("c_s_avg")]


def _res_j(aux, th, cfg: ModelConfig):
    """Intercalation flux."""
    N, num = cfg.N, cfg.numerics
    k_p, k_n = num.rxn_rate(aux["T_p"], aux["T_n"],
                            aux["c_s_star_p"], aux["c_s_star_n"], th)
    lam_p = th.get("lambda_MHC_p", 0.0)
    lam_n = th.get("lambda_MHC_n", 0.0)
    j_p_calc = num.rxn_p(aux["c_s_star_p"], aux["c_e"][:, :N.p], aux["T_p"],
                         aux["eta_p"], k_p, lam_p, th["c_max_p"], th)
    j_n_calc = num.rxn_n(aux["c_s_star_n"], aux["c_e"][:, N.p + N.s:],
                         aux["T_n"], aux["eta_n"], k_n, lam_n, th["c_max_n"],
                         th)
    return torch.cat([j_p_calc, j_n_calc], dim=-1) - aux["j"]


def _res_Phi_e(aux, th, cfg: ModelConfig):
    """Electrolyte potential; the last row grounds Φ_e(x=L) = 0."""
    N = cfg.N
    h = cell_widths_psn(N, th)
    c_e = aux["c_e"]
    K_edge = edge_interp(aux["K_eff"], h)

    fluxPhi = K_edge * edge_grad(aux["Phi_e"], h)

    # migration term at internal edges: K̂ T̄ ∂ₓc̄ / c̄
    T_psn = aux["T_full"][:, N.a:N.a + N.p + N.s + N.n]
    T_edge = edge_interp(T_psn, h)
    c_edge = edge_interp(c_e, h)
    dc_edge = edge_grad(c_e, h)
    prod = K_edge * T_edge * dc_edge / c_edge

    nu_cells = torch.cat(aux["nu"], dim=-1)
    Kfac = 2.0 * R * (1.0 - th["t_plus"]) * nu_cells / F

    z = _zeros(c_e, 1)
    prod_pad = torch.cat([z, prod, z], dim=-1)
    dprod = prod_pad[:, 1:] - prod_pad[:, :-1]
    src = torch.cat([
        h[:, :N.p] * F * aux["a_p"] * aux["j_total"][:, :N.p],
        _zeros(c_e, N.s),
        h[:, N.p + N.s:] * F * aux["a_n"] * aux["j_total"][:, N.p:],
    ], dim=-1)
    f = -Kfac * dprod + src

    fp = torch.cat([z, fluxPhi, z], dim=-1)
    APhi = -(fp[:, 1:] - fp[:, :-1])
    res = APhi - f
    return torch.cat([res[:, :-1], aux["Phi_e"][:, -1:]], dim=-1)


def _res_Phi_s(aux, th, cfg: ModelConfig):
    """Solid-phase potential."""
    N = cfg.N
    Phi_s = aux["Phi_s"]
    j_tot = aux["j_total"]
    h_p = th["l_p"] / N.p
    h_n = th["l_n"] / N.n
    I_density = aux["I_density"]

    def electrode(Phi, f):
        # tridiagonal [1, -2, 1] with one-sided (reflective) ends
        lap = (torch.cat([Phi[:, 1:], Phi[:, -1:]], dim=-1)
               - 2.0 * Phi
               + torch.cat([Phi[:, :1], Phi[:, :-1]], dim=-1))
        return lap - f

    f_p = h_p**2 * aux["a_p"] * F * j_tot[:, :N.p]
    f_p = torch.cat([f_p[:, :1] + (-I_density * h_p), f_p[:, 1:]], dim=-1)
    f_p = f_p / aux["sigma_eff_p"]

    f_n = h_n**2 * aux["a_n"] * F * j_tot[:, N.p:]
    f_n = torch.cat([f_n[:, :-1], f_n[:, -1:] + (+I_density * h_n)], dim=-1)
    f_n = f_n / aux["sigma_eff_n"]

    return torch.cat([
        electrode(Phi_s[:, :N.p], f_p),
        electrode(Phi_s[:, N.p:], f_n),
    ], dim=-1)


# ---------------------------------------------------------------------------
# assembled residual
# ---------------------------------------------------------------------------

def residual_core(t, y, yp, th, cfg: ModelConfig):
    """Full DAE residual (B, N_tot) with the control (last) row left at 0."""
    aux = build_auxiliary(t, y, th, cfg)
    return torch.cat([
        _res_c_e(aux, yp, th, cfg),
        _res_c_s_avg(aux, y, yp, th, cfg),
        _res_j(aux, th, cfg),
        _res_Phi_e(aux, th, cfg),
        _res_Phi_s(aux, th, cfg),
        _zeros(y, 1),   # control row, filled by the solver
    ], dim=-1)

"""The P2D (DFN) residual as one batch-first torch function (counterpart of
the JAX package's ``physics/residuals.py``).

    residual_core(t, y, yp, th, cfg) -> r        (B, N_tot)

`y` and `yp` are ``(B, N_tot)``; every θ entry is a ``(B, 1)`` tensor, so
each cell carries its own parameters and cells never couple. The FVM
assembly is written as flux-difference stencils, the same arithmetic as the
JAX package, row for row. The last DAE row (the control row) is left at 0;
``solver.control`` fills it.

Every variant of the JAX package is implemented: Fickian radial diffusion
by finite differences or Chebyshev spectral collocation, the quadratic and
polynomial (Q-state) particle approximations, SEI and stress (loss of
active material) aging, the lithium-foil half cell, and the 1D thermal
model (``temperature=True``), whose state carries T − T_amb.
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


def cell_widths_psn(N: Discretizations, th, half_cell: bool = False):
    """Per-CV widths h over the concatenated (p,s,n) grid [m], (B, n).
    Half cell: the anode is a foil boundary, not a domain — (p,s) only."""
    B = th["l_p"].shape[0]
    parts = [(th["l_p"] / N.p).expand(B, N.p),
             (th["l_s"] / N.s).expand(B, N.s)]
    if not half_cell:
        parts.append((th["l_n"] / N.n).expand(B, N.n))
    return torch.cat(parts, dim=-1)


def cell_widths_thermal(N: Discretizations, th, half_cell: bool = False):
    """Per-CV widths over the thermal grid [m], (B, n): (a,p,s,n,z) for a
    full cell; (a,p,s,z) for the half cell, where the lithium foil is a
    boundary heat source at the s|z interface."""
    B = th["l_p"].shape[0]
    names = ("a", "p", "s") + (() if half_cell else ("n",)) + ("z",)
    return torch.cat([(th["l_" + k] / getattr(N, k)).expand(B, getattr(N, k))
                      for k in names], dim=-1)


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
def cheb_matrix(n_r: int):
    """Chebyshev differentiation matrix and nodes for the spectral radial
    scheme (Trefethen's `cheb`)."""
    N = n_r - 1
    x = np.cos(np.linspace(0.0, np.pi, N + 1))
    c = np.hstack([2.0, np.ones(N - 1), 2.0]) * (-1.0) ** np.arange(N + 1)
    X = np.tile(x[:, None], (1, N + 1))
    dX = X - X.T
    D = np.outer(c, 1.0 / c) / (dX + np.eye(N + 1))
    D -= np.diag(D.sum(axis=1))
    return D, x


@lru_cache(maxsize=None)
def _cheb_operators(n_r: int, device: torch.device, dtype: torch.dtype):
    """(Dᵀ, x) of `cheb_matrix` as tensors on the run's device."""
    D, x = cheb_matrix(n_r)
    return (torch.tensor(D.T, dtype=dtype, device=device),
            torch.tensor(x, dtype=dtype, device=device))


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
    """Derived fields needed by the residual kernels."""
    N, num, L = cfg.N, cfg.numerics, cfg.layout
    B = y.shape[0]

    c_e = L.get(y, "c_e")
    c_e_p, c_e_s, c_e_n = (L.get(y, "c_e", s) for s in ("p", "s", "n"))
    j = L.get(y, "j")
    Phi_e = L.get(y, "Phi_e")
    Phi_s = L.get(y, "Phi_s")

    # temperature over (a,p,s,n,z); a half cell has no anode CVs. The state
    # carries the offset T − T_amb: in float32, ulp(313 K) ≈ 3e-5 K would
    # swamp the mK gradients the thermal stencils and the dT hold depend on.
    # Absolute T is rebuilt here for the physical consumers (Arrhenius
    # factors, kinetics, heat sources); _res_T works on the offset.
    n_eff = 0 if cfg.half_cell else N.n
    if num.temperature:
        T_off = L.get(y, "T")
        T_full = T_off + th["T_amb"]
    else:
        n_all = N.a + N.p + N.s + n_eff + N.z
        T_off = torch.zeros((B, n_all), dtype=y.dtype, device=y.device)
        T_full = th["T0"].expand(B, n_all)
    T_p = T_full[:, N.a:N.a + N.p]
    T_s = T_full[:, N.a + N.p:N.a + N.p + N.s]
    T_n = T_full[:, N.a + N.p + N.s:N.a + N.p + N.s + n_eff]

    # j_total = j + j_s on the anode
    if num.aging == "SEI":
        j_s = L.get(y, "j_s")
        j_total = torch.cat([j[:, :N.p], j[:, N.p:] + j_s], dim=-1)
    else:
        j_s = torch.zeros((B, n_eff), dtype=y.dtype, device=y.device)
        j_total = j

    I1C = calc_I1C(th)
    I_density = L.get(y, "I") * I1C  # (B, 1) [A/m²]

    eps_sp, eps_sn = active_material(th)
    if num.aging == "stress":
        # per-CV active-material fractions, clamped ≥ 0 so a step past the
        # ε_s > 0 gate cannot give a negative interfacial area
        eps_sp = torch.maximum(L.get(y, "eps_s", "p"), torch.zeros_like(eps_sp))
        eps_sn = torch.maximum(L.get(y, "eps_s", "n"), torch.zeros_like(eps_sn))
    a_p = 3.0 * eps_sp / th["Rp_p"]
    a_n = 3.0 * eps_sn / th["Rp_n"]

    porosity = torch.cat([
        (1.0 - (th["eps_fp"] + eps_sp)).expand(B, N.p),
        th["eps_s"].expand(B, N.s),
        (1.0 - (th["eps_fn"] + eps_sn)).expand(B, n_eff),
    ], dim=-1)

    sigma_eff_p = th["sigma_p"] * eps_sp
    sigma_eff_n = th["sigma_n"] * eps_sn

    # surface concentration c_s_star
    if num.solid_diffusion == "Fickian":
        c_s_star_p = L.c_s_surf(y, "p")
        c_s_star_n = L.c_s_surf(y, "n")
        D_s_p, D_s_n = num.D_s_eff(c_s_star_p, c_s_star_n, T_p, T_n, th)
    else:
        # D_s_eff at the volume average gives c_s_star; D_s_eff is then
        # refreshed at c_s_star for the downstream users (as the JAX package)
        c_s_avg_p = L.get(y, "c_s_avg", "p")
        c_s_avg_n = L.get(y, "c_s_avg", "n")
        D_s_p, D_s_n = num.D_s_eff(c_s_avg_p, c_s_avg_n, T_p, T_n, th)
        j_p, j_n = j[:, :N.p], j[:, N.p:]
        if num.solid_diffusion == "quadratic":
            c_s_star_p = c_s_avg_p - (th["Rp_p"] / (5.0 * D_s_p)) * j_p
            c_s_star_n = c_s_avg_n - (th["Rp_n"] / (5.0 * D_s_n)) * j_n
        else:  # polynomial
            Q_p = L.get(y, "Q", "p")
            Q_n = L.get(y, "Q", "n")
            c_s_star_p = c_s_avg_p + (th["Rp_p"] / (35.0 * D_s_p)) * (-j_p + 8.0 * D_s_p * Q_p)
            c_s_star_n = c_s_avg_n + (th["Rp_n"] / (35.0 * D_s_n)) * (-j_n + 8.0 * D_s_n * Q_n)
        D_s_p, D_s_n = num.D_s_eff(c_s_star_p, c_s_star_n, T_p, T_n, th)

    U_p, dUdT_p = num.OCV_p(c_s_star_p / th["c_max_p"], T_p, th)
    U_n, dUdT_n = num.OCV_n(c_s_star_n / th["c_max_n"], T_n, th)

    eta_p = Phi_s[:, :N.p] - Phi_e[:, :N.p] - U_p
    eta_n = Phi_s[:, N.p:] - Phi_e[:, N.p + N.s:] - U_n
    if "R_film_n" in th:
        eta_n = eta_n - j[:, N.p:] * F * th["R_film_n"]
    if num.aging == "SEI":
        R_film = th["R_SEI"] + L.get(y, "film") / th["k_n_aging"]
        eta_n = eta_n - F * j[:, N.p:] * R_film

    K_eff = torch.cat(num.K_eff(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th), dim=-1)
    D_eff = torch.cat(num.D_eff(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th), dim=-1)
    nu = num.thermodynamic_factor(c_e_p, c_e_s, c_e_n, T_p, T_s, T_n, th)

    # surface hydrostatic particle stress (stress aging), the simplified
    # shell stress σ_h = 2ΩE/(9(1−ν)) · (c̄ − c_surf)
    sigma_h_p = sigma_h_n = None
    if num.aging == "stress":
        if num.solid_diffusion == "Fickian":
            weights = (_spectral_volume_weights
                       if num.Fickian_method == "spectral"
                       else _radial_volume_weights)
            cp = L.get(y, "c_s_avg", "p")
            cn = L.get(y, "c_s_avg", "n")
            cbar_p = torch.matmul(cp.reshape(B, -1, N.r_p),
                                  weights(N.r_p, y.device, y.dtype))
            cbar_n = torch.matmul(cn.reshape(B, -1, N.r_n),
                                  weights(N.r_n, y.device, y.dtype))
        else:
            cbar_p = L.get(y, "c_s_avg", "p")
            cbar_n = L.get(y, "c_s_avg", "n")
        sigma_h_p = (2.0 * th["Omega_p"] * th["E_p"]
                     / (9.0 * (1.0 - th["nu_p"]))) * (cbar_p - c_s_star_p)
        sigma_h_n = (2.0 * th["Omega_n"] * th["E_n"]
                     / (9.0 * (1.0 - th["nu_n"]))) * (cbar_n - c_s_star_n)

    return dict(
        sigma_h_p=sigma_h_p, sigma_h_n=sigma_h_n,
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
    """Electrolyte diffusion. Half cell: the foil strips or plates Li at
    j_foil = −I_density/F at the face of the last separator CV, of which
    the (1−t₊) fraction is the net source."""
    N, L = cfg.N, cfg.layout
    h = cell_widths_psn(N, th, cfg.half_cell)
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
    if cfg.half_cell:
        j_foil = -aux["I_density"] / F
        src = torch.cat([src[:, :-1], src[:, -1:] + (1.0 - th["t_plus"])
                         * nu_s[:, -1:] * j_foil / h[:, -1:]], dim=-1)
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


def _spectral_rhs(c_s, j, Rp, D_s, n_el: int, n_r: int):
    """Chebyshev-spectral radial diffusion RHS, shapes as `_fickian_rhs`.
    Storage as the finite-difference layout (node n_r−1 = particle
    surface); the Chebyshev grid runs surface → centre, hence the flips."""
    DmT, xj = _cheb_operators(n_r, c_s.device, c_s.dtype)
    B = c_s.shape[0]
    C = c_s.reshape(B, n_el, n_r)
    # the mean shift of `_fickian_rhs`: D's rows sum to zero
    Cv = C - C.mean(dim=-1, keepdim=True).detach()
    dcr = torch.matmul(Cv.flip(-1), DmT)
    # surface BC (Chebyshev scheme) and no flux at the centre
    dcr = torch.cat([(-j * Rp * 0.5 / D_s)[..., None], dcr[..., 1:-1],
                     torch.zeros_like(dcr[..., :1])], dim=-1)
    Rp2 = (Rp**2)[..., None]
    inner = torch.matmul(4.0 * D_s[..., None] * (xj + 1.0) ** 2 * dcr / Rp2, DmT)
    rhs_num = inner.flip(-1)
    rhs_limit = (4.0 * D_s[..., None] / Rp2) * 3.0 * torch.matmul(dcr, DmT)
    denom = (xj[:-1].flip(0) + 1.0) ** 2
    rhs = torch.cat([
        rhs_limit[..., -1:],                   # L'Hôpital at the centre
        rhs_num[..., 1:] / denom,
    ], dim=-1)
    return rhs.reshape(B, n_el * n_r)


def radial_rhs(numerics: Numerics):
    """The Fickian radial scheme of `numerics`: `_fickian_rhs` (finite
    differences) or `_spectral_rhs`."""
    return (_fickian_rhs if numerics.Fickian_method == "finite_difference"
            else _spectral_rhs)


def _res_c_s_avg(aux, y, yp, th, cfg: ModelConfig):
    """Solid diffusion."""
    N, num, L = cfg.N, cfg.numerics, cfg.layout
    j = aux["j"]
    n_eff = 0 if cfg.half_cell else N.n
    if num.solid_diffusion == "Fickian":
        radial = radial_rhs(num)
        rhs = torch.cat([
            radial(L.get(y, "c_s_avg", "p"), j[:, :N.p], th["Rp_p"],
                   aux["D_s_p"], N.p, N.r_p),
            radial(L.get(y, "c_s_avg", "n"), j[:, N.p:], th["Rp_n"],
                   aux["D_s_n"], n_eff, N.r_n),
        ], dim=-1)
    else:
        # quadratic / polynomial: dc_s/dt = −3 j / Rp
        rhs = torch.cat([-3.0 * j[:, :N.p] / th["Rp_p"],
                         -3.0 * j[:, N.p:] / th["Rp_n"]], dim=-1)
    return rhs - yp[:, L.sl("c_s_avg")]


@lru_cache(maxsize=None)
def _radial_volume_weights_np(n_r: int):
    """Trapezoid weights for the particle volume average c̄ = 3∫₀¹ c r² dr
    on the uniform radial grid, normalized so a constant c gives c̄ = c."""
    r = np.linspace(0.0, 1.0, n_r)
    w = 3.0 * r * r
    w[0] *= 0.5
    w[-1] *= 0.5
    w /= w.sum()
    return w


@lru_cache(maxsize=None)
def _spectral_volume_weights_np(n_r: int):
    """Clenshaw–Curtis weights for the particle volume average on the
    Chebyshev radial grid of `_spectral_rhs`: with ρ = (x+1)/2,
    c̄ = (3/8)∫₋₁¹ c(x)(x+1)² dx, reversed into storage order (index
    n_r−1 = surface) and normalized so a constant c gives c̄ = c."""
    N = n_r - 1
    x = np.cos(np.linspace(0.0, np.pi, N + 1))
    w_cc = np.zeros(N + 1)
    for k in range(N + 1):
        s = 0.0
        for j in range(1, N // 2 + 1):
            b = 1.0 if 2 * j == N else 2.0
            s += b / (4.0 * j * j - 1.0) * np.cos(2.0 * j * k * np.pi / N)
        c = 1.0 if k in (0, N) else 2.0
        w_cc[k] = (c / N) * (1.0 - s)
    w = (3.0 / 8.0) * w_cc * (x + 1.0) ** 2
    w = w[::-1].copy()          # Chebyshev order (surface first) → storage
    w /= w.sum()
    return w


@lru_cache(maxsize=None)
def _radial_volume_weights(n_r: int, device, dtype):
    return torch.tensor(_radial_volume_weights_np(n_r), dtype=dtype, device=device)


@lru_cache(maxsize=None)
def _spectral_volume_weights(n_r: int, device, dtype):
    return torch.tensor(_spectral_volume_weights_np(n_r), dtype=dtype,
                        device=device)


def _res_eps_s(aux, y, yp, th, cfg: ModelConfig):
    """Stress-driven loss of active material, per electrode CV:

        dε_s/dt = −β_LAM · (⟨σ_h⟩₊ / σ_critical)^m_LAM · 1[ε_s > 0]
    """
    L = cfg.layout

    def rate(sig, crit):
        pos = torch.maximum(sig, torch.zeros_like(sig))
        return -th["beta_LAM"] * (pos / crit) ** th["m_LAM"]

    rhs = torch.cat([rate(aux["sigma_h_p"], th["sigma_critical_p"]),
                     rate(aux["sigma_h_n"], th["sigma_critical_n"])], dim=-1)
    eps = y[:, L.sl("eps_s")]
    rhs = torch.where(eps > 0.0, rhs, torch.zeros_like(rhs))
    return rhs - yp[:, L.sl("eps_s")]


def _res_Q(aux, y, yp, th, cfg: ModelConfig):
    """Polynomial-model flux state, with Subramanian's −30·D_s·Q relaxation
    (as the JAX package)."""
    N, L = cfg.N, cfg.layout
    Q_p, Q_n = L.get(y, "Q", "p"), L.get(y, "Q", "n")
    j = aux["j"]
    rhs = torch.cat([
        (-30.0 * aux["D_s_p"] * Q_p - 22.5 * j[:, :N.p]) / th["Rp_p"]**2,
        (-30.0 * aux["D_s_n"] * Q_n - 22.5 * j[:, N.p:]) / th["Rp_n"]**2,
    ], dim=-1)
    return rhs - yp[:, L.sl("Q")]


def _res_film(aux, yp, th, cfg: ModelConfig):
    """SEI film growth."""
    rhs = -aux["j_s"] * th["M_n"] / th["rho_n"]
    return rhs - yp[:, cfg.layout.sl("film")]


def _extrap_x0(x, ys):
    """Quadratic extrapolation to x = 0 through three points, per cell."""
    x1, x2, x3 = x[0], x[1], x[2]
    y1, y2, y3 = ys[..., 0], ys[..., 1], ys[..., 2]
    t1 = (y3 - y1 - ((x3 - x1) / (x2 - x1)) * (y2 - y1))
    den = (x3**2 - x1**2 - ((x2**2 - x1**2) / (x2 - x1)) * (x3 - x1))
    a = t1 / den
    b = (y2 - y1 - a * (x2**2 - x1**2)) / (x2 - x1)
    return y1 - a * x1**2 - b * x1


def _res_SOH(aux, yp, th, cfg: ModelConfig):
    """State-of-health capacity-loss integral: the side-reaction flux j_s,
    extrapolated to both faces of the anode, integrated by the trapezoid
    rule."""
    N, L = cfg.N, cfg.layout
    j_s = aux["j_s"]
    n = N.n
    centers = np.linspace(1.0 / (2 * n), 1.0 - 1.0 / (2 * n), n)
    x_range = torch.tensor(np.concatenate([[0.0], centers, [1.0]]),
                           dtype=j_s.dtype, device=j_s.device) * th["l_n"]
    x_interp = np.array([centers[0], centers[1], centers[2]])
    y_left = _extrap_x0(x_interp, j_s[:, :3])
    y_right = _extrap_x0(x_interp, j_s.flip(-1)[:, :3])
    y_range = torch.cat([y_left[:, None], j_s, y_right[:, None]], dim=-1)
    trapz = torch.sum(0.5 * (x_range[:, 1:] - x_range[:, :-1])
                      * (y_range[:, 1:] + y_range[:, :-1]), dim=-1,
                      keepdim=True)
    j_s_int = -trapz * F * aux["a_n"] / (3600.0 * aux["I1C"])
    return -j_s_int - yp[:, L.sl("SOH")]


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


def _res_j_s(aux, y, th, cfg: ModelConfig):
    """SEI side-reaction flux, active on charge only."""
    N, L = cfg.N, cfg.layout
    R_film = th["R_SEI"] + L.get(y, "film") / th["k_n_aging"]
    Phi_s_n = aux["Phi_s"][:, N.p:]
    Phi_e_n = aux["Phi_e"][:, N.p + N.s:]
    eta_s = (Phi_s_n - Phi_e_n - th["Uref_s"]
             - F * aux["j_total"][:, N.p:] * R_film)
    alpha = 0.5
    I_density = aux["I_density"]
    j_s_calc = -torch.abs(
        (th["i_0_jside"] * (I_density / aux["I1C"]) ** th["w"] / F)
        * (-torch.exp(-alpha * F / (R * aux["T_n"]) * eta_s))
    )
    j_s_calc = torch.where(I_density > 0, j_s_calc, torch.zeros_like(j_s_calc))
    return aux["j_s"] - j_s_calc


def _res_Phi_e(aux, th, cfg: ModelConfig):
    """Electrolyte potential. Full cell: the last row grounds
    Φ_e(x=L) = 0. Half cell: that row carries the foil's charge balance,
    F·j_foil(η_foil) + I_density = 0, with the foil grounded (Φ_foil ≡ 0,
    so η_foil = −Φ_e at the foil face)."""
    N = cfg.N
    h = cell_widths_psn(N, th, cfg.half_cell)
    c_e = aux["c_e"]
    K_edge = edge_interp(aux["K_eff"], h)

    fluxPhi = K_edge * edge_grad(aux["Phi_e"], h)

    # migration term at internal edges: K̂ T̄ ∂ₓc̄ / c̄
    n_eff = 0 if cfg.half_cell else N.n
    T_psn = aux["T_full"][:, N.a:N.a + N.p + N.s + n_eff]
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
    if cfg.half_cell:
        # the foil's reaction at a fixed mid-stoichiometry surface activity,
        # through the configured reaction law
        num = cfg.numerics
        c_e_foil = c_e[:, -1:]
        T_foil = T_psn[:, -1:]
        eta_foil = -aux["Phi_e"][:, -1:]
        c_s_ref = 0.5 * th["c_max_n"]
        _, k_n = num.rxn_rate(aux["T_p"], T_foil, aux["c_s_star_p"], c_s_ref, th)
        j_foil = num.rxn_n(c_s_ref, c_e_foil, T_foil, eta_foil, k_n,
                           th.get("lambda_MHC_n", 0.0), th["c_max_n"], th)
        last = F * j_foil + aux["I_density"]
    else:
        last = aux["Phi_e"][:, -1:]
    return torch.cat([res[:, :-1], last], dim=-1)


def _res_Phi_s(aux, th, cfg: ModelConfig):
    """Solid-phase potential (cathode only in a half cell: the foil is the
    ground)."""
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
    if cfg.half_cell:
        return electrode(Phi_s[:, :N.p], f_p)

    f_n = h_n**2 * aux["a_n"] * F * j_tot[:, N.p:]
    f_n = torch.cat([f_n[:, :-1], f_n[:, -1:] + (+I_density * h_n)], dim=-1)
    f_n = f_n / aux["sigma_eff_n"]

    return torch.cat([
        electrode(Phi_s[:, :N.p], f_p),
        electrode(Phi_s[:, N.p:], f_n),
    ], dim=-1)


def _res_T(aux, y, yp, th, cfg: ModelConfig):
    """1D thermal model over (a,p,s,n,z). Conduction and the ambient
    convection act on the state's offset T − T_amb (exact gradients in
    float32); the heat sources use absolute T from `aux`.

    Half cell: the grid is (a,p,s,z); the foil enters as the interfacial
    heat F·j_foil·η_foil = −I_density·η_foil [W/m²] at the s|z face,
    injected into the first z CV."""
    N, L = cfg.N, cfg.layout
    hc = cfg.half_cell
    T = aux["T_off"]
    B = T.shape[0]
    h = cell_widths_thermal(N, th, hc)
    names = ("a", "p", "s") + (() if hc else ("n",)) + ("z",)
    lam_cells = torch.cat([th["lam_" + k].expand(B, getattr(N, k))
                           for k in names], dim=-1)
    rho_cp = torch.cat([(th["rho_" + k] * th["Cp_" + k]).expand(B, getattr(N, k))
                        for k in names], dim=-1)

    flux = edge_interp(lam_cells, h) * edge_grad(T, h)
    conduction = flux_divergence(flux, h)

    Q_rev, Q_rxn, Q_ohm = _heat_generation(aux, th, cfg)
    if hc:
        # foil heat into the first z CV: η_foil = −Φ_e(foil face),
        # j_foil = −I_density/F, so q = F·j_foil·η_foil ≥ 0
        eta_foil = -aux["Phi_e"][:, -1:]
        i_z0 = N.a + N.p + N.s
        q = -aux["I_density"] * eta_foil / h[:, i_z0:i_z0 + 1]
        Q_rxn = torch.cat([Q_rxn[:, :i_z0], Q_rxn[:, i_z0:i_z0 + 1] + q,
                           Q_rxn[:, i_z0 + 1:]], dim=-1)

    # Robin ends: h_cell·(T_amb − T) = −h_cell·T_offset, exact in offset form
    z = _zeros(T, T.shape[1] - 2)
    bc = torch.cat([-th["h_cell"] * T[:, :1] / h[:, :1], z,
                    -th["h_cell"] * T[:, -1:] / h[:, -1:]], dim=-1)

    rhs = (conduction + Q_rev + Q_rxn + Q_ohm + bc) / rho_cp
    return rhs - yp[:, L.sl("T")]


def _heat_generation(aux, th, cfg: ModelConfig):
    """Q_rev, Q_rxn, Q_ohm over the full thermal grid, each (B, n)."""
    N = cfg.N
    hc = cfg.half_cell
    j_tot = aux["j_total"]
    T_p, T_s, T_n = aux["T_p"], aux["T_s"], aux["T_n"]
    c_e = aux["c_e"]
    Phi_s, Phi_e = aux["Phi_s"], aux["Phi_e"]
    K_eff = aux["K_eff"]

    h_p = th["l_p"] / N.p
    h_s = th["l_s"] / N.s
    h_n = th["l_n"] / N.n

    # one-sided ends, central interior, interface-aware differences at the
    # section boundaries; each end value is (B, 1)
    def fdl(x, hh):
        return (-3.0 * x[:, :1] + 4.0 * x[:, 1:2] - x[:, 2:3]) / (2.0 * hh)

    def fdr(x, hh):
        return (3.0 * x[:, -1:] - 4.0 * x[:, -2:-1] + x[:, -3:-2]) / (2.0 * hh)

    def central(x, hh):
        return (x[:, 2:] - x[:, :-2]) / (2.0 * hh)

    def acd_right(x_l, h_l, x_r, h_r):
        return 2.0 * (x_r[:, :1] - x_l[:, -2:-1]) / (3.0 * h_l + h_r)

    def acd_left(x_l, h_l, x_r, h_r):
        return 2.0 * (x_r[:, 1:2] - x_l[:, -1:]) / (h_l + 3.0 * h_r)

    def section_derivs(x_p, x_s, x_n):
        """d/dx per section; a half cell has no n section, and the
        separator's right end (the foil face) is one-sided."""
        d_p = torch.cat([fdl(x_p, h_p), central(x_p, h_p),
                         acd_right(x_p, h_p, x_s, h_s)], dim=-1)
        if hc:
            d_s = torch.cat([acd_left(x_p, h_p, x_s, h_s), central(x_s, h_s),
                             fdr(x_s, h_s)], dim=-1)
            return d_p, d_s, x_n[:, :0]
        d_s = torch.cat([acd_left(x_p, h_p, x_s, h_s), central(x_s, h_s),
                         acd_right(x_s, h_s, x_n, h_n)], dim=-1)
        d_n = torch.cat([acd_left(x_s, h_s, x_n, h_n), central(x_n, h_n),
                         fdr(x_n, h_n)], dim=-1)
        return d_p, d_s, d_n

    def electrode_deriv(x, hh):
        return torch.cat([fdl(x, hh), central(x, hh), fdr(x, hh)], dim=-1)

    Phi_s_p, Phi_s_n = Phi_s[:, :N.p], Phi_s[:, N.p:]
    dPhi_s_p = electrode_deriv(Phi_s_p, h_p)
    dPhi_s_n = Phi_s_n if hc else electrode_deriv(Phi_s_n, h_n)

    ps, pn = N.p, N.p + N.s
    dPhi_e_p, dPhi_e_s, dPhi_e_n = section_derivs(
        Phi_e[:, :ps], Phi_e[:, ps:pn], Phi_e[:, pn:])
    c_e_p, c_e_s, c_e_n = c_e[:, :ps], c_e[:, ps:pn], c_e[:, pn:]
    dc_e_p, dc_e_s, dc_e_n = section_derivs(c_e_p, c_e_s, c_e_n)

    j_p, j_n = j_tot[:, :N.p], j_tot[:, N.p:]
    Q_rev_p = F * aux["a_p"] * j_p * T_p * aux["dUdT_p"]
    Q_rev_n = F * aux["a_n"] * j_n * T_n * aux["dUdT_n"]
    Q_rxn_p = F * aux["a_p"] * j_p * aux["eta_p"]
    Q_rxn_n = F * aux["a_n"] * j_n * aux["eta_n"]

    nu_p, nu_s, nu_n = aux["nu"]
    K_p, K_s, K_n = K_eff[:, :ps], K_eff[:, ps:pn], K_eff[:, pn:]
    tp = 1.0 - th["t_plus"]
    sig_p, sig_n = aux["sigma_eff_p"], aux["sigma_eff_n"]
    Q_ohm_p = (K_p * dPhi_e_p**2
               + 2.0 * R * K_p * T_p * tp * nu_p / F * (dc_e_p / c_e_p) * dPhi_e_p
               + sig_p * dPhi_s_p**2)
    Q_ohm_s = (K_s * dPhi_e_s**2
               + 2.0 * R * K_s * T_s * tp * nu_s / F * (dc_e_s / c_e_s) * dPhi_e_s)
    Q_ohm_n = (K_n * dPhi_e_n**2
               + 2.0 * R * K_n * T_n * tp * nu_n / F * (dc_e_n / c_e_n) * dPhi_e_n
               + sig_n * dPhi_s_n**2)

    B = c_e.shape[0]
    I2 = aux["I_density"] ** 2
    za, zs, zz = _zeros(c_e, N.a), _zeros(c_e, N.s), _zeros(c_e, N.z)
    Q_rev = torch.cat([za, Q_rev_p, zs, Q_rev_n, zz], dim=-1)
    Q_rxn = torch.cat([za, Q_rxn_p, zs, Q_rxn_n, zz], dim=-1)
    Q_ohm = torch.cat([(I2 / th["sigma_a"]).expand(B, N.a),
                       Q_ohm_p, Q_ohm_s, Q_ohm_n,
                       (I2 / th["sigma_z"]).expand(B, N.z)], dim=-1)
    return Q_rev, Q_rxn, Q_ohm


# ---------------------------------------------------------------------------
# assembled residual
# ---------------------------------------------------------------------------

def residual_core(t, y, yp, th, cfg: ModelConfig):
    """Full DAE residual (B, N_tot) with the control (last) row left at 0,
    in the layout's order: differential states, then algebraic, I last."""
    num = cfg.numerics
    aux = build_auxiliary(t, y, th, cfg)
    parts = [_res_c_e(aux, yp, th, cfg), _res_c_s_avg(aux, y, yp, th, cfg)]
    if num.temperature:
        parts.append(_res_T(aux, y, yp, th, cfg))
    if num.aging == "SEI":
        parts.append(_res_film(aux, yp, th, cfg))
        parts.append(_res_SOH(aux, yp, th, cfg))
    if num.aging == "stress":
        parts.append(_res_eps_s(aux, y, yp, th, cfg))
    if num.solid_diffusion == "polynomial":
        parts.append(_res_Q(aux, y, yp, th, cfg))
    parts.append(_res_j(aux, th, cfg))
    parts.append(_res_Phi_e(aux, th, cfg))
    parts.append(_res_Phi_s(aux, th, cfg))
    if num.aging == "SEI":
        parts.append(_res_j_s(aux, y, th, cfg))
    parts.append(_zeros(y, 1))   # control row, filled by the solver
    return torch.cat(parts, dim=-1)

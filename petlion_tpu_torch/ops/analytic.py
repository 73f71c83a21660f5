"""Analytic (closed-form) assembly of the compressed Newton matrix
(counterpart of the JAX package's ``ops/analytic.py``).

Replaces the colored Jacobian sweeps (``ColoredJacobian.compressed``: one
stacked JVP of the full residual over 10 colors) with direct assembly of
J = ∂F/∂y + c0·∂F/∂yp for the structured residual families:

  * every differential row has ∂F/∂yp = −1 on its own diagonal and nothing
    else (res = rhs − yp), so c0·∂F/∂yp = −c0·E_diff;
  * the radial solid-diffusion operator is linear in c_s at fixed (j, D_s),
    rhs = (D_s/Rp²)·A₀·c + (B̃/Rp)·j with A₀, B̃ constant, so the (r × r)
    particle blocks are a per-cell scale of one host-computed matrix;
  * the c_e / Φ_e rows are tridiagonal flux stencils whose state dependence
    runs through elementwise transport closures (D_eff, K_eff, ν), and the
    j rows are elementwise kinetics: their derivatives are elementwise, each
    taken as the gradient of a sum (one reverse pass; ``torch.func.jvp``
    would go through a slow Python fallback);
  * the Φ_s rows are a constant tridiagonal plus constant j/I columns.

The control (last) row stays an exact reverse pass, as in the colored path.
Batch-first: every value carries a leading cells axis; the write plan (which
(row, column) each value lands on) is static host metadata, checked once
against the detected sparsity pattern, and the assembly is one scatter-add
into the (B, n_colors, N) compressed layout.

Scope, as in the JAX package: isothermal, no aging, Fickian radial
diffusion (finite differences or Chebyshev spectral), full cell. A D_s that
depends on the surface concentration adds one column to each particle
block. Anything else — and any pattern entry the closed forms do not cover —
raises ``Unsupported`` and the plan keeps the colored sweeps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import FARADAY as F, IDEAL_GAS as R
from ..physics.residuals import ModelConfig, active_material, calc_I1C, radial_rhs
from .dual import detach, grad_leaf, grad_seed
from .jacobian import last_row_grad


class Unsupported(Exception):
    pass


def _host_radial_A0_bj(n_r: int, radial):
    """The radial operator's constant parts, rhs(c, j; Rp, D_s) =
    (D_s/Rp²)·A₀·c + (B̃/Rp)·j, from autograd at Rp = D_s = 1 on the CPU in
    float64."""
    kw = dict(dtype=torch.float64)
    one = torch.ones((1, 1), **kw)

    def f_c(c):
        return radial(c[None], 0.0 * one, one, one, 1, n_r)[0]

    def f_j(jv):
        return radial(torch.zeros((1, n_r), **kw), jv[None], one, one, 1,
                      n_r)[0]

    jac = torch.autograd.functional.jacobian
    A0 = jac(f_c, torch.zeros(n_r, **kw)).numpy()
    bj = jac(f_j, torch.zeros(1, **kw))[:, 0].numpy()
    return A0, bj


def _ds_depends_on_c(cfg: ModelConfig, theta_sample: dict) -> bool:
    """Host-side probe: does D_s_eff vary with the surface concentration?"""
    th = {k: torch.tensor([[float(v)]], dtype=torch.float64)
          for k, v in theta_sample.items()}
    T = torch.full((1, 3), float(theta_sample.get("T0", 298.15)),
                   dtype=torch.float64)
    for c0 in (2.1e4, 3.7e4):
        c = torch.full((1, 3), c0, dtype=torch.float64)
        _, d = elementwise_derivatives(
            lambda cc: torch.cat(cfg.numerics.D_s_eff(cc, cc, T, T, th), -1), c)
        if bool((d[0] != 0).any()):
            return True
    return False


def elementwise_derivatives(fn, *xs):
    """fn(*xs) and ∂fn/∂x for each x, where output k depends only on the
    k-th entries of the inputs (so the jvp with a tangent of ones is the
    gradient of the sum). An input fn does not read gets zeros. Forward-mode
    tangents of the inputs and of what fn closes over are kept."""
    with torch.enable_grad():
        xs_ = [grad_leaf(x) for x in xs]
        out = fn(*xs_)
        total = out.sum()
        grads = (torch.autograd.grad(total, xs_, grad_seed(total), allow_unused=True)
                 if out.requires_grad else (None,) * len(xs_))
    return detach(out), tuple(torch.zeros_like(x) if g is None else g
                              for g, x in zip(grads, xs))


class AnalyticJacobian:
    """Static write plan + runtime assembly producing (JS, last) in the
    ColoredJacobian compressed layout: JS[b, color[col], row] = J[b, row, col]."""

    @staticmethod
    def supports(cfg: ModelConfig) -> bool:
        num = cfg.numerics
        return (not num.temperature and num.aging is None
                and num.solid_diffusion == "Fickian" and not cfg.half_cell)

    def __init__(self, cfg: ModelConfig, colored, theta_sample: dict):
        if not self.supports(cfg):
            raise Unsupported("config")
        self.cfg = cfg
        N, L = cfg.N, cfg.layout
        P, S, Nn = N.p, N.s, N.n
        n_ce = P + S + Nn
        self.n = L.N_tot
        self.A0_p, self.bj_p = _host_radial_A0_bj(N.r_p, radial_rhs(cfg.numerics))
        self.A0_n, self.bj_n = _host_radial_A0_bj(N.r_n, radial_rhs(cfg.numerics))
        self.ds_dep = _ds_depends_on_c(cfg, theta_sample)

        ce0 = L.sl("c_e").start
        cs0 = L.sl("c_s_avg").start
        j0 = L.sl("j").start
        pe0 = L.sl("Phi_e").start
        ps0 = L.sl("Phi_s").start
        iI = L.sl("I").start
        surf_p = L.c_s_surface_slice("p")          # (P,) global indices
        surf_n = L.c_s_surface_slice("n")
        self.el = np.concatenate([np.arange(P), P + S + np.arange(Nn)])

        # ---- static write plan: (name, rows, cols) ----------------------------
        writes = []

        def add(name, rows, cols):
            rows = np.asarray(rows, np.int64).reshape(-1)
            cols = np.asarray(cols, np.int64).reshape(-1)
            assert rows.shape == cols.shape, name
            writes.append((name, rows, cols))

        ar_ce = np.arange(n_ce)
        el = self.el
        # c_e rows: tridiagonal in c_e, and the j column of electrode CVs
        add("ce_lo", ce0 + ar_ce[1:], ce0 + ar_ce[:-1])
        add("ce_di", ce0 + ar_ce, ce0 + ar_ce)
        add("ce_up", ce0 + ar_ce[:-1], ce0 + ar_ce[1:])
        add("ce_j", ce0 + el, j0 + np.arange(P + Nn))

        # c_s particle blocks and their j column
        rp, rn = N.r_p, N.r_n
        rows_p = cs0 + (np.arange(P)[:, None] * rp + np.arange(rp)[None, :])
        rows_n = cs0 + P * rp + (np.arange(Nn)[:, None] * rn
                                 + np.arange(rn)[None, :])
        add("cs_blk_p", np.repeat(rows_p, rp, axis=1), np.tile(rows_p, (1, rp)))
        add("cs_blk_n", np.repeat(rows_n, rn, axis=1), np.tile(rows_n, (1, rn)))
        add("cs_j_p", rows_p, np.broadcast_to((j0 + np.arange(P))[:, None],
                                              (P, rp)))
        add("cs_j_n", rows_n, np.broadcast_to((j0 + P + np.arange(Nn))[:, None],
                                              (Nn, rn)))
        if self.ds_dep:
            # D_s(c_surf): the surface column of each particle block
            add("cs_ds_p", rows_p, np.broadcast_to(surf_p[:, None], (P, rp)))
            add("cs_ds_n", rows_n, np.broadcast_to(surf_n[:, None], (Nn, rn)))

        # j rows: diagonal, c_s surface, c_e, Φ_s, Φ_e
        jr = j0 + np.arange(P + Nn)
        add("j_diag", jr, jr)
        add("j_cs", jr, np.concatenate([surf_p, surf_n]))
        add("j_ce", jr, ce0 + el)
        add("j_ps", jr, ps0 + np.arange(P + Nn))
        add("j_pe", jr, pe0 + el)

        # Φ_e rows: tridiagonal in Φ_e and in c_e, the j column
        per = pe0 + ar_ce
        add("pe_pe_lo", per[1:], per[:-1])
        add("pe_pe_di", per, per)
        add("pe_pe_up", per[:-1], per[1:])
        add("pe_ce_lo", per[1:], ce0 + ar_ce[:-1])
        add("pe_ce_di", per, ce0 + ar_ce)
        add("pe_ce_up", per[:-1], ce0 + ar_ce[1:])
        add("pe_j", per[el], j0 + np.arange(P + Nn))

        # Φ_s rows: fixed tridiagonal per electrode, j diagonal, I column
        lo_r, lo_c, di, up_r, up_c = [], [], [], [], []
        for base, ne in ((0, P), (P, Nn)):
            idx = base + np.arange(ne)
            di.extend(idx)
            lo_r.extend(idx[1:])
            lo_c.extend(idx[:-1])
            up_r.extend(idx[:-1])
            up_c.extend(idx[1:])
        add("ps_lo", ps0 + np.array(lo_r), ps0 + np.array(lo_c))
        add("ps_di", ps0 + np.array(di), ps0 + np.array(di))
        add("ps_up", ps0 + np.array(up_r), ps0 + np.array(up_c))
        add("ps_j", ps0 + np.arange(P + Nn), j0 + np.arange(P + Nn))
        add("ps_I", np.array([ps0, ps0 + P + Nn - 1]), np.array([iI, iI]))

        # ---- coverage check against the detected pattern ----------------------
        pat = colored.pattern
        cover = np.zeros_like(pat)
        for _, rows, cols in writes:
            cover[rows, cols] = True
        body = pat.copy()
        body[-1, :] = False          # the control row is an exact reverse pass
        missing = body & ~cover
        if missing.any():
            ii, jj = np.nonzero(missing)
            raise Unsupported(
                f"{missing.sum()} pattern entries not covered by the closed "
                f"forms, e.g. rows {ii[:5]} cols {jj[:5]}")

        self._names = [w[0] for w in writes]
        rr = np.concatenate([w[1] for w in writes])
        cc = np.concatenate([w[2] for w in writes])
        # flat index into the (n_colors, N) compressed layout of one cell
        self._lin = colored.colors[cc].astype(np.int64) * self.n + rr
        self._mask = pat[rr, cc].astype(np.float64)
        self._n_colors = colored.n_colors

        # ---- algebraic sub-block (consistent initialization) ------------------
        # rows/cols restricted to the algebraic states; the substituted
        # control row is an exact reverse pass in plan.factor_alg
        nd = L.N_diff
        self.n_diff = nd
        n_alg = self.n - nd
        self._alg_names = ("j_diag", "j_ps", "j_pe",
                           "pe_pe_lo", "pe_pe_di", "pe_pe_up", "pe_j",
                           "ps_lo", "ps_di", "ps_up", "ps_j", "ps_I")
        by_name = {w[0]: w for w in writes}
        arr = np.concatenate([by_name[n][1] for n in self._alg_names])
        acc = np.concatenate([by_name[n][2] for n in self._alg_names])
        assert (arr >= nd).all() and (acc >= nd).all()
        self._alg_lin = (arr - nd) * n_alg + (acc - nd)
        self._alg_mask = pat[arr, acc].astype(np.float64)
        self._dev = {}

    # ---------------------------------------------------------------- helpers

    def _consts(self, like):
        """Static tensors on `like`'s device and dtype, built once."""
        key = (like.device, like.dtype)
        if key not in self._dev:
            kw = dict(dtype=like.dtype, device=like.device)
            N = self.cfg.N

            def lap_diag(ne):
                d = np.full(ne, -2.0)
                d[0] = d[-1] = -1.0
                return d

            self._dev[key] = dict(
                A0_p=torch.as_tensor(self.A0_p, **kw),
                A0_n=torch.as_tensor(self.A0_n, **kw),
                bj_p=torch.as_tensor(self.bj_p, **kw),
                bj_n=torch.as_tensor(self.bj_n, **kw),
                eye_p=torch.eye(N.r_p, **kw), eye_n=torch.eye(N.r_n, **kw),
                ps_di=torch.as_tensor(np.concatenate([lap_diag(N.p),
                                                      lap_diag(N.n)]), **kw),
                el=torch.as_tensor(self.el, device=like.device),
                lin=torch.as_tensor(self._lin, device=like.device),
                mask=torch.as_tensor(self._mask, **kw),
                alg_lin=torch.as_tensor(self._alg_lin, device=like.device),
                alg_mask=torch.as_tensor(self._alg_mask, **kw))
        return self._dev[key]

    def _common(self, y, th):
        """Per-cell quantities both assemblies use, (B, ·) tensors."""
        cfg, N = self.cfg, self.cfg.N
        L, num = cfg.layout, cfg.numerics
        P, S, Nn = N.p, N.s, N.n
        B = y.shape[0]
        q = dict(c_e=L.get(y, "c_e"), j=L.get(y, "j"), Phi_e=L.get(y, "Phi_e"),
                 Phi_s=L.get(y, "Phi_s"), c_star_p=L.c_s_surf(y, "p"),
                 c_star_n=L.c_s_surf(y, "n"))
        T0 = th["T0"]
        q.update(T_p=T0.expand(B, P), T_s=T0.expand(B, S), T_n=T0.expand(B, Nn))
        eps_sp, eps_sn = active_material(th)
        q.update(a_p=3.0 * eps_sp / th["Rp_p"], a_n=3.0 * eps_sn / th["Rp_n"],
                 sig_p=th["sigma_p"] * eps_sp, sig_n=th["sigma_n"] * eps_sn)
        z = torch.zeros((B, S), dtype=y.dtype, device=y.device)
        q["a_cells"] = torch.cat([q["a_p"].expand(B, P), z,
                                  q["a_n"].expand(B, Nn)], dim=-1)
        h = torch.cat([(th["l_p"] / P).expand(B, P), (th["l_s"] / S).expand(B, S),
                       (th["l_n"] / Nn).expand(B, Nn)], dim=-1)
        q.update(h=h, d_edge=0.5 * (h[:, :-1] + h[:, 1:]),
                 beta=h[:, :-1] / (h[:, :-1] + h[:, 1:]),
                 h_p=th["l_p"] / P, h_n=th["l_n"] / Nn)

        ce_p, ce_n = q["c_e"][:, :P], q["c_e"][:, P + S:]
        pe_p, pe_n = q["Phi_e"][:, :P], q["Phi_e"][:, P + S:]
        j, Phi_s = q["j"], q["Phi_s"]
        c_star_p, c_star_n = q["c_star_p"], q["c_star_n"]
        T_p, T_n = q["T_p"], q["T_n"]
        lam_p = th.get("lambda_MHC_p", 0.0)
        lam_n = th.get("lambda_MHC_n", 0.0)

        def jfun_p(cs, ce, shift):
            kp, _ = num.rxn_rate(T_p, T_n, cs, c_star_n, th)
            U, _ = num.OCV_p(cs / th["c_max_p"], T_p, th)
            eta = Phi_s[:, :P] - pe_p - U + shift
            return num.rxn_p(cs, ce, T_p, eta, kp, lam_p, th["c_max_p"], th)

        def jfun_n(cs, ce, shift):
            _, kn = num.rxn_rate(T_p, T_n, c_star_p, cs, th)
            U, _ = num.OCV_n(cs / th["c_max_n"], T_n, th)
            eta = Phi_s[:, P:] - pe_n - U + shift
            if "R_film_n" in th:
                eta = eta - j[:, P:] * F * th["R_film_n"]
            return num.rxn_n(cs, ce, T_n, eta, kn, lam_n, th["c_max_n"], th)

        # ∂j/∂c_s*, ∂j/∂c_e and ∂j/∂η per electrode, one reverse pass each
        q["dj_p"] = elementwise_derivatives(jfun_p, c_star_p, ce_p,
                                            torch.zeros_like(c_star_p))[1]
        q["dj_n"] = elementwise_derivatives(jfun_n, c_star_n, ce_n,
                                            torch.zeros_like(c_star_n))[1]
        return q

    def _algebraic_vals(self, q, th, K_edge, vals):
        """The writes both assemblies share, into `vals`: the j rows' diagonal
        and Φ columns, the Φ_e rows' Φ_e stencil and j column, the Φ_s rows."""
        N = self.cfg.N
        P, Nn = N.p, N.n
        B = K_edge.shape[0]
        c = self._consts(K_edge)
        dj_eta_p, dj_eta_n = q["dj_p"][2], q["dj_n"][2]
        diag_j_n = -torch.ones_like(dj_eta_n)
        if "R_film_n" in th:
            diag_j_n = diag_j_n + dj_eta_n * (-F * th["R_film_n"])
        vals["j_diag"] = torch.cat([-torch.ones_like(dj_eta_p), diag_j_n], -1)
        vals["j_ps"] = torch.cat([dj_eta_p, dj_eta_n], -1)
        vals["j_pe"] = -vals["j_ps"]
        ke_d = K_edge / q["d_edge"]
        z1 = torch.zeros_like(ke_d[:, :1])
        vals["pe_pe_up"] = -ke_d
        vals["pe_pe_lo"] = -ke_d
        # the ground row Φ_e[end] = 0: its only entry is the diagonal 1
        di = torch.cat([ke_d, z1], -1) + torch.cat([z1, ke_d], -1)
        vals["pe_pe_di"] = torch.cat([di[:, :-1], torch.ones_like(z1)], -1)
        vals["pe_j"] = -(q["h"] * F * q["a_cells"])[:, c["el"]]
        ones_lo = torch.ones((B, P - 1 + Nn - 1), dtype=K_edge.dtype,
                             device=K_edge.device)
        vals["ps_lo"] = ones_lo
        vals["ps_up"] = ones_lo
        vals["ps_di"] = c["ps_di"].expand(B, -1)
        h_p, h_n, a_p, a_n = q["h_p"], q["h_n"], q["a_p"], q["a_n"]
        vals["ps_j"] = torch.cat([
            (-h_p**2 * a_p * F / q["sig_p"]).expand(B, P),
            (-h_n**2 * a_n * F / q["sig_n"]).expand(B, Nn)], -1)
        I1C = calc_I1C(th)
        vals["ps_I"] = torch.cat([h_p * I1C / q["sig_p"],
                                  -h_n * I1C / q["sig_n"]], -1)

    @staticmethod
    def _scatter(vals, names, lin, mask, B, size):
        flat = torch.cat([vals[n].reshape(B, -1) for n in names], dim=1) * mask
        out = torch.zeros((B, size), dtype=flat.dtype, device=flat.device)
        return out.index_add_(1, lin, flat)

    # -------------------------------------------------------------------- run

    def alg_block(self, y, th):
        """Dense (B, n_alg, n_alg) algebraic Jacobian block (rows j/Φ_e/Φ_s;
        the control row is left zero: plan.factor_alg sets it by a reverse
        pass)."""
        cfg, N = self.cfg, self.cfg.N
        num = cfg.numerics
        P, S = N.p, N.s
        q = self._common(y, th)
        c_e = q["c_e"]
        K_cell = torch.cat(num.K_eff(c_e[:, :P], c_e[:, P:P + S], c_e[:, P + S:],
                                     q["T_p"], q["T_s"], q["T_n"], th), -1)
        beta = q["beta"]
        K_edge = K_cell[:, :-1] * K_cell[:, 1:] / (beta * K_cell[:, 1:]
                                                   + (1.0 - beta) * K_cell[:, :-1])
        vals = {}
        self._algebraic_vals(q, th, K_edge, vals)
        c = self._consts(y)
        n_alg = self.n - self.n_diff
        B = y.shape[0]
        J = self._scatter(vals, self._alg_names, c["alg_lin"], c["alg_mask"], B,
                          n_alg * n_alg)
        return J.reshape(B, n_alg, n_alg)

    def compressed(self, t, y, c0, th, g, data):
        """(JS, last): the analytic physics rows in the compressed layout,
        (B, n_colors, N), and the exact reverse-pass control row, (B, N).
        c0 is (B,) or (B, 1); `g(y, data)` is the composed map
        y ↦ F(t, y, c0·y + const), used for the control row only (the
        isothermal closed forms do not read t; it is kept for the JAX
        package's signature)."""
        cfg, N = self.cfg, self.cfg.N
        num = cfg.numerics
        P, S, Nn = N.p, N.s, N.n
        rp, rn = N.r_p, N.r_n
        B = y.shape[0]
        c0 = c0.reshape(B, 1)
        c = self._consts(y)
        q = self._common(y, th)
        c_e, j, Phi_e = q["c_e"], q["j"], q["Phi_e"]
        T_p, T_s, T_n = q["T_p"], q["T_s"], q["T_n"]
        h, d_edge, beta, a_cells = q["h"], q["d_edge"], q["beta"], q["a_cells"]
        porosity = torch.cat([th["eps_p"].expand(B, P), th["eps_s"].expand(B, S),
                              th["eps_n"].expand(B, Nn)], -1)

        def split3(x):
            return x[:, :P], x[:, P:P + S], x[:, P + S:]

        # transport closures and their elementwise derivatives in c_e
        D_cell, (dD_cell,) = elementwise_derivatives(
            lambda x: torch.cat(num.D_eff(*split3(x), T_p, T_s, T_n, th), -1), c_e)
        K_cell, (dK_cell,) = elementwise_derivatives(
            lambda x: torch.cat(num.K_eff(*split3(x), T_p, T_s, T_n, th), -1), c_e)
        nu_cell, (dnu_cell,) = elementwise_derivatives(
            lambda x: torch.cat(num.thermodynamic_factor(*split3(x), T_p, T_s, T_n,
                                                         th), -1), c_e)

        def harm(x):
            return x[:, :-1] * x[:, 1:] / (beta * x[:, 1:] + (1.0 - beta) * x[:, :-1])

        def dharm(x):
            """(∂H/∂x_left, ∂H/∂x_right) per edge."""
            M = beta * x[:, 1:] + (1.0 - beta) * x[:, :-1]
            return beta * x[:, 1:] ** 2 / M**2, (1.0 - beta) * x[:, :-1] ** 2 / M**2

        D_edge = harm(D_cell)
        dDe_l, dDe_r = dharm(D_cell)
        K_edge = harm(K_cell)
        dKe_l, dKe_r = dharm(K_cell)
        ce_edge = harm(c_e)
        dce_l, dce_r = dharm(c_e)
        T_edge = harm(torch.cat([T_p, T_s, T_n], -1))
        gc = (c_e[:, 1:] - c_e[:, :-1]) / d_edge
        gPhi = (Phi_e[:, 1:] - Phi_e[:, :-1]) / d_edge
        z1 = torch.zeros_like(gc[:, :1])

        def shift_l(x):      # x_e placed at cell e (the cell left of edge e)
            return torch.cat([x, z1], -1)

        def shift_r(x):      # x_e placed at cell e+1
            return torch.cat([z1, x], -1)

        vals = {}
        # ---- c_e rows: res_i = [(fr − fl)/h_i + src_i]/eps_i − c0·δ
        dfl = dDe_l * dD_cell[:, :-1] * gc - D_edge / d_edge
        dfr = dDe_r * dD_cell[:, 1:] * gc + D_edge / d_edge
        inv_he = 1.0 / (h * porosity)
        vals["ce_up"] = dfr * inv_he[:, :-1]
        vals["ce_lo"] = -dfl * inv_he[:, 1:]
        diag_flux = (shift_l(dfl) - shift_r(dfr)) * inv_he
        j_cells = torch.cat([j[:, :P], torch.zeros_like(h[:, P:P + S]), j[:, P:]],
                            -1)
        diag_src = (1.0 - th["t_plus"]) * dnu_cell * a_cells * j_cells / porosity
        vals["ce_di"] = diag_flux + diag_src - c0
        vals["ce_j"] = ((1.0 - th["t_plus"]) * nu_cell * a_cells
                        / porosity)[:, c["el"]]

        # ---- c_s particle blocks: (D_s/Rp²)·A₀ − c0·I and the j column
        D_s_p, D_s_n = num.D_s_eff(q["c_star_p"], q["c_star_n"], T_p, T_n, th)
        blk_p = ((D_s_p / th["Rp_p"] ** 2)[..., None, None] * c["A0_p"]
                 - c0[..., None, None] * c["eye_p"])
        blk_n = ((D_s_n / th["Rp_n"] ** 2)[..., None, None] * c["A0_n"]
                 - c0[..., None, None] * c["eye_n"])
        vals["cs_blk_p"] = blk_p
        vals["cs_blk_n"] = blk_n
        vals["cs_j_p"] = (c["bj_p"] / th["Rp_p"])[:, None, :].expand(B, P, rp)
        vals["cs_j_n"] = (c["bj_n"] / th["Rp_n"])[:, None, :].expand(B, Nn, rn)
        if self.ds_dep:
            # ∂rhs/∂c_surf through D_s: (rhs − B̃·j/Rp)/D_s · dD_s/dc_surf
            c_star_p, c_star_n = q["c_star_p"], q["c_star_n"]
            dDs_p = elementwise_derivatives(
                lambda x: num.D_s_eff(x, c_star_n, T_p, T_n, th)[0], c_star_p)[1][0]
            dDs_n = elementwise_derivatives(
                lambda x: num.D_s_eff(c_star_p, x, T_p, T_n, th)[1], c_star_n)[1][0]
            radial = radial_rhs(num)
            L = cfg.layout
            rhs_p = radial(L.get(y, "c_s_avg", "p"), j[:, :P], th["Rp_p"], D_s_p,
                           P, rp).reshape(B, P, rp)
            rhs_n = radial(L.get(y, "c_s_avg", "n"), j[:, P:], th["Rp_n"], D_s_n,
                           Nn, rn).reshape(B, Nn, rn)
            bjp = (c["bj_p"] / th["Rp_p"])[:, None, :]
            bjn = (c["bj_n"] / th["Rp_n"])[:, None, :]
            vals["cs_ds_p"] = ((rhs_p - bjp * j[:, :P, None]) / D_s_p[..., None]
                               * dDs_p[..., None])
            vals["cs_ds_n"] = ((rhs_n - bjn * j[:, P:, None]) / D_s_n[..., None]
                               * dDs_n[..., None])

        # ---- j rows: elementwise kinetics
        dj_cs_p, dj_ce_p, _ = q["dj_p"]
        dj_cs_n, dj_ce_n, _ = q["dj_n"]
        vals["j_cs"] = torch.cat([dj_cs_p, dj_cs_n], -1)
        vals["j_ce"] = torch.cat([dj_ce_p, dj_ce_n], -1)

        # ---- Φ_e rows: res_i = −(fr − fl) − f_i, f_i = −Kfac_i·(pr − pl) + h·F·a·j
        # with the migration product prod_e = Ke·Te·gc/ce
        prod = K_edge * T_edge * gc / ce_edge
        Kfac = 2.0 * R * (1.0 - th["t_plus"]) * nu_cell / F
        dKfac = 2.0 * R * (1.0 - th["t_plus"]) * dnu_cell / F
        com = T_edge / ce_edge
        dp_l = (dKe_l * dK_cell[:, :-1] * gc * com - K_edge * com / d_edge
                - K_edge * T_edge * gc / ce_edge**2 * dce_l)
        dp_r = (dKe_r * dK_cell[:, 1:] * gc * com + K_edge * com / d_edge
                - K_edge * T_edge * gc / ce_edge**2 * dce_r)
        dfK_l = dKe_l * dK_cell[:, :-1] * gPhi
        dfK_r = dKe_r * dK_cell[:, 1:] * gPhi
        vals["pe_ce_up"] = -dfK_r + Kfac[:, :-1] * dp_r
        vals["pe_ce_lo"] = dfK_l - Kfac[:, 1:] * dp_l
        vals["pe_ce_di"] = (-(shift_l(dfK_l) - shift_r(dfK_r))
                            + Kfac * (shift_l(dp_l) - shift_r(dp_r))
                            + dKfac * (shift_l(prod) - shift_r(prod)))

        # ---- j diagonal/Φ columns, Φ_e stencil, Φ_s rows
        self._algebraic_vals(q, th, K_edge, vals)

        JS = self._scatter(vals, self._names, c["lin"], c["mask"], B,
                           self._n_colors * self.n)
        return JS.reshape(B, self._n_colors, self.n), last_row_grad(g, y, data)

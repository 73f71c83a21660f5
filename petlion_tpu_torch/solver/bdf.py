"""Adaptive variable-order BDF integrator for implicit DAEs, batch-first
(counterpart of the JAX package's ``solver/bdf.py``).

Formulation (backward-difference form, pure BDF as in IDA):

    state carries D[:, j] = ∇ʲ y  (j = 0..order+2) at the current step size h
    predictor     y_pred = Σ_{j≤k} D[j]
    corrector     y = y_pred + d solves F(t+h, y, yp(d)) = 0,
                  yp = (γ_k d + Σ_{j=1..k} γ_j D[j]) / h
    Newton matrix J = ∂F/∂y + (γ_k/h) ∂F/∂yp
    LTE estimate  err = d / (k+1), weighted-RMS against atol + rtol·|y|

Every state tensor has a leading cells axis and every per-cell decision
(order, step size, acceptance, Newton convergence) is a mask, so cells at
different orders and step sizes advance together. Rows of the difference
array are picked per cell by comparing the row index with the cell's order.
The host drives one attempt per call of `Stepper.step`; the Newton
iterations run masked, with no host synchronization inside.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple

import numpy as np
import torch

MAX_ORDER = 5
_D_ROWS = MAX_ORDER + 3

MIN_FACTOR = 0.2
MAX_FACTOR = 10.0
SAFETY = 0.9

# status codes
OK = 0
UNRECOVERABLE = 2


@lru_cache(maxsize=None)
def _constants(device: torch.device, dtype: torch.dtype):
    """(γ, error constants, 1e-300) on the run's device, made once: a host
    copy per attempt would also synchronize the host with the device."""
    g = np.hstack([0.0, np.cumsum(1.0 / np.arange(1, MAX_ORDER + 2))])
    # pure BDF: err_const[k] = 1/(k+1)
    e = 1.0 / np.arange(1, MAX_ORDER + 3, dtype=np.float64)
    kw = dict(dtype=dtype, device=device)
    return (torch.as_tensor(g, **kw), torch.as_tensor(e, **kw),
            torch.tensor(1e-300, **kw))


def _gammas(like):
    return _constants(like.device, like.dtype)[0]


def _error_const(like):
    return _constants(like.device, like.dtype)[1]


def wrms(x, scale):
    return torch.sqrt(torch.mean((x / scale) ** 2, dim=-1))


def _bmask(mask, like):
    """Broadcast a (B,) mask against a (B, ...) tensor."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def _select(mask, a, b):
    return torch.where(_bmask(mask, a), a, b)


def _R_matrix(factor):
    """R[b,i,j] = Π_{m=1..i} (m-1-factor_b·j)/m, R[:,0,:]=1, R[:,i>0,0]=0."""
    kw = dict(dtype=factor.dtype, device=factor.device)
    i = torch.arange(1, _D_ROWS, **kw)[:, None]
    j = torch.arange(1, _D_ROWS, **kw)[None, :]
    M = torch.zeros(factor.shape + (_D_ROWS, _D_ROWS), **kw)
    M[..., 1:, 1:] = (i - 1.0 - factor[..., None, None] * j) / i
    M[..., 0, :] = 1.0
    return torch.cumprod(M, dim=-2)


def change_D(D, order, factor):
    """Rescale the (B, 8, N) difference array for per-cell step changes
    h -> h·factor; rows 0..order are transformed, higher rows kept."""
    R = _R_matrix(factor)
    U = _R_matrix(torch.ones_like(factor))
    mask = torch.arange(_D_ROWS, device=D.device)[None, :] <= order[:, None]
    # RU[j,i] = Σ_{m<=order} R[j,m] U[m,i]
    RU = torch.matmul(R * mask[:, None, :], U * mask[:, :, None])
    Dm = torch.where(mask[:, :, None], D, 0.0)
    D_new = torch.matmul(RU.transpose(-1, -2), Dm)
    return torch.where(mask[:, :, None], D_new, D)


class BDFState(NamedTuple):
    t: torch.Tensor            # (B,) current time
    h: torch.Tensor            # (B,) next step size
    order: torch.Tensor        # (B,) current order
    D: torch.Tensor            # (B, MAX_ORDER+3, N) difference array at h
    n_equal: torch.Tensor      # accepted steps since last h/order change
    status: torch.Tensor       # OK / UNRECOVERABLE
    yp: torch.Tensor           # (B, N) derivative at t
    n_steps: torch.Tensor
    n_rejected: torch.Tensor
    n_fails: torch.Tensor      # consecutive failures at the current point

    @property
    def y(self):
        return self.D[:, 0]


def select_state(mask, a: BDFState, b: BDFState) -> BDFState:
    return BDFState(*(_select(mask, x, y) for x, y in zip(a, b)))


def bdf_init(t0, y0, yp0, h0):
    B, N = y0.shape
    kw = dict(dtype=y0.dtype, device=y0.device)
    D = torch.zeros((B, _D_ROWS, N), **kw)
    D[:, 0] = y0
    D[:, 1] = yp0 * h0[:, None]
    i64 = lambda v: torch.full((B,), v, dtype=torch.int64, device=y0.device)  # noqa: E731
    return BDFState(
        t=torch.full((B,), float(t0), **kw), h=h0, order=i64(1), D=D,
        n_equal=i64(0), status=i64(OK), yp=yp0, n_steps=i64(0),
        n_rejected=i64(0), n_fails=i64(0))


def restart(state: BDFState, mask, t, y, yp, h) -> BDFState:
    """The cells in `mask` restart from (t, y, yp) with step h at order 1,
    as after a fresh initialization (D[0] = y, D[1] = yp·h, the rest 0;
    n_equal 0); the counters and status carry on. The other cells keep
    `state`."""
    D = torch.zeros_like(state.D)
    D[:, 0] = y
    D[:, 1] = yp * h[:, None]
    new = state._replace(t=t, h=h, order=torch.ones_like(state.order), D=D,
                         n_equal=torch.zeros_like(state.n_equal), yp=yp)
    return select_state(mask, new, state)


def initial_step_size(y0, yp0, atol, rtol, t_span):
    """SciPy-style h0 heuristic, clipped to the run horizon `t_span` (a
    number or (B,)); (B,)."""
    scale = atol + rtol * y0.abs()
    d0 = wrms(y0, scale)
    d1 = wrms(yp0, scale)
    h0 = 0.01 * d0 / torch.clamp_min(d1, 1e-10)
    h0 = torch.where(torch.isfinite(h0) & (h0 > 0), h0, 1e-4)
    h0 = torch.clamp_min(h0, 1e-10)
    hi = 0.1 * t_span
    return torch.minimum(h0, hi) if torch.is_tensor(hi) else torch.clamp_max(h0, hi)


def dense_eval(D, h, order, t_head, t):
    """Dense output of the BDF interpolating polynomial at per-cell times
    `t` inside the last accepted step: (y, yp), each (B, N)."""
    theta = (t - t_head) / h
    y = D[:, 0]
    yp = torch.zeros_like(y)
    c = torch.ones_like(theta)
    dc = torch.zeros_like(theta)
    for j in range(1, _D_ROWS):
        dc = (dc * (theta + j - 1.0) + c) / j
        c = c * (theta + j - 1.0) / j
        take = j <= order
        y = y + torch.where(take, c, 0.0)[:, None] * D[:, j]
        yp = yp + torch.where(take, dc, 0.0)[:, None] * D[:, j]
    return y, yp / h[:, None]


def _row(D, idx):
    """D[b, idx[b]] for a per-cell row index, (B, N)."""
    return torch.gather(D, 1, idx.reshape(-1, 1, 1).expand(-1, 1, D.shape[-1]))[:, 0]


def predict(state: BDFState, t_bound, hmin, hmax):
    """Attempt prologue: clip h, rescale D, form the predictor and the BDF
    leading coefficient."""
    gam = _gammas(state.D)
    k = state.order
    ar = torch.arange(_D_ROWS, device=k.device)[None, :]
    h = torch.clamp(state.h, hmin, hmax)
    h = torch.minimum(h, torch.clamp_min(t_bound - state.t, hmin))
    D = change_D(state.D, k, h / state.h)
    t_new = state.t + h
    y_pred = torch.sum(torch.where((ar <= k[:, None])[..., None], D, 0.0), dim=1)
    gmask = (ar >= 1) & (ar <= k[:, None])
    # γ has MAX_ORDER+2 entries; the rows past it are masked out (JAX clamps
    # the out-of-range gather the same way)
    gam_rows = gam[torch.clamp_max(ar[0], MAX_ORDER + 1)]
    S = torch.sum(torch.where(gmask[..., None], gam_rows[None, :, None] * D, 0.0),
                  dim=1)
    c0 = gam[k] / h
    return h, D, t_new, y_pred, c0, S / h[:, None]


class Stepper:
    """The BDF attempt and the greedy retry bookkeeping.

    F(t, y, yp) -> residual (B, N) for the run's cells.
    jac_and_factor(t, y_pred, c0, psi_over_h) -> factorization.
    linsolve(factorization, b) -> x solving (Fy + c0·Fyp) x = b.
    """

    def __init__(self, F: Callable, jac_and_factor: Callable,
                 linsolve: Callable, atol, rtol, newton_maxiter: int = 4,
                 hmin: float = 1e-10, hmax: float = np.inf,
                 max_attempts: int = 100, step_control: str = "greedy"):
        if step_control != "greedy":
            raise NotImplementedError(f"step_control={step_control!r}")
        self.F, self.jac_and_factor, self.linsolve = F, jac_and_factor, linsolve
        self.atol, self.rtol = atol, rtol
        self.newton_maxiter = newton_maxiter
        self.hmin, self.hmax = hmin, hmax
        self.max_attempts = max_attempts
        # float64 eps even in float32, as the JAX package does
        self.newton_tol = max(10 * np.finfo(np.float64).eps / rtol,
                              min(0.03, rtol ** 0.5))

    def _newton(self, t_new, y_pred, c0, psi_over_h, J_lu, scale):
        tol = self.newton_tol
        B = y_pred.shape[0]
        dev = y_pred.device
        d = torch.zeros_like(y_pred)
        dnorm_old = torch.zeros(B, dtype=y_pred.dtype, device=dev)
        conv = torch.zeros(B, dtype=torch.bool, device=dev)
        div = torch.zeros(B, dtype=torch.bool, device=dev)
        for it in range(self.newton_maxiter):
            live = ~conv & ~div
            r = self.F(t_new, y_pred + d, c0[:, None] * d + psi_over_h)
            delta = self.linsolve(J_lu, -r)
            d_new = d + delta
            dnorm = wrms(delta, scale)
            rate = dnorm / torch.clamp_min(dnorm_old, 1e-300)
            have_rate = it > 0
            if have_rate:
                conv_now = torch.where(rate < 1.0,
                                       rate / (1.0 - rate) * dnorm < tol,
                                       dnorm == 0.0)
            else:
                conv_now = dnorm == 0.0
            # also accept an immediately tiny first update
            conv_now = conv_now | (dnorm < 0.01 * tol)
            if have_rate:
                # stall acceptance at the f32 linear-solve noise floor
                conv_now = conv_now | (dnorm < tol)
                div_now = (rate >= 1.0) & (dnorm > tol)
            else:
                div_now = torch.zeros_like(conv_now)
            d = _select(live, d_new, d)
            dnorm_old = torch.where(live, dnorm, dnorm_old)
            conv = conv | (live & conv_now)
            div = div | (live & div_now)
        return conv & ~div, d

    def attempt(self, state: BDFState, t_bound):
        """One step attempt for every cell: (new_state, accepted)."""
        errc = _error_const(state.D)
        k = state.order
        kf = k.to(state.D.dtype)
        ar = torch.arange(_D_ROWS, device=k.device)[None, :]
        atol, rtol = self.atol, self.rtol

        h, D, t_new, y_pred, c0, psi_over_h = predict(state, t_bound,
                                                      self.hmin, self.hmax)
        scale = atol + rtol * y_pred.abs()
        J_lu = self.jac_and_factor(t_new, y_pred, c0, psi_over_h)
        conv, d = self._newton(t_new, y_pred, c0, psi_over_h, J_lu, scale)

        y = y_pred + d
        yp = c0[:, None] * d + psi_over_h
        scale_y = atol + rtol * y.abs()
        inf = torch.full_like(h, float("inf"))
        errnorm = torch.where(conv, wrms(errc[k][:, None] * d, scale_y), inf)
        accept = errnorm <= 1.0

        # ---------- rejected: shrink h, rescale D --------------------------
        shrink = torch.where(
            conv,
            torch.clamp(SAFETY * errnorm ** (-1.0 / (kf + 1.0)), MIN_FACTOR, 0.9),
            torch.full_like(h, 0.25))
        n_fails = state.n_fails + 1
        # order-1 restart after repeated failures at one point: rebuild the
        # history from the last accepted (y, yp) with a much smaller step
        restart = n_fails >= 3
        h_restart = h * 0.1
        D_restart = torch.zeros_like(D)
        D_restart[:, 0] = state.D[:, 0]
        D_restart[:, 1] = state.yp * h_restart[:, None]
        zero = torch.zeros_like(k)
        st_rej = state._replace(
            h=torch.where(restart, h_restart, h * shrink),
            D=_select(restart, D_restart, change_D(D, k, shrink)),
            order=torch.where(restart, torch.ones_like(k), k),
            n_equal=zero,
            n_rejected=state.n_rejected + 1,
            n_fails=torch.where(restart, zero, n_fails))

        # ---------- accepted: update differences ---------------------------
        D1 = torch.where((ar == k[:, None] + 2)[..., None],
                         (d - _row(D, k + 1))[:, None, :], D)
        D1 = torch.where((ar == k[:, None] + 1)[..., None], d[:, None, :], D1)
        # suffix-sum rows 0..k over rows i..k+1
        Dm = torch.where((ar <= k[:, None] + 1)[..., None], D1, 0.0)
        suffix = torch.flip(torch.cumsum(torch.flip(Dm, [1]), dim=1), [1])
        D_acc = torch.where((ar <= k[:, None])[..., None], suffix, D1)

        n_equal = state.n_equal + 1

        # order/step adaptation, evaluated for every cell and selected
        em = torch.where(k > 1, wrms(errc[k - 1][:, None] * _row(D_acc, k),
                                     scale_y), inf)
        ep = torch.where(k < MAX_ORDER,
                         wrms(errc[k + 1][:, None] * _row(D_acc, k + 2),
                              scale_y), inf)
        tiny = _constants(h.device, h.dtype)[2]
        fm = torch.maximum(em, tiny) ** (-1.0 / kf)
        f0 = torch.maximum(errnorm, tiny) ** (-1.0 / (kf + 1.0))
        fp = torch.maximum(ep, tiny) ** (-1.0 / (kf + 2.0))
        fs = torch.stack([fm, f0, fp], dim=-1)
        best = torch.argmax(fs, dim=-1)
        k_new = k + best - 1
        raw = SAFETY * torch.gather(fs, 1, best[:, None])[:, 0]
        factor = torch.clamp(raw, MIN_FACTOR, MAX_FACTOR)
        D_new = change_D(D_acc, k_new, factor)
        # exact no-op when h is held
        D_new = _select(factor == 1.0, D_acc, D_new)

        adapt = n_equal > k + 1
        st_acc = BDFState(
            t=t_new, h=torch.where(adapt, h * factor, h),
            order=torch.where(adapt, k_new, k),
            D=_select(adapt, D_new, D_acc),
            n_equal=torch.where(adapt, zero, n_equal),
            status=state.status, yp=yp,
            n_steps=state.n_steps + 1, n_rejected=state.n_rejected,
            n_fails=zero)

        new_state = select_state(accept, st_acc, st_rej)
        underflow = (~accept) & (new_state.h <= 2 * self.hmin)
        new_state = new_state._replace(status=torch.where(
            underflow, torch.full_like(k, UNRECOVERABLE), new_state.status))
        return new_state, accept

    def step(self, state: BDFState, t_bound, tries):
        """One attempt of the greedy accepted-step loop.

        Returns (state, accepted, done, tries): a cell's step is done when
        the attempt is accepted, the status is no longer OK, or it has used
        `max_attempts` attempts; a step that ends un-accepted is terminal
        (UNRECOVERABLE). `tries` counts the attempts of the current step."""
        st, acc = self.attempt(state, t_bound)
        tries = tries + 1
        done = acc | (st.status != OK) | (tries >= self.max_attempts)
        st = st._replace(status=torch.where(
            done & ~acc, torch.full_like(st.status, UNRECOVERABLE), st.status))
        return st, acc, done, tries

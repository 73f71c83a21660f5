"""Batched run driver: consistent init → BDF loop → events → back-interp
(counterpart of the JAX package's ``solver/run.py:run_once``, written batch-first).

The JAX package vmaps a single-cell `lax.while_loop`. Here every state
tensor carries the cells axis and the host drives the loop: each trip makes
one BDF attempt for every cell, applies it to the cells still running, and
does the step bookkeeping (SOC, recording, events) for the cells whose step
ended. That is one host synchronization per trip (`active.any()`, read
together with whether some cell needs a factorization under Jacobian
reuse), and a second on a run with a function input (whether some cell's
input jumped, which a re-initialization then handles for those cells).
Cells are independent, so each goes through the same arithmetic as under
the JAX while-loops, and its result is the same.

Jacobian reuse (``opts.jac_reuse`` = K > 0, the JAX package's ``K_REUSE``
chunks): each cell carries its own factorization, the leading coefficient
`c0_f` it was made at and its trips in the chunk. A cell refactors, at the
predictor of its next attempt, when its chunk starts: after K trips, when
`bdf.cj_ok` fails, after a rejected step's drift exit, or after a
re-initialization. A trip on which some cell refactors factors every cell
and keeps the new factor only for those (`_select_tree`): the batch keeps
its shape, so each cell's factor is the same whichever other cells
refactor with it.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import torch

from ..config import EXIT_FAILED, EXIT_SIMULATING, SimOptions
from ..ops.jacobian import newton_system
from ..physics.residuals import ModelConfig, calc_I1C
from . import bdf, control, events, linsolve
from .newton import consistent_init

SCALAR_OUTPUTS = ("t", "V", "I", "P", "SOC")
VECTOR_OUTPUTS = ("c_e", "c_s_avg", "T", "film", "Q", "j", "j_s",
                  "Phi_e", "Phi_s", "SOH", "eps_s", "Y", "YP")

# key under which each cell's setpoint rides along with θ through the tiled
# Jacobian sweeps
_VALUE = "_ctrl_value"


class RunnerState(NamedTuple):
    bdf: bdf.BDFState
    soc: torch.Tensor
    prev: events.BoundsPrev
    flag: torch.Tensor
    save_idx: torch.Tensor
    y_prev: torch.Tensor
    t_prev: torch.Tensor
    soc_prev: torch.Tensor


class RunResultDev(NamedTuple):
    """Result of one batched run; every field has a leading cells axis."""
    bufs: dict
    n_saved: torch.Tensor
    flag: torch.Tensor
    y0_run: torch.Tensor          # state after consistent initialization
    y_final: torch.Tensor
    yp_final: torch.Tensor
    soc_final: torch.Tensor
    t_final: torch.Tensor
    n_steps: torch.Tensor
    n_rejected: torch.Tensor
    init_converged: torch.Tensor
    truncated: torch.Tensor       # output ring overflowed: tail overwritten


def _select(mask, a, b):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim)),
                       a, b)


def _select_tree(mask, a, b):
    """Per-cell select over nested (named) tuples of tensors, each with a
    leading cells axis; the tuples keep their types."""
    if not isinstance(a, tuple):
        return _select(mask, a, b)
    vals = [_select_tree(mask, x, y) for x, y in zip(a, b)]
    return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)


def _vector_outputs(opts: SimOptions, cfg: ModelConfig):
    L = cfg.layout
    want_all = "all" in opts.outputs
    outs = []
    for name in VECTOR_OUTPUTS:
        present = name in ("Y", "YP") or name in L
        if present and (want_all or name in opts.outputs):
            outs.append(name)
    return tuple(outs)


def _make_bufs(opts: SimOptions, cfg: ModelConfig, vec_outs, like):
    B, n = like.shape[0], opts.max_save
    L = cfg.layout
    kw = dict(dtype=like.dtype, device=like.device)
    bufs = {k: torch.zeros((B, n), **kw) for k in SCALAR_OUTPUTS}
    for name in vec_outs:
        if name in ("Y", "YP"):
            m = L.N_tot
        else:
            s = L.sl(name)
            m = s.stop - s.start
        bufs[name] = torch.zeros((B, n, m), **kw)
    return bufs


def _record(bufs, idx, write, t, y, yp, soc, th, cfg: ModelConfig, vec_outs):
    """Write slot `idx[b]` of every buffer for the cells where `write[b]`
    (in place: the buffers belong to the run)."""
    L = cfg.layout
    V = L.V(y)
    I = L.I(y)
    vals = dict(t=t, V=V, I=I, P=I * calc_I1C(th)[:, 0] * V, SOC=soc)
    # recorded states carry absolute T [K]; the solver state carries
    # T − T_amb. YP is a rate, the same in both
    has_T = cfg.numerics.temperature
    for name in vec_outs:
        if name == "YP":
            vals[name] = yp
        elif name == "Y":
            vals[name] = absolute_T(y, th, cfg) if has_T else y
        elif name == "T":
            vals[name] = L.get(y, "T") + th["T_amb"]
        else:
            vals[name] = L.get(y, name)
    b = torch.arange(idx.shape[0], device=idx.device)
    for name, val in vals.items():
        buf = bufs[name]
        buf[b, idx] = _select(write, val, buf[b, idx])


def absolute_T(y, th, cfg: ModelConfig, sign: float = 1.0):
    """`y` (B, N) with sign·T_amb added to its T states: the solver's
    T − T_amb state to absolute kelvin, or back with sign = −1."""
    s = cfg.layout.sl("T")
    return torch.cat([y[:, :s.start], y[:, s] + sign * th["T_amb"],
                      y[:, s.stop:]], dim=-1)


def initial_current_guess(spec: control.ControlSpec, value, y0, th,
                          cfg: ModelConfig, prev_I, has_prev):
    """Y0 with its current seeded per control method, (B, N). `prev_I` and
    `has_prev` (B,) carry the last current of a continued run, which P, V,
    η_p and res reuse."""
    L = cfg.layout
    m = spec.method
    if m == "res":
        I_guess = torch.where(has_prev, prev_I, torch.ones_like(prev_I))
    else:
        t0 = torch.zeros_like(value)
        v0 = control.control_value(spec, value, t0, y0, torch.zeros_like(y0), th)
        if m == "I":
            I_guess = v0
        elif m == "P":
            I_guess = torch.where(has_prev, prev_I,
                                  v0 / (L.V(y0) * calc_I1C(th)[:, 0]))
        else:  # V, eta_p
            sign = torch.where(v0 > L.V(y0), 1.0, -1.0).to(y0.dtype)
            I_guess = torch.where(has_prev & (prev_I != 0), prev_I, sign)
    y0 = y0.clone()
    y0[:, L.sl("I").start] = I_guess
    return y0


# over every run since the last reset: the outer trips, the trips that ran
# a re-initialization after an input discontinuity and the host seconds
# spent in those re-initializations, the trips that factored the Newton
# matrix, and each run's factorizations per cell ((B,) tensors: one per
# attempt, or under Jacobian reuse one per chunk). A run split over devices
# (``parallel.batch``, mesh=) adds every shard's: its trips are the sum of
# the shards' trips, and `cell_factors` takes one entry a shard.
TRIPS = {"trips": 0, "reinit": 0, "reinit_s": 0.0, "factor_trips": 0,
         "cell_factors": []}
_TRIPS_LOCK = threading.Lock()

# private to ``parallel.batch.batch_cost_analysis``: `.fn`, where set, is
# called in this thread with each trip's index at the head of the trip
_TRIP_HOOK = threading.local()


def reset_trip_counts():
    with _TRIPS_LOCK:
        TRIPS.update(trips=0, reinit=0, reinit_s=0.0, factor_trips=0, cell_factors=[])


def _count(key, n=1):
    with _TRIPS_LOCK:
        TRIPS[key] += n


def run_once(*, y_start, soc0, value, tf, th, bounds: dict,
             cfg: ModelConfig, spec: control.ControlSpec, opts: SimOptions,
             jac_plan=None, linear_solver=None, is_rest: bool = False,
             is_temperature_hold: bool = False, prev_I=None, has_prev=None,
             tstops=None) -> RunResultDev:
    """Execute one run for a batch of cells.

    y_start (B, N): starting states, whose algebraic part is re-initialized;
    soc0, value (B,); th: dict of (B, 1) θ tensors; bounds: dict of (B,)
    tensors; tf: float. `is_rest` turns the bound checks off (I = 0);
    `is_temperature_hold` turns the temperature bound off.
    `prev_I`, `has_prev` (B,): the last current of a continued run.
    `tstops` (B, K) or None: each cell's explicit stop times; every step
    ends at or before the cell's next stop (pad a row with inf).

    The Newton matrix comes from `jac_plan` (``ops.plan.JacobianPlan``:
    colored or analytic assembly and its factorization); without a plan it
    is the dense Jacobian, factored and solved by `linear_solver`, a
    (factor, solve) pair such as ``ops.structured.make_schur_solver``, by
    default ``linsolve.equilibrated_factor``/``equilibrated_solve``.

    With a function input, each accepted step probes the input at
    t + reltol; a cell whose input jumps there is re-initialized at the
    jump (consistent initialization, a fresh step size, BDF order 1)."""
    L = cfg.layout
    nd = L.N_diff
    B = y_start.shape[0]
    dev = y_start.device
    dtype = y_start.dtype
    tf = float(tf)

    # per-run control setup: the dc_* holds pick each cell's node here
    if spec.init_aux is not None:
        th = dict(th)
        th["_ctrl_aux"] = spec.init_aux(y_start, th)
    if prev_I is None:
        prev_I = torch.zeros(B, dtype=dtype, device=dev)
        has_prev = torch.zeros(B, dtype=torch.bool, device=dev)

    data = dict(th)
    data[_VALUE] = value[:, None]

    def F(t, y, yp, d):
        return control.full_residual(spec, d[_VALUE][:, 0], t, y, yp, d, cfg)

    def init_at(y_guess, t0, cells=None):
        return consistent_init(F, y_guess, nd, data, reltol_init=opts.reltol_init_,
                               maxiter=opts.init_maxiter, c_e0=1000.0, t0=t0,
                               jac_plan=jac_plan, th=th, cells=cells)

    # ---- consistent initialization -----------------------------------------
    y0 = initial_current_guess(spec, value, y_start, data, cfg, prev_I, has_prev)
    init = init_at(y0, torch.zeros(B, dtype=dtype, device=dev))
    y0, yp0 = init.y, init.yp

    # ---- integrator setup ---------------------------------------------------
    # per-component absolute tolerance: opts.abstol_T relaxes the T block,
    # since one scalar cannot serve concentrations (~1e4) and K offsets
    atol = opts.abstol
    if opts.abstol_T is not None and cfg.numerics.temperature:
        atol = torch.full((L.N_tot,), float(opts.abstol), dtype=dtype, device=dev)
        atol[L.sl("T")] = float(opts.abstol_T)
    if opts.dt0 is not None:
        h0 = torch.full((B,), float(opts.dt0), dtype=y0.dtype, device=dev)
    else:
        h0 = bdf.initial_step_size(y0, yp0, atol, opts.reltol, tf)
    state0 = bdf.bdf_init(0.0, y0, yp0, h0)

    if jac_plan is not None:
        solve = jac_plan.solve

        def jac_and_factor(t, y_pred, c0, psi_over_h):
            g, d = newton_system(F, data, t, y_pred, c0, psi_over_h)
            return jac_plan.factor_compressed(g, y_pred, d, t=t, c0=c0, th=th)
    else:
        factor, solve = linear_solver or (linsolve.equilibrated_factor,
                                          linsolve.equilibrated_solve)
        jac_and_factor = linsolve.make_dense_jacfwd(F, data, factor)

    hmax = opts.dtmax if opts.dtmax is not None else float("inf")
    stepper = bdf.Stepper(lambda t, y, yp: F(t, y, yp, data), jac_and_factor,
                          solve, atol, opts.reltol,
                          newton_maxiter=opts.newton_maxiter, hmax=hmax,
                          step_control=opts.step_control)

    def reinit_jumps(st, acc):
        """Probe the input at t + reltol after each accepted step; re-run the
        consistent initialization at the jump for the cells whose input
        jumps there and restart their BDF history at order 1. Runs only on
        trips where some cell jumped; the others keep `st`."""
        y, yp, t = st.D[:, 0], st.yp, st.t
        v_now = control.cell_values(spec.func(t, y, yp, data), y)
        t_jump = t + opts.reltol
        v_probe = control.cell_values(spec.func(t_jump, y, yp, data), y)
        jumped = acc & ((v_probe - v_now).abs()
                        > opts.abstol + opts.reltol * v_now.abs())
        if not bool(jumped.any()):
            return st, jumped
        start = time.perf_counter()
        init2 = init_at(y, t_jump, cells=jumped)
        h_new = bdf.initial_step_size(init2.y, init2.yp, atol, opts.reltol,
                                      torch.clamp_min(tf - t_jump, 1.0))
        st = bdf.restart(st, jumped, t_jump, init2.y, init2.yp, h_new)
        _count("reinit")
        _count("reinit_s", time.perf_counter() - start)
        return st, jumped

    vec_outs = _vector_outputs(opts, cfg)
    bufs = _make_bufs(opts, cfg, vec_outs, y0)
    all_cells = torch.ones(B, dtype=torch.bool, device=dev)
    zeros_i = torch.zeros(B, dtype=torch.int64, device=dev)
    t0 = torch.zeros(B, dtype=y0.dtype, device=dev)

    # record the initial point + t=0 bound check
    _record(bufs, zeros_i, all_cells, t0, y0, yp0, soc0, th, cfg, vec_outs)
    prev0 = events.BoundsPrev.init(t0)
    flag0 = torch.full((B,), EXIT_SIMULATING, dtype=torch.int64, device=dev)
    stop_fn = opts.stop_function
    chk = dict(reltol=opts.reltol, tf=tf, check_bounds=opts.check_bounds,
               is_rest=is_rest, is_temperature_hold=is_temperature_hold,
               stop_fn=stop_fn)
    prev0, flag0 = events.check_stop(t0, y0, yp0, soc0, prev0, flag0, bounds,
                                     th, cfg, spec.method, **chk)
    flag0 = torch.where(init.converged, flag0,
                        torch.full_like(flag0, EXIT_FAILED))

    rs = RunnerState(bdf=state0, soc=soc0, prev=prev0, flag=flag0,
                     save_idx=torch.ones_like(zeros_i), y_prev=y0, t_prev=t0,
                     soc_prev=soc0)
    tries = zeros_i
    # Jacobian reuse: each cell's factorization, the leading coefficient it
    # was made at, its trips in the chunk, and whether it refactors at its
    # next attempt
    K = int(opts.jac_reuse)
    fac = c0_f = None
    chunk = zeros_i
    fresh = all_cells
    n_factors = zeros_i

    # explicit stops: each step's bound is the cell's next stop time
    if tstops is not None:
        tstops = torch.as_tensor(tstops, dtype=y0.dtype, device=dev).reshape(B, -1)
        tf_cells = torch.full((B,), tf, dtype=y0.dtype, device=dev)

    def t_bound_of(t):
        if tstops is None:
            return tf
        nxt = torch.where(tstops > (t + 1e-9)[:, None], tstops,
                          torch.full_like(tstops, float("inf")))
        return torch.minimum(tf_cells, torch.amin(nxt, dim=1))

    trip_hook = getattr(_TRIP_HOOK, "fn", None)
    trip = 0
    while True:
        if trip_hook is not None:
            trip_hook(trip)
        trip += 1
        st0 = rs.bdf
        active = ((rs.flag == EXIT_SIMULATING) & (st0.t < tf)
                  & (st0.status == bdf.OK) & (st0.n_steps < opts.maxiters))
        t_bound = t_bound_of(st0.t)
        if K:
            need = active & fresh
            go, refactor = torch.stack([active.any(), need.any()]).tolist()
        else:
            go = bool(active.any())
        if not go:
            break
        _count("trips")
        if K:
            pred = bdf.predict(st0, t_bound, stepper.hmin, stepper.hmax)
            if refactor:
                # every cell is factored at its predictor; the cells that
                # start a chunk keep theirs
                _count("factor_trips")
                _, _, t_new, y_pred, c0, psi_over_h = pred
                new = jac_and_factor(t_new, y_pred, c0, psi_over_h)
                fac = new if fac is None else _select_tree(need, new, fac)
                c0_f = c0 if c0_f is None else torch.where(need, c0, c0_f)
                chunk = torch.where(need, zeros_i, chunk)
                fresh = fresh & ~need
                n_factors = n_factors + need.to(torch.int64)
            st, acc, done, tries_new = stepper.step(st0, t_bound, tries, fac, c0_f,
                                                    pred)
        else:
            _count("factor_trips")
            n_factors = n_factors + active.to(torch.int64)
            st, acc, done, tries_new = stepper.step(st0, t_bound, tries)
        tries = torch.where(active, torch.where(done, zeros_i, tries_new), tries)
        ended = active & done        # cells whose accepted-step loop ended

        keep = acc
        if spec.func is not None:
            st, jumped = reinit_jumps(st, ended & acc)
            keep = acc & ~jumped     # a re-initialization voids the factor

        # step bookkeeping, applied to the cells in `ended`
        y, yp, t = st.D[:, 0], st.yp, st.t
        y_prev, t_prev = st0.D[:, 0], st0.t
        soc = torch.where(
            acc, rs.soc + 0.5 * (t - t_prev) * (L.I(y) + L.I(y_prev)) / 3600.0,
            rs.soc)
        rec_idx = torch.clamp_max(rs.save_idx, opts.max_save - 1)
        _record(bufs, rec_idx, ended & acc, t, y, yp, soc, th, cfg, vec_outs)
        prev, flag = events.check_stop(t, y, yp, soc, rs.prev, rs.flag, bounds,
                                       th, cfg, spec.method, **chk)
        prev = _select_tree(acc, prev, rs.prev)
        flag = torch.where(acc, flag, rs.flag)
        flag = torch.where(st.status != bdf.OK,
                           torch.full_like(flag, EXIT_FAILED), flag)
        done_rs = RunnerState(
            bdf=st, soc=soc, prev=prev, flag=flag,
            save_idx=rs.save_idx + acc.to(torch.int64),
            y_prev=_select(acc, y_prev, rs.y_prev),
            t_prev=torch.where(acc, t_prev, rs.t_prev),
            soc_prev=torch.where(acc, rs.soc, rs.soc_prev))
        rs = _select_tree(ended, done_rs, rs)
        # cells still retrying keep the rejected attempt's solver state
        rs = rs._replace(bdf=bdf.select_state(active, st, st0))

        if K:
            # a cell whose step ended goes on with its factor while it has
            # taken fewer than K trips of the chunk, its step was accepted
            # (not a drift exit) without a re-initialization, and the next
            # attempt's leading coefficient stays in the factor's range
            chunk = chunk + ended.to(torch.int64)
            nxt = rs.bdf
            go_on = keep & (chunk < K) & bdf.cj_ok(nxt, t_bound_of(nxt.t), c0_f,
                                                   stepper.hmin, stepper.hmax)
            fresh = torch.where(ended, ~go_on, fresh)
    TRIPS["cell_factors"].append(n_factors)

    stop_is_margin = False
    if stop_fn is not None:
        # decided once, from the hook's result type, as the JAX package does
        probe = control.cell_values(stop_fn(t0, y0, yp0, soc0, th), y0)
        stop_is_margin = probe.dtype != torch.bool
    return _finish(rs, init, y0, bufs, bounds, th, cfg, opts, vec_outs, tf,
                   stop_fn if stop_is_margin else None)


def _finish(rs: RunnerState, init, y0, bufs, bounds, th, cfg, opts, vec_outs,
            tf, stop_margin=None) -> RunResultDev:
    """Exit handling: final flag, dense-output bisection of the crossing, and
    the last record. `stop_margin`: the user's stop hook when it is a signed
    margin, whose flag 12 is then localized like the built-in bounds (a
    boolean hook's stop stays on the accepted step)."""
    L = cfg.layout
    B = y0.shape[0]
    st = rs.bdf
    flag = rs.flag
    # ran out of iterations without hitting any condition
    flag = torch.where(flag == EXIT_SIMULATING,
                       torch.where(st.t >= tf, torch.zeros_like(flag),
                                   torch.full_like(flag, EXIT_FAILED)), flag)

    t_last = st.t
    soc_last = rs.soc
    last_idx = torch.clamp_max(rs.save_idx - 1, opts.max_save - 1)

    # back-interpolate the final point to the bound crossing, re-localized
    # on the BDF dense-output polynomial (linear t_frac point as fallback)
    do_interp = ((flag > 0) & (t_last > 1.0) & (rs.save_idx > 1)
                 if opts.interp_final else torch.zeros_like(flag, dtype=torch.bool))
    frac = rs.prev.t_frac
    t_lin = rs.t_prev + frac * (t_last - rs.t_prev)

    def soc_at(t, y):
        return (rs.soc_prev
                + 0.5 * (t - rs.t_prev) * (L.I(y) + L.I(rs.y_prev)) / 3600.0)

    c_max_n = th["c_max_n"][:, 0]
    sei = cfg.numerics.aging == "SEI"

    def g_at(t):
        """Signed margin g > 0 once the firing bound is exceeded, per cell's
        exit code (codes of absent physics, and 12 unless the stop hook is a
        margin, are stubbed at 1)."""
        y, yp = bdf.dense_eval(st.D, st.h, st.order, t_last, t)
        soc = soc_at(t, y)
        one = torch.ones_like(t)
        g_stop = (one if stop_margin is None
                  else control.cell_values(stop_margin(t, y, yp, soc, th), y))
        g_c_s_n = (one if L.half_cell else
                   torch.amax(L.c_s_surf(y, "n"), dim=-1)
                   - bounds["c_s_n_max"] * c_max_n)
        g_dfilm = (torch.amax(L.get(yp, "film"), dim=-1) - bounds["dfilm_max"]
                   if sei else one)
        g_T = (events._mean_T(L.get(y, "T"), th, cfg) + th["T_amb"][:, 0]
               - bounds["T_max"] if cfg.numerics.temperature else one)
        g = torch.stack([
            bounds["V_min"] - L.V(y),                                   # 1
            L.V(y) - bounds["V_max"],                                   # 2
            bounds["SOC_min"] - soc,                                    # 3
            soc - bounds["SOC_max"],                                    # 4
            g_T,                                                        # 5
            g_c_s_n,                                                    # 6
            L.I(y) - bounds["I_max"],                                   # 7
            bounds["I_min"] - L.I(y),                                   # 8
            bounds["c_e_min"] - torch.amin(L.get(y, "c_e"), dim=-1),    # 9
            g_dfilm,                                                    # 10
            bounds["eta_plating_min"] - L.eta_plating(y),               # 11
            g_stop,                                                     # 12
        ], dim=-1)
        code_idx = torch.clamp(flag - 1, 0, 11)
        return torch.gather(g, 1, code_idx[:, None])[:, 0]

    localizable = (flag >= 1) & (flag <= (11 if stop_margin is None else 12))
    g_lo = g_at(rs.t_prev)
    use_bisect = do_interp & localizable & (g_lo < 0)

    lo = torch.where(use_bisect, rs.t_prev, t_lin)
    hi = torch.where(use_bisect, t_last, t_lin)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        crossed = g_at(mid) > 0
        lo, hi = torch.where(crossed, lo, mid), torch.where(crossed, mid, hi)
    t_ref = hi

    t_f = torch.where(do_interp, torch.where(use_bisect, t_ref, t_lin), t_last)
    y_f, yp_f = bdf.dense_eval(st.D, st.h, st.order, t_last, t_f)
    soc_f = torch.where(do_interp, soc_at(t_f, y_f), soc_last)

    all_cells = torch.ones(B, dtype=torch.bool, device=y0.device)
    _record(bufs, last_idx, all_cells, t_f, y_f, yp_f, soc_f, th, cfg, vec_outs)

    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return RunResultDev(
        bufs=bufs, n_saved=i32(torch.clamp_max(rs.save_idx, opts.max_save)),
        flag=i32(flag), y0_run=y0, y_final=y_f, yp_final=yp_f,
        soc_final=soc_f, t_final=t_f, n_steps=i32(st.n_steps),
        n_rejected=i32(st.n_rejected), init_converged=init.converged,
        truncated=rs.save_idx > opts.max_save)

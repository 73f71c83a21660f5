"""The solver options of the port against the JAX package, unit by unit, in
float64 on the CPU: the stale-factor attempt of Jacobian reuse and its drift
exit, the "ida" step-size control, `cj_ok`, the dense Jacobian of the dense
routes, the equilibrated LU, the particle-Schur factorization of a dense
Newton matrix and the dense plan (`use_schur=False`); and, in the port
alone, Jacobian reuse over a batch against the same cells run alone. The
stepper comparisons use a four-state stiff DAE (two differential, two
algebraic states, coefficients per cell from a numpy seed), whose JAX
programs compile in seconds; the Jacobian and factor comparisons use the
LCO model at sampled states."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petlion_tpu as pt
from petlion_tpu.ops import plan as jax_plan
from petlion_tpu.ops import structured as jst
from petlion_tpu.physics.residuals import ModelConfig as JaxConfig
from petlion_tpu.solver import bdf as jbdf
from petlion_tpu.solver import control as jax_control
from petlion_tpu.solver import linsolve as jls

import petlion_tpu_torch as ptt
from petlion_tpu_torch.ops import structured as st
from petlion_tpu_torch.ops.jacobian import dense_jacobian, newton_system
from petlion_tpu_torch.ops.plan import get_plan
from petlion_tpu_torch.solver import bdf, control, linsolve
from petlion_tpu_torch.solver import run as runner
from petlion_tpu_torch.solver.newton import algebraic_residual
from test_residual_oracle import sample_state

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# the four-state DAE: u1' = -a u1 + b u2 v, u2' = u1 - c u2,
# 0 = v - 1 - u1 u2, 0 = w³ + w - u1
# ---------------------------------------------------------------------------

ATOL, RTOL = 1e-6, 1e-4


def _dae_theta(B, seed=3):
    rng = np.random.default_rng(seed)
    return dict(a=rng.uniform(20.0, 60.0, B), b=rng.uniform(0.5, 2.0, B),
                c=rng.uniform(0.5, 3.0, B))


def _F_port(t, y, yp, d):
    u1, u2, v, w = y.unbind(-1)
    a, b, c = d["a"][:, 0], d["b"][:, 0], d["c"][:, 0]
    return torch.stack([-a * u1 + b * u2 * v - yp[:, 0], u1 - c * u2 - yp[:, 1],
                        v - 1.0 - u1 * u2, w ** 3 + w - u1], dim=-1)


def _F_jax(th):
    def F(t, y, yp):
        u1, u2, v, w = y
        return jnp.stack([-th["a"] * u1 + th["b"] * u2 * v - yp[0],
                          u1 - th["c"] * u2 - yp[1], v - 1.0 - u1 * u2,
                          w ** 3 + w - u1])
    return F


def _dae_states(th, h_scale, seed=5):
    """BDFState fields (numpy) of cells with coefficients `th` at order 2,
    at a consistent point with a consistent derivative; the step sizes are
    random times `h_scale` (B,)."""
    B = len(th["a"])
    rng = np.random.default_rng(seed)
    u1 = rng.uniform(0.5, 1.5, B)
    u2 = rng.uniform(0.5, 1.5, B)
    # w³ + w = u1 has one real root
    w = np.array([np.roots([1.0, 0.0, 1.0, -x])[-1].real for x in u1])
    y = np.stack([u1, u2, 1.0 + u1 * u2, w], axis=-1)
    du1 = -th["a"] * u1 + th["b"] * u2 * y[:, 2]
    du2 = u1 - th["c"] * u2
    yp = np.stack([du1, du2, du1 * u2 + u1 * du2, du1 / (3 * w ** 2 + 1)], axis=-1)
    h = rng.uniform(1e-3, 5e-3, B) * h_scale
    D = np.zeros((B, 8, 4))
    D[:, 0] = y
    D[:, 1] = yp * h[:, None]
    return dict(t=rng.uniform(0.0, 1.0, B), h=h, order=np.full(B, 2), D=D,
                n_equal=np.full(B, 10), status=np.zeros(B, np.int64), yp=yp,
                n_steps=np.full(B, 30), n_rejected=np.zeros(B, np.int64),
                n_fails=np.zeros(B, np.int64))


def _port_state(s):
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64))  # noqa: E731
    return bdf.BDFState(**{k: (i64(v) if np.asarray(v).dtype.kind == "i"
                               else torch.as_tensor(v)) for k, v in s.items()})


def _jax_state(s, b):
    return jbdf.BDFState(**{k: (jnp.int32(v[b]) if np.asarray(v).dtype.kind == "i"
                                else jnp.asarray(v[b])) for k, v in s.items()})


_JAX_STEPS = {}


def _jax_step(step_control="greedy"):
    """JAX's `make_stepper` step with the cell's coefficients as arguments:
    step(th, state, t_bound, J_lu, c0_f), one program per step control."""
    if step_control not in _JAX_STEPS:
        def step(th, state, t_bound, J_lu=None, c0_f=None):
            F = _F_jax(th)
            return jbdf.make_stepper(F, jls.make_dense_jacfwd(F), jls.dense_solve,
                                     ATOL, RTOL, step_control=step_control)(
                state, t_bound, J_lu, c0_f)
        _JAX_STEPS[step_control] = jax.jit(step)
    return _JAX_STEPS[step_control]


def _port_stepper(data, step_control="greedy"):
    return bdf.Stepper(lambda t, y, yp: _F_port(t, y, yp, data),
                       linsolve.make_dense_jacfwd(_F_port, data), linsolve.dense_solve,
                       ATOL, RTOL, step_control=step_control)


def _port_steps(stepper, state, t_bound, J_lu=None, c0_f=None):
    """The port's attempts until every cell's step is done, as the runner
    drives them: (state, accepted, attempts)."""
    B = state.t.shape[0]
    tries = torch.zeros(B, dtype=torch.int64)
    live = torch.ones(B, dtype=torch.bool)
    acc_all = torch.zeros(B, dtype=torch.bool)
    attempts = torch.zeros(B, dtype=torch.int64)
    while bool(live.any()):
        st_, acc, done, tries_new = stepper.step(state, t_bound, tries, J_lu, c0_f)
        state = bdf.select_state(live, st_, state)
        acc_all = torch.where(live, acc, acc_all)
        attempts = attempts + live.to(torch.int64)
        tries = torch.where(live, tries_new, tries)
        live = live & ~done
    return state, acc_all, attempts


def _assert_state_equal(got: bdf.BDFState, b, want: jbdf.BDFState):
    """Counters equal; t, h and D within 1e-12, yp (c0·d + ψ/h, a cancelling
    sum at c0 ~ 1/h) within 1e-9, relative to each field's scale."""
    for f in ("order", "status", "n_steps", "n_rejected", "n_equal", "n_fails"):
        assert int(getattr(got, f)[b]) == int(getattr(want, f)), f
    for f, tol in (("t", 1e-12), ("h", 1e-12), ("D", 1e-12), ("yp", 1e-9)):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f)[b].numpy(), w, rtol=tol,
                                   atol=tol * np.abs(w).max(), err_msg=f)


def test_stale_factor_steps_match_jax():
    """Steps with a factorization made at another leading coefficient c0_f
    (c0/c0_f from 0.45 to 3.2; the step sizes 0.05×, 0.5× and 3× the
    sampled ones): the port's attempts, driven one per call as the runner
    drives them, end
    where JAX's `make_stepper` step ends with (J_lu, c0_f): the same
    acceptance, drift exit (status OK, not accepted), rejections, order, and
    t, h and D within 1e-12. The grid covers accepted steps after
    rejections and drift exits."""
    ratios = np.array([0.45, 0.8, 1.0, 1.6, 3.2])
    growth = np.array([0.05, 0.5, 3.0])
    B = len(ratios) * len(growth)
    th = _dae_theta(B)
    s = _dae_states(th, np.repeat(growth, len(ratios)))
    rat = np.tile(ratios, len(growth))
    data = {k: torch.as_tensor(v)[:, None] for k, v in th.items()}
    t_bound = 50.0

    stepper = _port_stepper(data)
    state = _port_state(s)
    h, D, t_new, y_pred, c0, psi = bdf.predict(state, t_bound, 1e-10, np.inf)
    c0_f = c0 / torch.as_tensor(rat)
    # the stale factor: the Newton matrix at c0_f around the predictor
    g, d = newton_system(_F_port, data, t_new, y_pred, c0_f, psi)
    J = dense_jacobian(g, y_pred, d)
    fac = linsolve.dense_factor(J)
    got, acc, attempts = _port_steps(stepper, state, t_bound, fac, c0_f)
    assert bool(bdf.cj_ok(state, t_bound, c0_f).all())

    outcomes = set()
    for b in range(B):
        thb = {k: jnp.asarray(v[b]) for k, v in th.items()}
        J_lu = jls.dense_factor(jnp.asarray(J[b].numpy()))
        want, want_acc = _jax_step()(thb, _jax_state(s, b), t_bound, J_lu,
                                     jnp.asarray(c0_f[b].item()))
        assert bool(acc[b]) == bool(want_acc)
        _assert_state_equal(got, b, want)
        drift = (not bool(want_acc)) and int(want.status) == jbdf.OK
        outcomes.add(("accepted" if bool(want_acc) else "drift" if drift else "failed",
                      int(attempts[b]) > 1))
    assert ("accepted", True) in outcomes and ("accepted", False) in outcomes
    assert any(o[0] == "drift" for o in outcomes)


def test_ida_step_control_matches_jax():
    """step_control="ida" against JAX's: one accepted step (retries
    included) of cells whose step sizes span 1e-3× to 30× the state's, so
    that the raw growth factor falls in each band (≥ 2: grow 2×; [1, 2):
    hold; < 1: shrink by at most half), with n_steps 5 (startup: greedy
    growth) and 30; h, order and D within 1e-12. Greedy on the same cells
    for contrast."""
    grid = np.geomspace(1e-3, 30.0, 24)
    B = 2 * len(grid)
    th = _dae_theta(B, seed=4)
    s = _dae_states(th, np.tile(grid, 2), seed=8)
    s["n_steps"] = np.repeat([5, 30], len(grid))
    data = {k: torch.as_tensor(v)[:, None] for k, v in th.items()}
    t_bound = 100.0
    bands = set()
    for control_ in ("ida", "greedy"):
        got, acc, _ = _port_steps(_port_stepper(data, control_), _port_state(s), t_bound)
        assert bool(acc.all())
        for b in range(B):
            thb = {k: jnp.asarray(v[b]) for k, v in th.items()}
            want, want_acc = _jax_step(control_)(thb, _jax_state(s, b), t_bound)
            assert bool(want_acc)
            _assert_state_equal(got, b, want)
            if control_ == "ida" and s["n_steps"][b] >= 20 and int(want.n_equal) == 0:
                # adapted after the startup phase: the new h over the step's
                # own (t_bound, far away, clips no step)
                ratio = float(want.h) / (float(want.t) - s["t"][b])
                bands.add("grow" if abs(ratio - 2.0) < 1e-9 else
                          "hold" if abs(ratio - 1.0) < 1e-9 else
                          "shrink" if 0.5 - 1e-9 <= ratio < 1.0 else "other")
    assert {"grow", "hold", "shrink"} <= bands, bands


def test_cj_ok_matches_jax():
    """cj_ok on a grid of ratios c0/c0_f from 0.1 to 10, with 0.3 and 10/3
    themselves (both excluded), at every order, with t_bound clipping some
    steps: equal to JAX's."""
    ratios = np.concatenate([np.geomspace(0.1, 10.0, 41), [0.3, 10.0 / 3.0]])
    orders = np.arange(1, 6)
    R, K = np.meshgrid(ratios, orders, indexing="ij")
    R, K = R.ravel(), K.ravel()
    B = len(R)
    rng = np.random.default_rng(2)
    h = rng.uniform(0.5, 2.0, B)
    t = rng.uniform(0.0, 10.0, B)
    t_bound = 10.5
    g = np.hstack([0.0, np.cumsum(1.0 / np.arange(1, 7))])
    h_eff = np.minimum(h, np.maximum(t_bound - t, 1e-10))
    c0_f = g[K] / h_eff / R
    s = dict(t=t, h=h, order=K, D=np.zeros((B, 8, 2)), n_equal=np.zeros(B, np.int64),
             status=np.zeros(B, np.int64), yp=np.zeros((B, 2)),
             n_steps=np.zeros(B, np.int64), n_rejected=np.zeros(B, np.int64),
             n_fails=np.zeros(B, np.int64))
    got = bdf.cj_ok(_port_state(s), t_bound, torch.as_tensor(c0_f)).numpy()
    want = np.array([bool(jbdf.cj_ok(_jax_state(s, b), t_bound, c0_f[b]))
                     for b in range(B)])
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def _lco(**kw):
    theta, _, _, N, numerics = pt.LCO(**kw)
    q = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64, **kw)
    return theta, JaxConfig.build(N, numerics), q


@pytest.mark.parametrize("kw", [{}, dict(temperature=True)], ids=["lco", "thermal"])
def test_dense_jacobians_match_jacfwd(kw):
    """Two sampled states with their own c0 and setpoint: the port's dense
    Newton matrix (one stacked pass over identity seeds) and the dense
    Jacobian of the algebraic block of consistent initialization (with its
    substituted control row) against `jax.jacfwd` of JAX's residuals, within
    1e-10 of each matrix's largest entry."""
    theta, jcfg, q = _lco(**kw)
    thj = {k: jnp.asarray(float(v), jnp.float64) for k, v in theta.items()}
    ys = np.stack([sample_state(theta, jcfg, s, i_val=v) for s, v in ((3, 0.9), (4, -0.7))])
    rng = np.random.default_rng(9)
    c0 = np.array([0.37, 1.9])
    psi = 1e-3 * rng.standard_normal(ys.shape) * np.abs(ys)
    value = np.array([0.9, -0.7])
    t = np.array([13.7, 507.1])
    nd = jcfg.layout.N_diff
    spec, spec_j = control.ControlSpec("I"), jax_control.ControlSpec("I")
    data = {k: v.reshape(1, 1).expand(2, 1) for k, v in q.theta.items()}
    data["_v"] = torch.as_tensor(value)[:, None]

    def F(t_, y, yp, d):
        return control.full_residual(spec, d["_v"][:, 0], t_, y, yp, d, q.cfg)

    J = linsolve.make_dense_jacfwd(F, data, factor=lambda M: M)(
        torch.as_tensor(t), torch.as_tensor(ys), torch.as_tensor(c0), torch.as_tensor(psi))
    d = dict(data, _y_diff=torch.as_tensor(ys[:, :nd]),
             _t_init=torch.as_tensor(t)[:, None])
    Ja = dense_jacobian(algebraic_residual(F, nd), torch.as_tensor(ys[:, nd:]), d)

    @jax.jit
    def jax_jacs(y, c0_, psi_, v, t_):
        def Fj(tt, yy, yp):
            return jax_control.full_residual(spec_j, v, tt, yy, yp, thj, jcfg)
        Jn = jax.jacfwd(lambda yy: Fj(t_, yy, c0_ * (yy - y) + psi_))(y)

        def alg_res(y_alg):          # the JAX package's newton.consistent_init
            yy = jnp.concatenate([y[:nd], y_alg])
            r = Fj(t_, yy, jnp.zeros_like(yy))
            r2 = Fj(t_, yy, jnp.zeros_like(yy).at[:nd].set(r[:nd]))
            return jnp.concatenate([r[nd:-1], r2[-1:]])
        return Jn, jax.jacfwd(alg_res)(y[nd:])

    for b in range(2):
        Jn, Jalg = (np.asarray(x) for x in jax_jacs(jnp.asarray(ys[b]), c0[b],
                                                      jnp.asarray(psi[b]), value[b], t[b]))
        for got, want in ((J[b], Jn), (Ja[b], Jalg)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-10 * np.abs(want).max())


def _newton_matrix(q, jcfg, theta, seed):
    """A dense Newton matrix of `q` at a sampled state (c0 = 0.8), float64."""
    y = sample_state(theta, jcfg, seed, i_val=-0.9)[None]
    spec = control.ControlSpec("I")
    data = {k: v.reshape(1, 1) for k, v in q.theta.items()}
    data["_v"] = torch.full((1, 1), -0.9, dtype=torch.float64)

    def F(t_, yy, yp, d):
        return control.full_residual(spec, d["_v"][:, 0], t_, yy, yp, d, q.cfg)

    jac = linsolve.make_dense_jacfwd(F, data, factor=lambda M: M)
    return jac(torch.zeros(1, dtype=torch.float64), torch.as_tensor(y),
               torch.full((1,), 0.8, dtype=torch.float64), torch.zeros(1, y.shape[1],
                                                                       dtype=torch.float64))


@pytest.mark.parametrize("kw", [{}, dict(anode="Li_metal"), dict(solid_diffusion="polynomial")],
                         ids=["lco", "half_cell", "polynomial"])
def test_dense_factorizations_match_jax(kw):
    """On one dense Newton matrix of each layout: the equilibrated LU (the
    same pivots and scalings, the LU within 1e-10 of its scale: MKL's and
    XLA's LAPACK round a few entries apart, which the solve of these
    matrices magnifies to 2e-9 of the solution's scale, so the solve is held
    to 1e-8 of it, against JAX's and against a dense solve); and the
    particle-Schur factorization (`make_split`, every `SchurLU` field:
    particle-block inverses, A⁻¹B, C and the equilibrated core inverse with
    its scalings) and its solve, against the JAX package's functions on the
    same matrix within 1e-12, and within 1e-9 of the dense solve. The half
    cell has no anode blocks and the polynomial closure 1×1 blocks."""
    theta, jcfg, q = _lco(**kw)
    J = _newton_matrix(q, jcfg, theta, seed=6)
    Jj = jnp.asarray(J[0].numpy())
    b = np.random.default_rng(1).standard_normal(J.shape[-1])
    bt = torch.as_tensor(b)[None]

    def close(got, want, tol=1e-12):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max(initial=0.0))

    dense = np.linalg.solve(J[0].numpy(), b)
    fac = linsolve.equilibrated_factor(J)
    (lu_j, piv_j), row_j, col_j = jls.equilibrated_factor(Jj)
    np.testing.assert_allclose(fac.LU[0].numpy(), np.asarray(lu_j), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(lu_j)).max())
    np.testing.assert_array_equal(fac.pivots[0].numpy() - 1, np.asarray(piv_j))
    close(fac.row[0], row_j)
    close(fac.col[0], col_j)
    x = linsolve.equilibrated_solve(fac, bt)[0].numpy()
    want = np.asarray(jls.equilibrated_solve(((lu_j, piv_j), row_j, col_j), jnp.asarray(b)))
    for ref in (want, dense):
        np.testing.assert_allclose(x, ref, rtol=0, atol=1e-8 * np.abs(ref).max())

    split, split_j = st.make_split(q.cfg.layout), jst.make_split(jcfg.layout)
    for f in ("i_cs", "i_core", "n_part_p", "n_part_n", "r_p", "r_n"):
        np.testing.assert_array_equal(getattr(split, f), getattr(split_j, f))
    assert split.n_part_n == (0 if "anode" in kw else q.cfg.layout.N.n)
    sf = st.schur_factor_from_dense(J, split)
    sf_j = jst.schur_factor_from_dense(Jj, split_j)
    for f in ("inv_p", "inv_n", "AinvB", "C"):
        close(getattr(sf, f)[0], getattr(sf_j, f))
    for got, want in zip(sf.core_inv, sf_j.core_inv):
        # the blocked Gauss-Jordan's products round a few entries apart
        close(got[0], want, tol=1e-11)
    factor, solve = st.make_schur_solver(q.cfg.layout)
    x = solve(factor(J), bt)
    close(x[0], jst.schur_solve(sf_j, jnp.asarray(b), split_j), tol=1e-11)
    np.testing.assert_allclose(x[0].numpy(), dense, rtol=0, atol=1e-9 * np.abs(dense).max())


def test_dense_plan_matches_jax():
    """`get_plan(..., use_schur=False)`: no analytic assembly; the colored
    dense Newton matrix of two cells within 1e-12 of its scale, and its
    equilibrated-LU solve within 1e-8 (as in the factorization test),
    against JAX's `get_plan(..., use_schur=False)` (`colored`,
    `factor_compressed`, `solve`; the packages' detected patterns differ by
    rounding residue inside the particle blocks: ROADMAP C); the algebraic
    block of consistent initialization on the same plan against the
    equilibrated inverse of its dense Jacobian."""
    theta, jcfg, q = _lco()
    plan = get_plan(q.cfg, q.theta_floats(), use_schur=False)
    plan_j = jax_plan.get_plan(jcfg, theta, use_schur=False)
    assert not plan.use_schur and plan.analytic is None and plan.n_colors == plan_j.n_colors
    assert get_plan(q.cfg, q.theta_floats()) is not plan
    thj = {k: jnp.asarray(float(v), jnp.float64) for k, v in theta.items()}
    ys = np.stack([sample_state(theta, jcfg, s, i_val=v) for s, v in ((3, 0.9), (4, -0.7))])
    c0 = np.array([0.37, 1.9])
    rhs = np.random.default_rng(2).standard_normal(ys.shape)
    spec, spec_j = control.ControlSpec("I"), jax_control.ControlSpec("I")
    data = {k: v.reshape(1, 1).expand(2, 1) for k, v in q.theta.items()}
    data["_v"] = torch.as_tensor([0.9, -0.7], dtype=torch.float64)[:, None]

    def F(t_, y, yp, d):
        return control.full_residual(spec, d["_v"][:, 0], t_, y, yp, d, q.cfg)

    g, d = newton_system(F, data, torch.zeros(2, dtype=torch.float64), torch.as_tensor(ys),
                         torch.as_tensor(c0), torch.zeros(ys.shape, dtype=torch.float64))
    fac = plan.factor_compressed(g, torch.as_tensor(ys), d)
    assert isinstance(fac, linsolve.EquilibratedLU)
    x = plan.solve(fac, torch.as_tensor(rhs))
    Jc = plan.colored(g, torch.as_tensor(ys), d)
    @jax.jit
    def jax_dense(y, c0_, v, rhs_):
        def gj(yy):
            return jax_control.full_residual(spec_j, v, 0.0, yy, c0_ * (yy - y), thj, jcfg)
        return plan_j.colored(gj, y), plan_j.solve(plan_j.factor_compressed(gj, y), rhs_)

    for b, v in enumerate((0.9, -0.7)):
        want_J, want_x = (np.asarray(a) for a in jax_dense(
            jnp.asarray(ys[b]), c0[b], v, jnp.asarray(rhs[b])))
        np.testing.assert_allclose(Jc[b].numpy(), want_J, rtol=0,
                                   atol=1e-12 * np.abs(want_J).max())
        np.testing.assert_allclose(x[b].numpy(), want_x, rtol=0,
                                   atol=1e-8 * np.abs(want_x).max())

    nd = q.cfg.layout.N_diff
    da = dict(d, _y_diff=torch.as_tensor(ys[:, :nd]),
              _t_init=torch.zeros(2, 1, dtype=torch.float64))
    alg = algebraic_residual(F, nd)
    lu = plan.factor_alg(alg, torch.as_tensor(ys[:, nd:]), da)
    dense = dense_jacobian(alg, torch.as_tensor(ys[:, nd:]), da)
    want = linsolve.equilibrated_inv_factor(dense)
    for got, ref in zip(lu, want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-9 * ref.abs().max().item())


def test_batch_reuse_cells_equal_their_own_runs():
    """batch_simulate(jac_reuse=6) of three cells with perturbed D_sp and
    k_n over 600 s, in which the cells refactor on different trips: each
    cell equals, bit for bit, the same cell in a batch of three copies of
    it (which refactor together), and its single-cell `simulate` run:
    the same steps and rejections, V within 1e-12 and t within 1e-8 s.
    (The single-cell run differs from the batch at the rounding level
    without reuse too: the CPU's vectorized transcendental functions round
    an element by where it lies in the tensor, 4e-22 on the j rows of the
    residual; the step-size control magnifies that to 3e-9 s of t here, and
    to 1.3e-8 s on the same run without reuse, both measured on the
    CPU.)"""
    p = ptt.petlion(ptt.LCO, device="cpu")
    D = np.array([1e-14, 1.3e-14, 0.8e-14])
    kn = np.array([5.031e-11, 4e-11, 6e-11])
    kw = dict(I=-1.0, SOC=1.0, jac_reuse=6, outputs=("t", "V"))
    runner.reset_trip_counts()
    r = ptt.batch_simulate(p, 600.0, theta_batch={"D_sp": D, "k_n": kn}, **kw)
    factors = runner.TRIPS["cell_factors"][-1].tolist()
    assert runner.TRIPS["factor_trips"] > max(factors) and len(set(factors)) > 1
    assert max(factors) < int(r.n_steps.min())
    for b in range(3):
        same = ptt.batch_simulate(p, 600.0, theta_batch={"D_sp": np.full(3, D[b]),
                                                         "k_n": np.full(3, kn[b])}, **kw)
        n = int(r.n_saved[b])
        assert int(same.n_steps[b]) == int(r.n_steps[b])
        for k in ("t", "V"):
            assert torch.equal(same.bufs[k][b, :n], r.bufs[k][b, :n]), k
        q = ptt.petlion(ptt.LCO, device="cpu")
        q.theta["D_sp"] = torch.tensor(D[b], dtype=torch.float64)
        q.theta["k_n"] = torch.tensor(kn[b], dtype=torch.float64)
        s = ptt.simulate(q, 600.0, I=-1, SOC=1, jac_reuse=6, outputs=("t", "V"))
        assert s.results[-1].n_steps == int(r.n_steps[b])
        assert s.results[-1].n_rejected == int(r.n_rejected[b])
        np.testing.assert_allclose(r.bufs["t"][b, :n].numpy(), s.t, rtol=0, atol=1e-8)
        np.testing.assert_allclose(r.bufs["V"][b, :n].numpy(), s.V, rtol=0, atol=1e-12)

"""The port's thermal model (``temperature=True``) against the JAX package,
in float64 on the CPU unless stated, at the residual, Newton-matrix,
factorization, event and run level: the thermal residual and the heat
sources of the four thermal families of tests/test_residual_oracle.py
(to 1e-12), the Newton matrix against `jax.jacfwd` (to 1e-10 on the plan's
pattern, the Schur core at the JAX split's size), the refined pivoted LU of
float32 thermal runs against JAX's on a dT-hold Newton matrix, the mean
temperature and its stop (flag 5), `abstol_T`, and the kelvin convention
of recorded and returned states. Each JAX program here compiles in a few
seconds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petlion_tpu as pt
from petlion_tpu.ops import structured as jax_structured
from petlion_tpu.physics import residuals as jr
from petlion_tpu.solver import bdf as jax_bdf
from petlion_tpu.solver import control as jax_control
from petlion_tpu.solver import events as jax_events
from petlion_tpu.solver import linsolve as jax_linsolve

import petlion_tpu_torch as ptt
from petlion_tpu_torch.ops.plan import get_plan
from petlion_tpu_torch.physics import residuals as tr
from petlion_tpu_torch.sim import _build_control, _mean_T_host
from petlion_tpu_torch.solver import bdf, control, events, linsolve
from test_residual_oracle import sample_state
from test_torch_all_variants import _dense, _refined_solve

torch.set_num_threads(1)

# the thermal families of the residual oracle: (chemistry, options)
THERMAL = {
    "lco_thermal": ("LCO", dict(temperature=True)),
    "lco_thermal_sei": ("LCO", dict(temperature=True, aging="SEI")),
    "lco_half_cell_thermal": ("LCO", dict(temperature=True, anode="Li_metal")),
    "lgm50": ("NMC_LGM50", {}),
}


def _models(name):
    """(θ, JAX model, port model) of one family, float64."""
    chem, kw = THERMAL[name]
    pj = pt.petlion(getattr(pt, chem), **kw)
    q = ptt.petlion(getattr(ptt, chem), device="cpu", dtype=torch.float64, **kw)
    return pj.theta, pj, q


def _th(q, B):
    return {k: v.reshape(1, 1).expand(B, 1) for k, v in q.theta.items()}


def _states(theta, jcfg, n, i_vals):
    """`n` sampled states with T offsets of a few K and yp ≠ 0 scaled to
    each family's residual at yp = 0."""
    thj = {k: jnp.asarray(float(v), jnp.float64) for k, v in theta.items()}
    L = jcfg.layout
    res = jax.jit(lambda y: jr.residual_core(13.7, y, jnp.zeros_like(y), thj, jcfg))
    ys, yps = [], []
    for s in range(n):
        y = sample_state(theta, jcfg, 11 + s, i_val=i_vals[s])
        r0 = np.asarray(res(jnp.asarray(y)))
        rng = np.random.default_rng(100 + s)
        yp = np.zeros_like(y)
        for fam, _ in L._entries:
            sl = L.sl(fam)
            yp[sl] = (np.max(np.abs(r0[sl])) + 1e-30) * rng.standard_normal(sl.stop - sl.start)
        ys.append(y)
        yps.append(yp)
    return np.stack(ys), np.stack(yps), thj


@pytest.mark.parametrize("name", sorted(THERMAL))
def test_thermal_residual_and_heat_sources_match_jax(name):
    """Three cells at sampled states (I = 0.8, −1.3, 2.1, T offsets of a few
    K, yp ≠ 0): every state family of the port's residual, and the heat
    sources Q_rev, Q_rxn, Q_ohm of `_heat_generation`, within 1e-12 of the
    JAX package's, relative to the family's (source's) largest magnitude;
    the layout is JAX's."""
    theta, pj, q = _models(name)
    jcfg = pj.cfg
    assert q.cfg.layout.N_tot == jcfg.layout.N_tot
    assert [(k, e.start, e.length) for k, e in q.cfg.layout._entries] == \
        [(k, e.start, e.length) for k, e in jcfg.layout._entries]
    ys, yps, thj = _states(theta, jcfg, 3, (0.8, -1.3, 2.1))
    th = _th(q, 3)
    yt = torch.as_tensor(ys)
    got = tr.residual_core(13.7, yt, torch.as_tensor(yps), th, q.cfg).numpy()
    aux = tr.build_auxiliary(13.7, yt, th, q.cfg)
    heat = [x.numpy() for x in tr._heat_generation(aux, th, q.cfg)]
    L = jcfg.layout
    res = jax.jit(lambda y, yp: jr.residual_core(13.7, y, yp, thj, jcfg))
    # the heat sources op by op: XLA's fusion contracts the entropy
    # coefficients' polynomials into FMAs, whose rounding their cancellation
    # amplifies to a few 1e-12
    def heat_j(y):
        return jr._heat_generation(jr.build_auxiliary(13.7, y, thj, jcfg), thj, jcfg)

    for b in range(3):
        want = np.asarray(res(jnp.asarray(ys[b]), jnp.asarray(yps[b])))
        for fam, _ in L._entries:
            s = L.sl(fam)
            err = np.max(np.abs(got[b, s] - want[s])) / (np.max(np.abs(want[s])) + 1e-300)
            assert err < 1e-12, (name, fam, b, err)
        for k, (g, w) in enumerate(zip(heat, heat_j(jnp.asarray(ys[b])))):
            w = np.asarray(w)
            err = np.max(np.abs(g[b] - w)) / (np.max(np.abs(w)) + 1e-300)
            assert err < 1e-12, (name, ("Q_rev", "Q_rxn", "Q_ohm")[k], b, err)


@pytest.mark.parametrize("name", sorted(THERMAL))
def test_thermal_newton_matrix_matches_jacfwd(name):
    """Two cells, one under a current and one under the dT hold (the mean
    temperature's rate held at 0, the row that makes the matrix nearly
    singular), each with its own c0: the port's plan (colored sweeps: the
    analytic assembly excludes the thermal model, as in JAX) assembles
    `jax.jacfwd` of JAX's full residual within 1e-10 of each row's scale on
    the plan's pattern, with nothing left out above 1e-12 of the scale; the
    Schur core is the one JAX's `make_group_split` takes on that pattern
    (121 states for the LCO cell, as JAX's own plan); and the float64
    factorization (the Schur route) solves the current-controlled matrix
    within 1e-9 of a dense solve, and the dT-hold one (cond near 1e16)
    with a backward error under 1e-13."""
    theta, pj, q = _models(name)
    jcfg = pj.cfg
    ys = np.stack([sample_state(theta, jcfg, s, i_val=v) for s, v in ((3, 0.9), (4, -0.7))])
    rng = np.random.default_rng(9)
    c0 = np.array([0.37, 1.9])
    const = 1e-3 * rng.standard_normal(ys.shape) * np.abs(ys)
    rhs = rng.standard_normal(ys.shape)
    thj = {k: jnp.asarray(float(v), jnp.float64) for k, v in theta.items()}
    spec_I = jax_control.ControlSpec("I")
    spec_dT = pt.sim._build_control(pj, None, {"dT": "hold"})[1]
    values = [0.9, 0.0]

    # the body rows do not depend on the control: one jacfwd program for
    # both cells, and the dT row by one reverse pass
    @jax.jit
    def jac_I(y, c0_, const_, v):
        return jax.jacfwd(lambda yy: jax_control.full_residual(
            spec_I, v, 0.0, yy, c0_ * yy + const_, thj, jcfg))(y)

    @jax.jit
    def row_dT(y, c0_, const_):
        return jax.grad(lambda yy: jax_control.full_residual(
            spec_dT, 0.0, 0.0, yy, c0_ * yy + const_, thj, jcfg)[-1])(y)

    want = [np.array(jac_I(jnp.asarray(ys[i]), c0[i], jnp.asarray(const[i]), values[i]))
            for i in range(2)]
    want[1][-1] = np.asarray(row_dT(jnp.asarray(ys[1]), c0[1], jnp.asarray(const[1])))

    spec_t = (control.ControlSpec("I"), _build_control(q, None, {"dT": "hold"})[1])
    assert spec_t[1].method == "res"
    plan = get_plan(q.cfg, q.theta_floats())
    assert plan.analytic is None
    split_j = jax_structured.make_group_split(jcfg.layout, plan.colored.pattern)
    np.testing.assert_array_equal(plan.split.i_core, split_j.i_core)
    if name == "lco_thermal":
        assert len(plan.split.i_core) == 121
    th = _th(q, 1)
    for i, spec in enumerate(spec_t):
        data = dict(th, _c0=torch.tensor([[c0[i]]]), _const=torch.as_tensor(const[i:i + 1]),
                    _v=torch.tensor([[values[i]]]))

        def g(yy, d, spec=spec):
            return control.full_residual(spec, d["_v"][:, 0], 0.0, yy,
                                         d["_c0"] * yy + d["_const"], d, q.cfg)

        y_t = torch.as_tensor(ys[i:i + 1])
        J = plan.colored(g, y_t, data)[0].numpy()
        JS, last = plan.colored.compressed(g, y_t, data)
        np.testing.assert_array_equal(J, _dense(plan, JS, last)[0].numpy())
        pat = plan.colored.pattern
        scale = np.abs(want[i]).max(axis=1, keepdims=True)
        assert np.max(np.abs(J - want[i] * pat) / scale) < 1e-10, (name, i)
        assert not ((np.abs(want[i]) > 1e-12 * scale) & ~pat).any(), (name, i)
        fac = plan.factor_compressed(g, y_t, data, t=torch.zeros(1),
                                     c0=torch.tensor([c0[i]]), th=th)
        assert not isinstance(fac, linsolve.RefinedLU)
        x = plan.solve(fac, torch.as_tensor(rhs[i:i + 1]))[0].numpy()
        if i == 0:
            ref = _refined_solve(J, rhs[i])
            assert np.linalg.norm(x - ref) / np.linalg.norm(ref) < 1e-9, name
        else:
            back = (np.linalg.norm(J @ x - rhs[i])
                    / (np.linalg.norm(J, np.inf) * np.linalg.norm(x, np.inf)))
            assert back < 1e-13, (name, back)


@pytest.fixture(scope="module")
def dT_hold_matrix():
    """A dT-hold Newton matrix of the thermal LCO cell (JAX jacfwd, float64)
    and Newton right-hand sides: the residuals at sixteen perturbed
    states."""
    theta, pj, _ = _models("lco_thermal")
    jcfg = pj.cfg
    thj = {k: jnp.asarray(float(v), jnp.float64) for k, v in theta.items()}
    spec = pt.sim._build_control(pj, None, {"dT": "hold"})[1]
    y = sample_state(theta, jcfg, 3, i_val=2.0, soc=0.5)
    rng = np.random.default_rng(1)
    const = 1e-3 * rng.standard_normal(y.shape) * np.abs(y)

    @jax.jit
    def F(yy):
        return jax_control.full_residual(spec, 0.0, 0.0, yy, 0.5 * yy + const, thj, jcfg)

    J = np.asarray(jax.jacfwd(F)(jnp.asarray(y)))
    bs = [-np.asarray(F(jnp.asarray(y * (1 + 1e-6 * rng.standard_normal(y.shape)))))
          for _ in range(16)]
    return J, np.stack(bs)


def test_refined_lu_matches_jax(dT_hold_matrix):
    """The refined pivoted LU (`refined_lu_factor`/`refined_lu_solve`) of a
    dT-hold Newton matrix (cond above 1e15): in float64 the port's and JAX's
    solves agree within 1e-9 (relative) and the port's lies within 1e-8 of
    a dense float64 solve; in float32 each package's error against the dense
    float64 solve is measured, and the port's is at most 3× JAX's on every
    right-hand side. `plan.solve` and `equilibrated_inv_solve` dispatch on
    the factor's type; a factor with an exact zero pivot is NaN."""
    J, bs = dT_hold_matrix
    assert np.linalg.cond(J) > 1e14
    for b in bs[:3]:
        ref = _refined_solve(J, b)
        err = lambda x: np.linalg.norm(x - ref) / np.linalg.norm(ref)  # noqa: E731
        fac64 = linsolve.refined_lu_factor(torch.as_tensor(J)[None])
        x64 = linsolve.refined_lu_solve(fac64, torch.as_tensor(b)[None])[0].numpy()
        xj64 = np.asarray(jax_linsolve.refined_lu_solve(
            jax_linsolve.refined_lu_factor(jnp.asarray(J)), jnp.asarray(b)))
        assert np.linalg.norm(x64 - xj64) / np.linalg.norm(xj64) < 1e-9
        assert err(x64) < 1e-8
        np.testing.assert_array_equal(
            linsolve.equilibrated_inv_solve(fac64, torch.as_tensor(b)[None])[0].numpy(), x64)
        fac32 = linsolve.refined_lu_factor(torch.as_tensor(J, dtype=torch.float32)[None])
        x32 = linsolve.refined_lu_solve(fac32, torch.as_tensor(b, dtype=torch.float32)[None])
        xj32 = jax_linsolve.refined_lu_solve(
            jax_linsolve.refined_lu_factor(jnp.asarray(J, jnp.float32)),
            jnp.asarray(b, jnp.float32))
        e_port, e_jax = err(x32[0].double().numpy()), err(np.asarray(xj32, np.float64))
        assert e_port <= 3 * e_jax, (e_port, e_jax)
    sing = torch.eye(4, dtype=torch.float64)[None].clone()
    sing[0, 2, 2] = 0.0
    assert torch.isnan(linsolve.refined_lu_factor(sing).LU).all()


def test_refined_lu_float32_refinement_matches_jax(dT_hold_matrix):
    """The float32 refinement step is as useful as the JAX package's: on the
    dT-hold Newton matrix in float32 and sixteen right-hand sides, the
    geometric mean of the port's refined-solve error (against a dense
    solve of the same float32 matrix, refined in long double) is within
    1.5× JAX's. A residual b − J x from a BLAS gemv, which sums each row's
    cancelling neighbour terms in lanes 8 or 16 columns apart, left 5× JAX's
    error and a float32 CC-CT-CV with 4× its CV steps; the port sums each
    row in column order (`row_sums_in_column_order`: pairwise, neighbours
    first, the same bits as a numpy reference of that order)."""
    J, bs = dT_hold_matrix
    J32 = J.astype(np.float32)
    fp = linsolve.refined_lu_factor(torch.as_tensor(J32)[None])
    fj = jax_linsolve.refined_lu_factor(jnp.asarray(J32))
    e_port, e_jax = [], []
    for b in bs.astype(np.float32):
        ref = _refined_solve(J32.astype(np.float64), b.astype(np.float64))
        err = lambda x: np.linalg.norm(np.asarray(x, np.float64) - ref) / np.linalg.norm(ref)  # noqa: E731
        e_port.append(err(linsolve.refined_lu_solve(fp, torch.as_tensor(b)[None])[0]))
        e_jax.append(err(jax_linsolve.refined_lu_solve(fj, jnp.asarray(b))))
    g_port, g_jax = (float(np.exp(np.mean(np.log(e)))) for e in (e_port, e_jax))
    assert g_port <= 1.5 * g_jax, (g_port, g_jax)

    P = np.random.default_rng(5).standard_normal((2, 7, 13)).astype(np.float32)
    want = P
    while want.shape[-1] > 1:
        if want.shape[-1] % 2:
            want = np.concatenate([want, np.zeros(want.shape[:-1] + (1,), np.float32)], -1)
        want = want[..., 0::2] + want[..., 1::2]
    np.testing.assert_array_equal(
        linsolve.row_sums_in_column_order(torch.as_tensor(P)).numpy(), want[..., 0])


@pytest.mark.parametrize("name", ["lco_thermal", "lco_half_cell_thermal"])
def test_mean_T_and_temperature_stop_match_jax(name):
    """`events._mean_T` of three cells' T states equals JAX's (1e-13);
    `check_stop` with T_max just below each cell's mean temperature fires
    flag 5 where the mean rises, as JAX's, with the same t_frac and mean T
    (1e-12), and not under a temperature hold."""
    theta, pj, q = _models(name)
    jcfg = pj.cfg
    ys, yps, thj = _states(theta, jcfg, 3, (0.8, -1.3, 2.1))
    L = q.cfg.layout
    th = _th(q, 3)
    y, yp = torch.as_tensor(ys), torch.as_tensor(yps)
    yp[:, L.sl("T")] = torch.tensor([1e-2, -1e-2, 1e-2])[:, None]
    got = events._mean_T(L.get(y, "T"), th, q.cfg).numpy()
    for b in range(3):
        want = float(jax_events._mean_T(jnp.asarray(ys[b][L.sl("T")]), thj, jcfg))
        np.testing.assert_allclose(got[b], want, rtol=1e-13)
        assert _mean_T_host(ys[b], q) == pytest.approx(want, rel=1e-13)
    T_abs = got + 298.15
    nan = torch.full((3,), float("nan"), dtype=torch.float64)
    bounds = {k: nan.clone() for k in events.BOUND_KEYS}
    bounds["T_max"] = torch.as_tensor(T_abs - 1e-3)
    t = torch.full((3,), 100.0, dtype=torch.float64)
    soc = torch.full((3,), 0.5, dtype=torch.float64)
    prev = events.BoundsPrev.init(t)._replace(T=torch.as_tensor(T_abs - 2e-3))
    flag = torch.full((3,), -1, dtype=torch.int64)
    for hold in (False, True):
        got_prev, got_flag = events.check_stop(t, y, yp, soc, prev, flag, bounds, th,
                                               q.cfg, "I", reltol=1e-3, tf=600.0,
                                               is_temperature_hold=hold)
        jax_check = jax.jit(lambda y_, yp_, prev_, bounds_, hold=hold: jax_events.check_stop(
            jnp.asarray(100.0), y_, yp_, jnp.asarray(0.5), prev_, jnp.asarray(-1, jnp.int32),
            bounds_, thj, jcfg, "I", reltol=1e-3, tf=600.0, is_temperature_hold=hold))
        for b in range(3):
            want_prev, want_flag = jax_check(
                jnp.asarray(y[b].numpy()), jnp.asarray(yp[b].numpy()),
                jax_events.BoundsPrev(*(jnp.asarray(float(x[b])) for x in prev)),
                {k: jnp.asarray(float(v[b])) for k, v in bounds.items()})
            assert int(got_flag[b]) == int(want_flag), (hold, b)
            for f in ("t_frac", "T"):
                np.testing.assert_allclose(float(getattr(got_prev, f)[b]),
                                           float(getattr(want_prev, f)), rtol=1e-12)
        assert got_flag.tolist() == ([-1] * 3 if hold else [5, -1, 5])


def test_thermal_runs_record_kelvin_and_localize_T_max():
    """A thermal LCO cell charged at 4C to T_max = T0 + 0.3 K: flag 5
    ("Above max. temperature"), the exit localized on the dense output
    (the mean temperature of the returned state within 1e-6 K of T_max);
    recorded T and the T block of recorded Y in kelvin, YP a rate; the
    public Y_final in kelvin and the internal carry an offset; a
    continuation from the solution equals one from `initial_states=Y_final`
    (1e-10); `calc_OCV` reads the state's T, as JAX's."""
    q = ptt.petlion(ptt.LCO, device="cpu", temperature=True)
    L = q.layout
    T_max = 298.15 + 0.3
    sol = ptt.simulate(q, I=4, SOC=0.2, T_max=T_max, outputs=("t", "V", "T", "Y", "YP"))
    assert sol.final_exit_reason() == "Above max. temperature"
    assert abs(_mean_T_host(sol.Y_final, q) - T_max) < 1e-6
    T, Y = sol.arrays["T"], sol.arrays["Y"]
    assert 298.0 < T.min() and T.max() < 300.0
    np.testing.assert_array_equal(Y[:, L.sl("T")], T)
    assert np.abs(sol.arrays["YP"][:, L.sl("T")]).max() < 50.0   # K/s, not K
    np.testing.assert_allclose(sol.Y_final[L.sl("T")] - sol._Y_final_int[L.sl("T")], 298.15,
                               rtol=1e-14)
    y_end = sol.Y_final.copy()
    a = ptt.simulate_cont(sol, q, 5.0, I="rest")
    b = ptt.simulate(q, 5.0, I="rest", initial_states=y_end)
    assert np.max(np.abs(a.Y_final - b.Y_final) / (1 + np.abs(b.Y_final))) < 1e-10
    pj = pt.petlion(pt.LCO, temperature=True)
    for ours, theirs in zip(ptt.calc_OCV(sol.Y_final, q), pt.calc_OCV(sol.Y_final, pj)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-13)
    # the OCV moves with T (dU/dT ≠ 0): a colder state gives another OCV
    cold = sol.Y_final.copy()
    cold[L.sl("T")] -= 10.0
    assert not np.allclose(ptt.calc_OCV(cold, q)[0].numpy(), ptt.calc_OCV(sol.Y_final, q)[0].numpy())


def test_abstol_T_vector_tolerance():
    """`abstol_T` relaxes the T block of the absolute tolerance: the initial
    step from the same consistent state equals JAX's `initial_step_size`
    with JAX's vector tolerance (1e-12), and a thermal run takes fewer steps
    with abstol_T = 0.05 than without."""
    q = ptt.petlion(ptt.LCO, device="cpu", temperature=True)
    L = q.layout
    s = ptt.simulate(q, 1.0, I=4, SOC=0.2, outputs=("t", "Y", "YP"), abstol=1e-6)
    y, yp = s.arrays["Y"][-1].copy(), s.arrays["YP"][-1]
    y[L.sl("T")] -= 298.15
    atol = np.full(L.N_tot, 1e-6)
    atol[L.sl("T")] = 0.05
    h_t = bdf.initial_step_size(torch.as_tensor(y)[None], torch.as_tensor(yp)[None],
                                torch.as_tensor(atol), 1e-3, 600.0)
    h_j = jax_bdf.initial_step_size(jnp.asarray(y), jnp.asarray(yp), jnp.asarray(atol),
                                    1e-3, 600.0)
    np.testing.assert_allclose(float(h_t[0]), float(h_j), rtol=1e-12)
    kw = dict(I=4, SOC=0.2, abstol=1e-8)
    loose = ptt.simulate(q, 5.0, abstol_T=0.05, **kw).results[-1]
    tight = ptt.simulate(q, 5.0, **kw).results[-1]
    assert loose.flag == tight.flag == 0
    assert loose.n_steps < tight.n_steps


def test_thermal_model_from_numpy_and_lgm50_default():
    """`model_from_numpy` carries a thermal JAX model (θ, options and
    numerics field by field); NMC_LGM50's default is the thermal model, as
    the JAX package's, and runs (10 s at 1C, T recorded in kelvin); the
    model's repr shows the temperature bound."""
    pj = pt.petlion(pt.LCO, temperature=True)
    pj.opts = pj.opts.replace(abstol_T=0.01)
    m = ptt.model_from_numpy({k: np.asarray(v) for k, v in pj.theta.items()}, pj.bounds,
                             pj.N, pj.numerics, opts=pj.opts, device="cpu",
                             dtype=torch.float64)
    assert m.theta_floats() == pj.theta
    for f in dataclasses.fields(pj.opts):
        assert getattr(m.opts, f.name) == getattr(pj.opts, f.name), f.name
    assert m.numerics.temperature and m.opts.abstol_T == 0.01
    assert m.cfg.layout.N_tot == pj.cfg.layout.N_tot == 351
    lg = ptt.petlion(ptt.NMC_LGM50, device="cpu")
    assert lg.numerics.temperature and lg.layout.N_tot == pt.petlion(pt.NMC_LGM50).cfg.layout.N_tot
    sol = ptt.simulate(lg, 10.0, I=-1, SOC=0.8, outputs=("t", "V", "T"))
    assert sol.final_exit_reason() == "Final time reached" and sol.T.min() > 298.0
    assert "Temperature:     max 55 °C" in repr(m)

"""The control inputs of the port's `simulate` — V, P and η_p as constants
and as "hold", P = "rest", the CC→CV flow with its I_min stop, a start from
explicit states — on the CPU in float64 against the JAX package's
`simulate`; the float32 consistent initialization against the JAX package's
(ROADMAP C.2); the inputs that still raise; and the unit pieces
(`ControlSpec`, `cell_values`, `initial_current_guess`) against their JAX
counterparts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import petlion_tpu as pt
import petlion_tpu_torch as ptt
from petlion_tpu.ops.plan import get_plan as jax_get_plan
from petlion_tpu.physics.initial_guess import initial_guess as jax_initial_guess
from petlion_tpu.solver import bdf as jax_bdf
from petlion_tpu.solver import control as jax_control
from petlion_tpu.solver.newton import consistent_init as jax_consistent_init
from petlion_tpu.solver.run import initial_current_guess as jax_icg
from petlion_tpu_torch.ops.plan import get_plan
from petlion_tpu_torch.physics.initial_guess import initial_guess
from petlion_tpu_torch.solver import bdf, control
from petlion_tpu_torch.solver.newton import consistent_init
from petlion_tpu_torch.solver.run import initial_current_guess

torch.set_num_threads(1)

# every run records t and V (so that JAX compiles one program per method)
OUT = dict(outputs=("t", "V"))


def close_runs(sj, st, rtol=1e-8, same_repr=True):
    """The port's Solution `st` is the JAX package's `sj`: the same runs,
    flags, exit reasons and step and attempt counts; t and V within `rtol`
    point by point; I, P and SOC within `rtol` of their largest magnitude
    over the runs (at least 1: they cross or rest at 0, and a derivative
    hold's current amplifies the rounding of the step sizes, 1.1e-8 of the
    point's own value on test_torch_dc_hold.py's anode hold); Y_final
    within `rtol` relative to 1 + |Y|. `same_repr`: the inputs' repr must be equal too
    (not for holds, whose setpoint each package reads off its own state)."""
    assert len(st) == len(sj)
    fields = ["method", "flag", "exit_reason", "n_steps", "n_rejected",
              "run_index", "init_converged", "truncated"]
    for rj, rt in zip(sj.results, st.results):
        for f in fields + (["input_repr"] if same_repr else []):
            assert getattr(rt, f) == getattr(rj, f), (f, getattr(rt, f), getattr(rj, f))
        np.testing.assert_allclose(rt.tspan, rj.tspan, rtol=rtol)
    for k in ("t", "V", "I", "P", "SOC"):
        assert st.arrays[k].shape == sj.arrays[k].shape, k
        if k in ("I", "P", "SOC"):
            np.testing.assert_allclose(st.arrays[k], sj.arrays[k], rtol=0, err_msg=k,
                                       atol=rtol * max(1.0, np.abs(sj.arrays[k]).max()))
        else:
            np.testing.assert_allclose(st.arrays[k], sj.arrays[k], rtol=rtol, err_msg=k)
    gap = np.max(np.abs(st.Y_final - sj.Y_final) / (1 + np.abs(sj.Y_final)))
    assert gap < rtol, gap


@pytest.fixture(scope="module")
def models():
    return pt.petlion(pt.LCO), ptt.petlion(ptt.LCO, device="cpu")


# --- C.2: the float32 consistent initialization ------------------------------

# (SOC, current) of five cells; LCO, abstol 1e-3, reltol 1e-3, tf 600 s
INIT_CASES = np.array([(1.0, -1.0), (0.8, -1.0), (0.5, -1.0), (0.2, 1.0), (0.5, 2.0)])


def _port_init(dtype):
    p = ptt.petlion(ptt.LCO, device="cpu", dtype=dtype)
    B = len(INIT_CASES)
    kw = dict(dtype=dtype, device="cpu")
    th = {k: v.reshape(1, 1).expand(B, 1) for k, v in p.theta.items()}
    soc0 = torch.as_tensor(INIT_CASES[:, 0], **kw)
    value = torch.as_tensor(INIT_CASES[:, 1], **kw)
    spec = control.ControlSpec("I")
    data = dict(th, _v=value[:, None])

    def F(t, y, yp, d):
        return control.full_residual(spec, d["_v"][:, 0], t, y, yp, d, p.cfg)

    y0 = initial_current_guess(spec, value, initial_guess(soc0, th, p.cfg), data,
                               p.cfg, torch.zeros_like(value),
                               torch.zeros(B, dtype=torch.bool))
    with torch.no_grad():
        init = consistent_init(F, y0, p.cfg.layout.N_diff, data, reltol_init=1e-3,
                               jac_plan=get_plan(p.cfg, p.theta_floats()), th=th)
    h0 = bdf.initial_step_size(init.y, init.yp, 1e-3, 1e-3, 600.0)
    return [x.numpy().astype(np.float64) for x in (init.y, init.yp, h0)]


def _jax_init32():
    """The JAX package's initialization as its run takes it (jit of a vmap
    over the cells), in float32."""
    with jax.enable_x64(False):
        p = pt.petlion(pt.LCO)
        dt = jnp.float32
        th = p._theta_dev(dt)
        plan = jax_get_plan(p.cfg, p.theta)
        spec = jax_control.ControlSpec("I")

        def one(soc, val):
            def F(t, y, yp):
                return jax_control.full_residual(spec, val, t, y, yp, th, p.cfg)
            y0 = jax_icg(spec, val, jax_initial_guess(soc, th, p.cfg, dt), soc, th,
                         p.cfg, jnp.asarray(0.0, dt), jnp.asarray(False))
            init = jax_consistent_init(F, y0, p.cfg.layout.N_diff, reltol_init=1e-3,
                                       maxiter=100, c_e0=1000.0, jac_plan=plan, th=th)
            return init.y, init.yp, jax_bdf.initial_step_size(init.y, init.yp, 1e-3,
                                                              1e-3, 600.0)

        out = jax.jit(jax.vmap(one))(jnp.asarray(INIT_CASES[:, 0], dt),
                                     jnp.asarray(INIT_CASES[:, 1], dt))
        return [np.asarray(x, np.float64) for x in out]


def test_float32_init_as_close_to_float64_as_jax():
    """ROADMAP C.2, settled: the port's float32 consistent initialization
    follows the JAX package's to float32 rounding, stage by stage, and the
    two part only where the finite difference of the algebraic YP
    amplifies that rounding (by 1/dt ≈ 92). Per cell: y agrees with JAX's
    float32 y to 1e-9 of its scale (measured ≤ 1.8e-11); YP of the
    differential states agrees with JAX's float32 YP within 4× the larger
    of the two packages' float32 errors against float64 (measured: at most
    1.61×, 1.76e-5 apart where each lies ≤ 1.09e-5 off). The algebraic YP and the first step h0 of both packages lie
    percent and per-mille off float64; over the five cells the port's
    largest error is at most 3× JAX's largest (measured: algebraic YP
    2.23e-2 against 3.20e-2, h0 2.51e-3 against 1.54e-3)."""
    y32, yp32, h32 = _port_init(torch.float32)
    y64, yp64, h64 = _port_init(torch.float64)
    jy, jyp, jh = _jax_init32()
    nd = ptt.petlion(ptt.LCO, device="cpu").cfg.layout.N_diff

    def err(a, ref, sl=slice(None)):
        a, ref = a[:, sl], ref[:, sl]
        return np.abs(a - ref).max(axis=1) / np.abs(ref).max(axis=1)

    assert (err(y32, jy) < 1e-9).all()
    d = slice(0, nd)
    assert (err(yp32, jyp, d) <= 4 * np.maximum(err(yp32, yp64, d), err(jyp, yp64, d))).all()
    a = slice(nd, None)
    e_port, e_jax = err(yp32, yp64, a), err(jyp, yp64, a)
    h_port, h_jax = np.abs(h32 / h64 - 1), np.abs(jh / h64 - 1)
    print("algebraic YP error vs float64: port", e_port, "JAX", e_jax)
    print("h0 error vs float64: port", h_port, "JAX", h_jax)
    assert e_port.max() <= 3 * e_jax.max() and e_port.max() < 0.05
    assert h_port.max() <= 3 * h_jax.max() and h_port.max() < 5e-3


# --- the inputs against the JAX package --------------------------------------

def test_constant_voltage_and_power(models):
    """V = 3.5 and P = −10 W/m² for 600 s from SOC 0.5: the JAX runs, and
    the setpoint held (V to 1e-6, P to 1e-6). `batch_simulate` with a
    per-cell `value_batch` of voltages runs each cell as `simulate` does
    (t and V within 1e-9: a batch of two rounds its products apart from a
    single cell's, 1.5e-11 on t)."""
    pj, p = models
    runs = {}
    for kw in (dict(V=3.5), dict(P=-10.0)):
        st = runs[next(iter(kw))] = ptt.simulate(p, 600.0, SOC=0.5, **kw, **OUT)
        close_runs(pt.simulate(pj, 600.0, SOC=0.5, **kw, **OUT), st)
        assert st.final_exit_reason() == "Final time reached"
    assert abs(runs["P"].P[-1] + 10.0) < 1e-6
    assert abs(runs["V"].V[-1] - 3.5) < 1e-6
    got = ptt.batch_simulate(p, 600.0, n_cells=2, V=3.5, value_batch=[3.5, 3.6], SOC=0.5,
                             max_save=128, **OUT)
    for b, sol in enumerate((runs["V"], ptt.simulate(p, 600.0, V=3.6, SOC=0.5, **OUT))):
        n = int(got.n_saved[b])
        for k in ("t", "V"):
            np.testing.assert_allclose(got.bufs[k][b, :n].numpy(), sol.arrays[k],
                                       rtol=1e-9, atol=0)


def test_cc_cv_hold_and_I_min_stop(models):
    """The CC→CV flow: 2C from SOC 0 to V_max 4.1 V, then V="hold" until
    the current tapers to I_min = 0.05C (or SOC_max): the JAX runs (the
    hold's setpoint read off each package's own last state), and power
    continuous across the boundary (rtol 1e-3)."""
    pj, p = models
    sj = pt.simulate(pj, I=2, SOC=0, V_max=4.1, **OUT)
    st = ptt.simulate(p, I=2, SOC=0, V_max=4.1, **OUT)
    assert st.final_exit_reason() == "Above max. voltage"
    sj = pt.simulate_cont(sj, pj, V="hold", I_min=0.05, SOC_max=1.0)
    st = ptt.simulate_cont(st, p, V="hold", I_min=0.05, SOC_max=1.0)
    close_runs(sj, st, same_repr=False)
    assert float(st.results[1].input_repr) == pytest.approx(4.1, abs=1e-6)
    if st.final_exit_reason() == "Below min. C-rate":
        assert abs(st.I[-1] - 0.05) < 5e-3
    else:
        assert st.final_exit_reason() == "Above max. SOC"
    r0, r1 = st.results
    np.testing.assert_allclose(st.P[r0.run_index][-1], st.P[r1.run_index][0], rtol=1e-3)


def test_eta_plating_rest_and_holds(models):
    """η_p = 0.05 V for 60 s from SOC 0.5 (held to 1e-6), then P = "rest",
    P = "hold" and η_p = "hold" in turn: the JAX runs."""
    pj, p = models
    sj = pt.simulate(pj, 60.0, eta_p=0.05, SOC=0.5, **OUT)
    st = ptt.simulate(p, 60.0, eta_p=0.05, SOC=0.5, **OUT)
    assert st.final_exit_reason() == "Final time reached"
    assert abs(p.layout.eta_plating(st.Y_final) - 0.05) < 1e-6
    for kw in (dict(P="rest"), dict(I=-1.0), dict(P="hold"), dict(eta_p="hold")):
        sj = pt.simulate_cont(sj, pj, 60.0, **kw)
        st = ptt.simulate_cont(st, p, 60.0, **kw)
    close_runs(sj, st, same_repr=False)
    r = st.results
    assert r[1].input_repr == "0.0" and np.all(np.abs(st[1].P) < 1e-5)
    assert float(r[3].input_repr) == pytest.approx(st[2].P[-1], rel=1e-12)
    assert np.all(np.abs(st[3].P - st[2].P[-1]) < 1e-6)
    assert st.exit_reasons() == ["Final time reached"] * 5


def test_initial_states_roundtrip(models):
    """initial_states= starts from an explicit state (the midpoint of a
    600 s 1C discharge): the JAX run from the same state, and V(0) within
    1e-6 of the state it came from."""
    pj, p = models
    s1 = ptt.simulate(p, 600.0, I=-1, SOC=1, outputs=("t", "V", "Y"))
    mid = len(s1.t) // 2
    y_mid = s1.arrays["Y"][mid]
    st = ptt.simulate(p, 60.0, I=-1, initial_states=y_mid, **OUT)
    close_runs(pt.simulate(pj, 60.0, I=-1, initial_states=y_mid, **OUT), st)
    assert st.final_exit_reason() == "Final time reached"
    assert abs(st.V[0] - s1.V[mid]) < 1e-6


def test_unported_inputs_raise_and_unit_cases(models):
    """dT/T (the thermal model), jac_reuse and step_control="ida" raise
    NotImplementedError; ControlSpec refuses an unknown method; a user
    function's result must be a tensor on the run's device or a number;
    and initial_current_guess seeds the current as the JAX package's does
    for every method, fresh and continued (within 1e-15 relative: one
    rounding of the 1C current apart)."""
    pj, p = models
    for kw, match in ((dict(dT="hold"), "thermal"), (dict(T="hold"), "thermal"),
                      (dict(I=-1, jac_reuse=4), "jac_reuse"),
                      (dict(I=-1, step_control="ida"), "ida")):
        with pytest.raises(NotImplementedError, match=match):
            ptt.simulate(p, 10.0, SOC=0.5, **kw)
    with pytest.raises(ValueError):
        control.ControlSpec("Q")
    like = torch.zeros(3, 4, dtype=torch.float64)
    assert control.cell_values(2, like).tolist() == [2.0] * 3
    assert control.cell_values(torch.tensor([True, False, True]), like).dtype == torch.bool
    assert control.cell_values(torch.ones(3, 1), like).dtype == torch.float64
    for bad, err in ((np.ones(3), TypeError), (torch.ones(2), ValueError)):
        with pytest.raises(err):
            control.cell_values(bad, like)
    with pytest.raises(TypeError, match="meta"):
        control.cell_values(torch.ones(3, device="meta"), like)

    th_j = pj._theta_dev(jnp.float64)
    L = p.layout
    soc = 0.6
    yj = jax_initial_guess(soc, th_j, pj.cfg, jnp.float64)
    th = {k: v.reshape(1, 1) for k, v in p.theta.items()}
    y = initial_guess(torch.full((1,), soc, dtype=torch.float64), th, p.cfg)
    f = lambda t, yy, yp, thh: 0.3 * (1.0 + 0 * t)  # noqa: E731
    for method, func, value in (("I", None, -1.5), ("I", f, 0.0), ("V", None, 4.0),
                                ("V", None, 3.0), ("eta_p", None, 0.05),
                                ("P", None, -12.0), ("P", f, 0.0), ("res", f, 0.0)):
        for prev, has in ((0.0, False), (0.7, True), (0.0, True)):
            got = initial_current_guess(
                control.ControlSpec(method, func), torch.full((1,), value, dtype=torch.float64),
                y, th, p.cfg, torch.full((1,), prev, dtype=torch.float64),
                torch.full((1,), has))
            want = jax_icg(jax_control.ControlSpec(method, func), value, yj, soc, th_j,
                           pj.cfg, jnp.asarray(prev), jnp.asarray(has))
            assert float(L.I(got[0])) == pytest.approx(float(pj.layout.I(want)),
                                                       rel=1e-15), (method, value, prev, has)

"""Derivative holds (dc_s_p_*, dc_s_n_*, dc_e_*) and user residuals (res=)
in the port on the CPU in float64 against the JAX package: two batched
cells holding different nodes, each picked from the cell's own starting
state; the anode and electrolyte holds after a discharge in `simulate`;
and res= in its (value, f) and f forms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petlion_tpu as pt
import petlion_tpu_torch as ptt
from petlion_tpu.ops.plan import get_plan as jax_get_plan
from petlion_tpu.sim import _build_control as jax_build_control
from petlion_tpu.solver import events as jax_events
from petlion_tpu.solver.run import run_once as jax_run_once
from petlion_tpu_torch.ops.plan import get_plan
from petlion_tpu_torch.physics.initial_guess import initial_guess
from petlion_tpu_torch.sim import _build_control
from petlion_tpu_torch.solver import events
from petlion_tpu_torch.solver.run import run_once
from test_torch_control import OUT, close_runs

torch.set_num_threads(1)

PJ_LAYOUT = pt.petlion(pt.LCO).layout


@pytest.fixture(scope="module")
def models():
    return pt.petlion(pt.LCO), ptt.petlion(ptt.LCO, device="cpu")


def test_batched_dc_hold_per_cell_nodes(models):
    """dc_s_p_max = "hold" on two cells whose cathode particles 2 and 7
    carry opposite radial gradients: each cell picks its own node from its
    own starting state and holds that node's surface derivative at 0 while
    the other node relaxes; the JAX package's batched run on the same route
    (flags and counts equal, Y_final and YP_final within 1e-8 of their
    scale)."""
    pj, p = models
    L = p.layout
    idx_all = L.c_s_surface_slice("p")
    n2, n7 = int(idx_all[2]), int(idx_all[7])
    r_p, base_p = p.N.r_p, L.sl("c_s_avg", "p").start
    y0 = initial_guess(torch.full((1,), 0.5, dtype=torch.float64),
                       {k: v.reshape(1, 1) for k, v in p.theta.items()}, p.cfg)[0]

    def grad(y, part, delta):
        y = y.clone()
        y[base_p + part * r_p:base_p + (part + 1) * r_p] += torch.linspace(
            0.0, delta, r_p, dtype=torch.float64)
        return y

    y_start = torch.stack([grad(grad(y0, 2, 50.0), 7, 30.0),
                           grad(grad(y0, 2, 30.0), 7, 50.0)])
    name, spec, value, is_rest, is_th = _build_control(p, None, {"dc_s_p_max": "hold"})
    th = {k: v.reshape(1, 1).expand(2, 1) for k, v in p.theta.items()}
    assert spec.init_aux(y_start, th)[:, 0].tolist() == [n2, n7]
    bounds = {k: torch.full((2,), v, dtype=torch.float64)
              for k, v in events.bounds_dict(p.bounds).items()}
    opts = p.opts.replace(max_save=32, maxiters=200)
    with torch.no_grad():
        got = run_once(y_start=y_start, soc0=torch.full((2,), 0.5, dtype=torch.float64),
                       value=torch.zeros(2, dtype=torch.float64), tf=5.0, th=th,
                       bounds=bounds, cfg=p.cfg, spec=spec, opts=opts,
                       jac_plan=get_plan(p.cfg, p.theta_floats()))
    yp = got.yp_final.numpy()
    assert (got.flag.numpy() == 0).all()
    assert abs(yp[0, n2]) < 1e-7 < abs(yp[0, n7])
    assert abs(yp[1, n7]) < 1e-7 < abs(yp[1, n2])
    assert abs(yp[0, n7]) > 50 * abs(yp[0, n2]) and abs(yp[1, n2]) > 50 * abs(yp[1, n7])

    _, spec_j, *_ = jax_build_control(pj, None, {"dc_s_p_max": "hold"})
    th_j = pj._theta_dev(jnp.float64)
    bd_j = {k: jnp.asarray(v, jnp.float64)
            for k, v in jax_events.bounds_dict(pj.bounds).items()}
    plan_j = jax_get_plan(pj.cfg, pj.theta)
    ref = jax.jit(jax.vmap(lambda ys: jax_run_once(
        y_start=ys, soc0=jnp.asarray(0.5), value=0.0, tf=jnp.asarray(5.0), th=th_j,
        bounds=bd_j, cfg=pj.cfg, spec=spec_j, jac_plan=plan_j,
        opts=pj.opts.replace(max_save=32, maxiters=200))))(jnp.asarray(y_start.numpy()))
    for k in ("flag", "n_steps", "n_rejected", "n_saved"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)))
    for k in ("y_final", "yp_final"):
        a, r = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        assert np.abs(a - r).max() <= 1e-8 * np.abs(r).max(), k


@pytest.fixture(scope="module")
def discharged(models, tmp_path_factory):
    """The port's 60 s 1C discharge from SOC 0.8, and the same Solution
    loaded by the JAX package from its checkpoint (the two packages share
    the format), so that both continue from one state."""
    _, p = models
    st = ptt.simulate(p, 60.0, I=-1, SOC=0.8, **OUT)
    path = tmp_path_factory.mktemp("dc") / "discharged.npz"
    st.save(str(path))
    return str(path)


@pytest.mark.parametrize("hold", ["dc_s_n_min", "dc_e_max"])
def test_dc_holds_in_simulate(models, discharged, hold):
    """After a 60 s 1C discharge, a 30 s derivative hold on the anode's
    least-lithiated surface node or the electrolyte's richest node: the JAX
    continuation from the same state (rtol 1e-8), with that node's
    derivative held at 0 to 1e-9 of the state's largest rate."""
    pj, p = models
    sj, st = pt.Solution.load(discharged), ptt.Solution.load(discharged)
    y_end = st.Y_final.copy()
    sj = pt.simulate_cont(sj, pj, 30.0, **{hold: "hold"})
    st = ptt.simulate_cont(st, p, 30.0, **{hold: "hold"})
    close_runs(sj, st)
    assert st.exit_reasons() == ["Final time reached"] * 2
    L = p.layout
    if hold.startswith("dc_s"):
        idx = L.c_s_surface_slice("n")
    else:
        s = L.sl("c_e")
        idx = np.arange(s.start, s.stop)
    node = idx[np.argmin(y_end[idx]) if hold.endswith("min") else np.argmax(y_end[idx])]
    nd = L.N_diff
    assert abs(st.YP_final[node]) < 1e-9 * np.abs(st.YP_final[:nd]).max()


def _current_jax(t, y, yp, th):
    return PJ_LAYOUT.I(y)


@pytest.mark.parametrize("form", ["value_and_f", "f"])
def test_res_forms(models, form):
    """res=(−1.0, f) and res=f with f the current: the first pins I = −1C,
    the second I = 0 (60 s from SOC 0.5): the JAX runs (rtol 1e-8; one JAX
    program for both forms, as the function is the same) and the current
    held to 1e-9."""
    pj, p = models

    def current(t, y, yp, th):
        return p.layout.I(y)

    value = -1.0 if form == "value_and_f" else 0.0
    res_j = (value, _current_jax) if form == "value_and_f" else _current_jax
    res_t = (value, current) if form == "value_and_f" else current
    st = ptt.simulate(p, 60.0, res=res_t, SOC=0.5, **OUT)
    close_runs(pt.simulate(pj, 60.0, res=res_j, SOC=0.5, **OUT), st)
    assert st.final_exit_reason() == "Final time reached"
    assert np.abs(st.I[1:] - value).max() < 1e-9

"""User stop hooks (`stop_function`, exit flag 12) and per-cell stop times
with a function input, in the port on the CPU in float64 against the JAX
package: a boolean hook (the stop on the accepted step), a signed-margin
hook (the crossing localized on the dense output), `check_stop`'s
branches per control method, and the batched GITT pulse (per-cell pulse
ends read from θ, per-cell tdiscon) at B = 3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petlion_tpu as pt
import petlion_tpu_torch as ptt
from petlion_tpu.parallel.batch import batch_simulate as jax_batch
from petlion_tpu.solver import events as jax_events
from petlion_tpu_torch.physics.initial_guess import initial_guess
from petlion_tpu_torch.solver import events, run
from test_torch_control import close_runs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return pt.petlion(pt.LCO), ptt.petlion(ptt.LCO, device="cpu")


@pytest.fixture(scope="module")
def boolean_stop(models):
    """The port's 1C discharge from SOC 1 stopped by the boolean hook
    `V < 3.9` (shared by the hook and margin tests)."""
    _, p = models
    return ptt.simulate(p, I=-1, SOC=1, stop_function=lambda t, y, yp, soc, th:
                        p.layout.V(y) < 3.9)


def test_stop_function_hook(models, boolean_stop):
    """A boolean hook `V < 3.9` stops the 1C discharge with flag 12 on the
    accepted step past the crossing: the JAX run. A hook that never fires
    leaves the run to its horizon (port only, 600 s)."""
    pj, p = models
    sj = pt.simulate(pj, I=-1, SOC=1, stop_function=lambda t, y, yp, soc, th:
                     pj.layout.V(y) < 3.9)
    st = boolean_stop
    close_runs(sj, st)
    assert st.final_exit_reason() == "Stop function triggered"
    assert st.results[-1].flag == 12
    assert st.V[-1] < 3.9 and st.t[-1] < 3600.0
    never = ptt.simulate(p, 600.0, I=-1, SOC=1,
                         stop_function=lambda t, y, yp, soc, th: t > 1e9)
    assert never.final_exit_reason() == "Final time reached"
    assert never.results[-1].flag == 0 and abs(never.t[-1] - 600.0) < 1e-9


def test_stop_function_margin_localized(models, boolean_stop):
    """A signed margin `3.9 − V` is bisected on the dense output like the
    built-in bounds: the JAX run, the final V on 3.9 V within 1e-5, and
    before the boolean form's stop."""
    pj, p = models
    sj = pt.simulate(pj, I=-1, SOC=1, stop_function=lambda t, y, yp, soc, th:
                     3.9 - pj.layout.V(y))
    st = ptt.simulate(p, I=-1, SOC=1, stop_function=lambda t, y, yp, soc, th:
                      3.9 - p.layout.V(y))
    close_runs(sj, st)
    assert st.results[-1].flag == 12
    assert st.final_exit_reason() == "Stop function triggered"
    assert abs(st.V[-1] - 3.9) < 1e-5
    boolean = boolean_stop
    assert boolean.results[-1].flag == 12 and boolean.V[-1] < 3.9
    assert boolean.t[-1] > st.t[-1]


def test_check_stop_matches_jax(models):
    """`check_stop` on six cells, each just past one bound (V_max, V_min,
    I_max, I_min, η_plating_min, and the hooks' cell), for every control
    method, without a hook, with a boolean hook and with a margin hook: the
    JAX package's flags, and t_frac and the monitored values to 1e-12 (the
    I bounds fire for non-I runs only, the V bounds not for V runs)."""
    pj, p = models
    L = p.layout
    B = 6
    f64 = dict(dtype=torch.float64)
    th = {k: v.reshape(1, 1).expand(B, 1) for k, v in p.theta.items()}
    y = initial_guess(torch.full((B,), 0.5, **f64), th, p.cfg)
    y[:, L.sl("I").start] = torch.tensor([0.5, -0.5, 1.0, -1.0, 0.3, -0.3], **f64)
    # one derivative sign per cell, toward its bound
    yp = torch.zeros_like(y)
    yp[0, L.sl("Phi_s").start] = 1e-3
    yp[1, L.sl("Phi_s").start] = -1e-3
    yp[2, L.sl("I").start] = 1e-3
    yp[3, L.sl("I").start] = -1e-3
    yp[4, L.sl("Phi_s", "n").start] = -1e-3
    t = torch.full((B,), 100.0, **f64)
    soc = torch.full((B,), 0.5, **f64)
    V, I, eta = L.V(y), L.I(y), L.eta_plating(y)
    nan = torch.full((B,), float("nan"), **f64)
    bounds = {k: nan.clone() for k in events.BOUND_KEYS}
    bounds["V_max"][0], bounds["V_min"][1] = V[0] - 1e-3, V[1] + 1e-3
    bounds["I_max"][2], bounds["I_min"][3] = I[2] - 0.05, I[3] + 0.05
    bounds["eta_plating_min"][4] = eta[4] + 1e-3
    prev = events.BoundsPrev.init(t)._replace(
        V=V + torch.tensor([-2e-3, 2e-3, 0, 0, 0, 0], **f64),
        I=I + torch.tensor([0, 0, -0.1, 0.1, 0, 0], **f64),
        eta_plating=eta + 2e-3, stop_g=torch.full((B,), -0.1, **f64))
    flag = torch.full((B,), -1, dtype=torch.int64)
    thr = V + torch.tensor([1, 1, 1, 1, 1, -1e-4], **f64)   # the margin's threshold
    hooks = {"none": (None, None),
             "bool": (lambda t, y, yp, soc, th: t > 50.0,
                      lambda t, y, yp, soc, th: t > 50.0),
             "margin": (lambda t, y, yp, soc, th: L.V(y) - thr,
                        lambda t, y, yp, soc, th: pj.layout.V(y) - thr_b)}
    thj = pj._theta_dev(jnp.float64)
    fired = set()
    for method in ("I", "V", "P", "eta_p", "res"):
        for hook, (f_port, f_jax) in hooks.items():
            got_prev, got_flag = events.check_stop(
                t, y, yp, soc, prev, flag, bounds, th, p.cfg, method, reltol=1e-3,
                tf=600.0, stop_fn=f_port)
            for b in range(B):
                thr_b = float(thr[b])
                want_prev, want_flag = jax_events.check_stop(
                    jnp.asarray(float(t[b])), jnp.asarray(y[b].numpy()),
                    jnp.asarray(yp[b].numpy()), jnp.asarray(float(soc[b])),
                    jax_events.BoundsPrev(*(jnp.asarray(float(x[b])) for x in prev)),
                    jnp.asarray(-1, jnp.int32), {k: float(v[b]) for k, v in bounds.items()},
                    thj, pj.cfg, method, reltol=1e-3, tf=600.0, stop_fn=f_jax)
                assert int(got_flag[b]) == int(want_flag), (method, hook, b)
                for name in ("t_frac", "V", "I", "eta_plating", "stop_g"):
                    np.testing.assert_allclose(float(getattr(got_prev, name)[b]),
                                               float(getattr(want_prev, name)),
                                               rtol=1e-12, err_msg=str((method, hook, b, name)))
                fired.add(int(want_flag))
    assert {1, 2, 7, 8, 11, 12} <= fired


def test_batched_per_cell_tstops_gitt():
    """Batched GITT pulses (1C off at each cell's own time, read from θ)
    with per-cell tdiscon, B = 3, 900 s: the JAX batch's flags, counts and
    recorded t and I (rtol 1e-8), one recorded point within 1e-2 s of each
    cell's pulse end, I = −1 before it and 0 after it, and every cell at
    tf."""
    t_off = np.array([250.0, 450.0, 650.0])
    kw = dict(SOC=1.0, theta_batch={"t_pulse_off": t_off}, tdiscon=t_off[:, None],
              outputs=("t", "I"), max_save=512)
    ref = jax_batch(pt.petlion(pt.LCO), 900.0, **kw,
                    I=lambda t, y, yp, th: jnp.where(t < th["t_pulse_off"], -1.0, 0.0))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    run.reset_trip_counts()
    got = ptt.batch_simulate(
        ptt.petlion(ptt.LCO, device="cpu"), 900.0, **kw,
        I=lambda t, y, yp, th: torch.where(t < th["t_pulse_off"][:, 0], -1.0, 0.0))
    assert run.TRIPS["reinit"] == 3
    for k in ("flag", "n_steps", "n_rejected", "n_saved"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(ref, k), err_msg=k)
    np.testing.assert_allclose(got.bufs["t"].numpy(), ref.bufs["t"], rtol=1e-8, atol=0)
    np.testing.assert_allclose(got.bufs["I"].numpy(), ref.bufs["I"], rtol=1e-8, atol=1e-12)
    assert (got.flag.numpy() == 0).all()
    t, I, n = got.bufs["t"].numpy(), got.bufs["I"].numpy(), got.n_saved.numpy()
    for i, to in enumerate(t_off):
        ti, Ii = t[i, :n[i]], I[i, :n[i]]
        assert np.min(np.abs(ti - to)) < 1e-2
        assert np.all(np.abs(Ii[ti < to - 0.01] + 1.0) < 1e-3)
        after = Ii[ti > to + 0.5]
        assert after.size and np.all(np.abs(after) < 1e-3)
        assert abs(ti[-1] - 900.0) < 1.0

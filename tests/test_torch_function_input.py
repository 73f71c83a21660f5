"""Function inputs of the port's `simulate` (batch-first user functions,
see petlion_tpu_torch/solver/control.py) on the CPU in float64 against the
JAX package's: a constant written as a function and a cosine current (one
batch of two cells in each package), and
steps in I, V, P and η_p across a declared discontinuity, where each
package re-initializes the run at the jump. Every function is written once
with jnp for the JAX package and once with torch for the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import petlion_tpu as pt
import petlion_tpu_torch as ptt
from petlion_tpu.parallel.batch import batch_simulate as jax_batch
from petlion_tpu_torch.solver import run
from test_torch_control import close_runs
from torch_shared import shared

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return pt.petlion(pt.LCO), ptt.petlion(ptt.LCO, device="cpu")


def _step(t, t_switch, a, b):
    """a before t_switch, b after, in t's dtype (torch.where of two Python
    numbers would give the default dtype, float32)."""
    return torch.where(t < t_switch, torch.full_like(t, a), torch.full_like(t, b))


# cell 0: I = −cos(2πt/600); cell 1: I = −1 written as a function; both
# from one function reading its coefficients from θ, so that the JAX
# package compiles one program for the two
WAVE = {"a_const": np.array([0.0, 1.0]), "a_cos": np.array([1.0, 0.0])}
WAVE_KW = dict(SOC=1.0, theta_batch=WAVE, outputs=("t", "V", "I", "SOC"), max_save=256)


@pytest.fixture(scope="module")
def waves(models, request):
    """The two function inputs as one batch of two cells in each package
    (600 s from SOC 1; the JAX run computed once per session, see
    torch_shared.py), and the port's constant current I = −1 alone."""
    pj, p = models
    ref = shared(request, "function_input_waves", lambda: jax.tree_util.tree_map(
        np.asarray, jax_batch(pj, 600.0, **WAVE_KW, I=lambda t, y, yp, th: -(
            th["a_const"] + th["a_cos"] * jnp.cos(2 * jnp.pi * t / 600)))))
    run.reset_trip_counts()
    got = ptt.batch_simulate(p, 600.0, **WAVE_KW, I=lambda t, y, yp, th: -(
        th["a_const"][:, 0] + th["a_cos"][:, 0] * torch.cos(2 * torch.pi * t / 600)))
    trips = dict(run.TRIPS)
    return ref, got, trips, ptt.simulate(p, 600.0, I=-1, SOC=1)


def _close_batch_cell(ref, got, b, rtol=1e-8):
    """Cell b of the port's batch is the JAX batch's: flag and counts
    equal, t and V within `rtol` point by point, I and SOC within `rtol`
    of their largest magnitude."""
    for k in ("flag", "n_steps", "n_rejected", "n_saved"):
        assert int(getattr(got, k)[b]) == int(getattr(ref, k)[b]), k
    n = int(got.n_saved[b])
    for k in ("t", "V", "I", "SOC"):
        g, r = got.bufs[k][b, :n].numpy(), ref.bufs[k][b, :n]
        if k in ("I", "SOC"):
            np.testing.assert_allclose(g, r, rtol=0, atol=rtol * max(1.0, np.abs(r).max()),
                                       err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=rtol, err_msg=k)
    return {k: got.bufs[k][b, :n].numpy() for k in ("t", "V", "I", "SOC")}


def test_constant_vs_function_input_equal(models, waves):
    """I = (t) -> −1.0: the JAX run (rtol 1e-8, the same step and attempt
    counts); the same run as the constant I = −1 (rtol 1e-8); a function
    input takes the re-initialization probe on every step without ever
    jumping; and `simulate` records it as a function."""
    _, p = models
    ref, got, trips, const = waves
    cell = _close_batch_cell(ref, got, 1)
    assert trips["reinit"] == 0 and trips["trips"] > 0
    np.testing.assert_allclose(cell["V"][-1], const.V[-1], rtol=1e-8)
    np.testing.assert_allclose(cell["t"][-1], const.t[-1], rtol=1e-8)
    assert int(got.n_steps[1]) == const.results[0].n_steps
    st = ptt.simulate(p, 600.0, I=lambda t: -1.0, SOC=1)
    np.testing.assert_allclose(st.V[-1], const.V[-1], rtol=1e-8)
    assert st.results[0].input_repr == "function"


def test_function_input_differs_from_constant(waves):
    """I = −cos(2πt/600): the JAX run (rtol 1e-8, the same step and attempt
    counts), and a different V and SOC from the constant current's."""
    ref, got, _, const = waves
    cell = _close_batch_cell(ref, got, 0)
    assert abs(cell["V"][-1] - const.V[-1]) > 1e-3
    assert abs(cell["SOC"][-1] - const.SOC[-1]) > 1e-2


def test_step_input_with_tdiscon(models):
    """A current step from −1C to −0.1C at 300 s with tdiscon=[300]: the
    JAX run, one re-initialization at the jump, the currents on both sides
    to 1e-6, a point within 1 s of the jump, and the charge balance."""
    pj, p = models
    kw = dict(SOC=0.8, tdiscon=[300.0], outputs=("t", "V"))
    sj = pt.simulate(pj, 600.0, I=lambda t: jnp.where(t < 300.0, -1.0, -0.1), **kw)
    run.reset_trip_counts()
    st = ptt.simulate(p, 600.0, I=lambda t: _step(t, 300.0, -1.0, -0.1), **kw)
    assert run.TRIPS["reinit"] == 1
    close_runs(sj, st)
    assert st.final_exit_reason() == "Final time reached"
    t, I = st.t, st.I
    assert abs(I[-1] + 0.1) < 1e-6
    assert abs(I[np.searchsorted(t, 100.0)] + 1.0) < 1e-6
    assert np.min(np.abs(t - 300.0)) < 1.0
    dsoc = np.trapezoid(I, t) / 3600.0
    assert abs((st.SOC[-1] - 0.8) - dsoc) < 1e-3


# (name, tf, jump time, value before, value after), from SOC 0.5
STEPS = [("V", 200.0, 100.0, 3.85, 3.9), ("P", 200.0, 100.0, -10.0, -5.0),
         ("eta_p", 60.0, 30.0, 0.05, 0.08)]


@pytest.mark.parametrize("name,tf,t_jump,a,b", STEPS, ids=[s[0] for s in STEPS])
def test_function_inputs_with_reinit(models, name, tf, t_jump, a, b):
    """A step in V, P or η_p with its tdiscon: the JAX run (rtol 1e-8, the
    same step and attempt counts), one re-initialization, and the setpoint
    held on both sides of the jump to 1e-6."""
    pj, p = models
    kw = dict(SOC=0.5, tdiscon=[t_jump], outputs=("t", "V"))
    sj = pt.simulate(pj, tf, **{name: lambda t: jnp.where(t < t_jump, a, b)}, **kw)
    run.reset_trip_counts()
    st = ptt.simulate(p, tf, **{name: lambda t: _step(t, t_jump, a, b)}, **kw)
    assert run.TRIPS["reinit"] == 1
    close_runs(sj, st)
    assert st.final_exit_reason() == "Final time reached"
    held = {"V": st.V, "P": st.P}.get(name)
    if held is None:    # η_p is not a recorded output: read it off Y_final
        held = np.array([p.layout.eta_plating(st.Y_final)])
    else:
        before = st.t < t_jump - 1.0
        assert np.abs(held[before] - a).max() < 1e-6
    assert abs(held[-1] - b) < 1e-6

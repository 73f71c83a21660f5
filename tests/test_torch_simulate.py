"""The port's single-cell API (`simulate`, `simulate_cont`, the options,
warnings and accessors) on the CPU in float64, against the JAX package's
`simulate` and the stored golden 1C discharge. (Single-cell `tstops` are
held against the JAX package in test_torch_tstops.py.)"""

import copy
import os
import warnings

import numpy as np
import pytest
import torch

import petlion_tpu as pt
import petlion_tpu_torch as ptt
from torch_shared import shared

torch.set_num_threads(1)

ORACLE = os.path.join(os.path.dirname(__file__), "data", "oracle_lco_1c.npz")
KW = dict(I=-1, SOC=1, outputs=("t", "V", "I", "SOC"))


@pytest.fixture(scope="module")
def models():
    return pt.petlion(pt.LCO), ptt.petlion(ptt.LCO, device="cpu")


@pytest.fixture(scope="module")
def runs(models, request):
    """A 600 s 1C discharge in both packages (the JAX run computed once per
    session, see torch_shared.py)."""
    pj, p = models
    return (shared(request, "simulate_600s", lambda: pt.simulate(pj, 600.0, **KW)),
            ptt.simulate(p, 600.0, **KW))


def _close_runs(sj, st):
    """Same runs: equal counts, flags and saved-point counts; t, V, I, SOC
    within rtol 1e-8 (SOC, which crosses 0 at the golden exit, also within
    1e-12 absolute); Y_final within 1e-8 relative to 1 + |Y|."""
    assert len(st) == len(sj)
    for rj, rt in zip(sj.results, st.results):
        for f in ("method", "input_repr", "flag", "exit_reason", "n_steps",
                  "n_rejected", "run_index", "init_converged", "truncated"):
            assert getattr(rt, f) == getattr(rj, f), f
        np.testing.assert_allclose(rt.tspan, rj.tspan, rtol=1e-8)
    for k in ("t", "V", "I", "SOC"):
        assert st.arrays[k].shape == sj.arrays[k].shape, k
        np.testing.assert_allclose(st.arrays[k], sj.arrays[k], rtol=1e-8,
                                   atol=1e-12 if k == "SOC" else 0, err_msg=k)
    assert np.max(np.abs(st.Y_final - sj.Y_final) / (1 + np.abs(sj.Y_final))) < 1e-8
    np.testing.assert_allclose(st.SOC_final, sj.SOC_final, rtol=1e-8, atol=1e-12)
    assert st._outputs == sj._outputs


def test_simulate_matches_jax(runs):
    """600 s at 1C: the JAX run's saved points, exit and final state."""
    sj, st = runs
    assert st.final_exit_reason() == "Final time reached"
    _close_runs(sj, st)


def test_simulate_cont_rest_matches_jax(models, runs):
    """Continuation with I="rest" (I = 0, bounds off) from the 1C run,
    against the JAX continuation at I = 0 (the same run while no bound
    fires; it reuses the first run's compiled program) and the port's own."""
    pj, p = models
    sj = pt.simulate_cont(copy.deepcopy(runs[0]), pj, 300.0, I=0.0)
    st = ptt.simulate_cont(copy.deepcopy(runs[1]), p, 300.0, I="rest")
    assert st.exit_reasons() == ["Final time reached"] * 2
    _close_runs(sj, st)
    zero = ptt.simulate_cont(copy.deepcopy(runs[1]), p, 300.0, I=0.0)
    for k in ("t", "V", "I", "SOC"):
        np.testing.assert_array_equal(zero.arrays[k], st.arrays[k])
    assert np.all(st[1].I == 0.0) and st.t[-1] == pytest.approx(900.0, abs=1e-6)
    # "hold" keeps the last current: the same run as I=-1 from that state
    held = ptt.simulate_cont(copy.deepcopy(runs[1]), p, 60.0, I="hold")
    again = ptt.simulate_cont(copy.deepcopy(runs[1]), p, 60.0, I=-1.0)
    np.testing.assert_array_equal(held.V, again.V)
    assert held.results[-1].input_repr == "-1.0"


def test_options_warnings_and_errors(models):
    """tf as a grid, initial_states, SOC/dtype overrides, the save_start
    warm start, the truncation and solver-failure warnings, and the input
    errors, as in the JAX package."""
    pj, p = models
    full = ptt.simulate(p, 300.0, I=-1, SOC=0.9, outputs=("t", "V", "Y", "YP"))
    grid = np.linspace(0.0, 300.0, 7)
    out = ptt.simulate(p, grid, I=-1, SOC=0.9, outputs=("t", "V", "Y", "YP"))
    np.testing.assert_array_equal(out.t, grid)
    np.testing.assert_allclose(out.V, full(grid).V, rtol=0, atol=1e-12)
    np.testing.assert_allclose(out.arrays["Y"], full(grid).arrays["Y"], rtol=0, atol=1e-12)

    th = {k: float(v) for k, v in pj.theta.items()}
    soc_jax = float(pj.cfg.layout.soc_from_state(full.Y_final, th))
    resumed = ptt.simulate(p, 60.0, I=-1, initial_states=full.Y_final)
    assert resumed.SOC[0] == pytest.approx(soc_jax, rel=1e-12)
    assert resumed.V[0] == pytest.approx(full.V[-1], abs=1e-6)

    f32 = ptt.simulate(p, 300.0, I=-1, SOC=0.9, dtype=torch.float32, abstol=1e-3)
    assert f32.V.dtype == np.float32 and f32.Y_final.dtype == np.float32
    assert np.max(np.abs(np.interp(grid, f32.t, f32.V) - out.V)) < 5e-3

    ws1 = ptt.simulate(p, 60.0, I=-2, SOC=0.7, save_start=True)
    ws2 = ptt.simulate(p, 60.0, I=-2, SOC=0.7, save_start=True)
    assert list(p._save_start) == [("I", 0.7, -2.0)]
    assert isinstance(p._save_start[("I", 0.7, -2.0)], np.ndarray)
    np.testing.assert_allclose(ws1.V[0], ws2.V[0], rtol=1e-10)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        short = ptt.simulate(p, 600.0, I=-1, SOC=1, max_save=4)
        failed = ptt.simulate(p, 3600.0, I=-1, SOC=1, maxiters=5)
    msgs = [str(x.message) for x in w]
    assert short.results[-1].truncated and any("max_save" in m for m in msgs)
    assert short.final_exit_reason() == "Final time reached"
    assert short.t[-1] == pytest.approx(600.0, abs=1e-6) and len(short.t) == 4
    assert failed.results[-1].flag == -2 and failed.final_exit_reason() == "Solver failure"
    assert any("solver failure" in m for m in msgs) and failed.t[-1] < 3600.0

    for bad, err in ((dict(I=-1, V=4.0), ValueError), (dict(I="hold"), ValueError),
                     (dict(I=-1, bogus=1), TypeError), (dict(dT="hold"), ValueError),
                     (dict(I=-1, SOC=0.0), ValueError)):
        with pytest.raises(err):
            ptt.simulate(p, 10.0, **bad)
    with pytest.raises(ValueError):
        ptt.simulate_cont(full, p, 10.0, I=-1, initial_states=full.Y_final)

    def thermal_without_t_amb(**kw):
        th, *rest = ptt.LCO(temperature=True)
        return ({k: v for k, v in th.items() if k != "T_amb"}, *rest)
    with pytest.raises(ValueError, match="T_amb"):
        ptt.petlion(thermal_without_t_amb, device="cpu")


def test_verbose_repr_and_accessors(models, runs, capsys):
    """The verbose header and summary, the Model repr (the JAX text line for
    line), and calc_OCV / calc_R_internal against the JAX package's."""
    pj, p = models
    ptt.simulate(p, 50.0, I=-1, SOC=1, verbose=True)
    out = capsys.readouterr().out
    assert "Run for I = -1C from t = 0.00 s (SOC 1.0000)" in out
    assert "PETLION-TPU simulation" in out
    assert repr(p).splitlines() == repr(pj).splitlines()
    for alias in ("Params", "run_model", "run_model_cont", "options_model",
                  "model_output", "solution", "boundary_stop_conditions",
                  "options_simulation", "discretizations_per_section",
                  "options_numerical"):
        assert getattr(ptt, alias).__name__ == getattr(pt, alias).__name__, alias
        assert alias in ptt.__all__
    y = runs[0].Y_final
    for a, b in zip(ptt.calc_OCV(y, p), pt.calc_OCV(y, pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=0)
    R = float(ptt.calc_R_internal(y, p))
    assert R == pytest.approx(float(pt.calc_R_internal(y, pj)), rel=1e-12)
    assert 1e-4 < R < 1e-1


def test_golden_1c_discharge_against_oracle(models):
    """The golden flow: 1C from SOC 1 exits "Below min. SOC" at 3600 s with
    V within 1% of the published 2.9357 V and SOC 0, and its saved V(t)
    tracks the float64 oracle trace within 2 mV up to 3500 s."""
    _, p = models
    sol = ptt.simulate(p, I=-1, SOC=1)
    assert sol.final_exit_reason() == "Below min. SOC"
    assert abs(sol.t[-1] - 3600.0) < 1.0 and abs(sol.SOC[-1]) < 1e-6
    assert abs(sol.V[-1] - 2.9357) / 2.9357 < 0.01
    oracle = np.load(ORACLE)
    keep = (sol.t >= oracle["t"][0]) & (sol.t <= 3500.0)
    assert keep.sum() > 20
    assert np.abs(sol.V[keep] - np.interp(sol.t[keep], oracle["t"], oracle["V"])).max() < 2e-3


@pytest.mark.slow
def test_golden_1c_discharge_matches_jax(models):
    pj, p = models
    kw = dict(I=-1, SOC=1, outputs=("t", "V", "I", "SOC"))
    _close_runs(pt.simulate(pj, **kw), ptt.simulate(p, **kw))

"""The port's protocol runners (`simulate_protocol`, `batch_protocol`) and
the thermal golden flow, on the CPU in float64 unless stated: the CC-CT-CV
fast charge of one thermal LCO cell through `simulate`/`simulate_cont` and
through `simulate_protocol` against the reference's trace (the constants
of tests/test_simulate.py), `simulate_protocol` against the port's own host
chaining, per-cell switching in `batch_protocol`, and one JAX program:
`batch_protocol` of two cells against the JAX package's, cell by cell. The
float32 thermal protocol and a float32 thermal batch are slow."""

import warnings

import numpy as np
import pytest
import torch

import petlion_tpu as pt
from petlion_tpu.protocols import batch_protocol as jax_batch_protocol

import petlion_tpu_torch as ptt
from petlion_tpu_torch.sim import _mean_T_host
from petlion_tpu_torch.solver import linsolve
from petlion_tpu_torch.solver.protocol import Segment, build_segments
from torch_shared import shared

torch.set_num_threads(1)

CCCV = [dict(I=2, V_max=4.1, SOC_max=1.0), dict(V="hold", SOC_max=1.0)]
CC_CT_CV = [dict(I=4, V_max=4.1, T_max=313.15), dict(dT="hold", V_max=4.1),
            dict(V="hold")]
EXITS = ["Above max. temperature", "Above max. voltage", "Above max. SOC"]


def _summary(sol, p):
    """What the golden checks read of a run, in plain types (shared
    between the xdist workers by pickle)."""
    return dict(exits=sol.exit_reasons(), methods=[r.method for r in sol.results],
                input_reprs=[r.input_repr for r in sol.results],
                steps=[(r.n_steps, r.n_rejected) for r in sol.results],
                t=float(sol.t[-1]), I=float(sol.I[-1]), V=float(sol.V[-1]),
                SOC=float(sol.SOC[-1]), mean_T=_mean_T_host(sol.Y_final, p),
                Y_final=np.asarray(sol.Y_final), T_final=sol.Y_final[p.layout.sl("T")],
                T=sol.arrays.get("T"), ct=sol.results[1].run_index)


def _golden_run(runner):
    """The thermal CC-CT-CV fast charge in float64 (4C to T_max 40 °C, the
    mean temperature held to V_max 4.1 V, then V held to SOC 1) through the
    chained `simulate` calls (T recorded) or `simulate_protocol`."""
    p = ptt.petlion(ptt.LCO, device="cpu", temperature=True)
    if runner == "simulate_protocol":
        return _summary(ptt.simulate_protocol(p, CC_CT_CV, SOC=0.0), p)
    sol = ptt.simulate(p, I=4, SOC=0, V_max=4.1, T_max=313.15, outputs=("t", "V", "T"))
    sol = ptt.simulate_cont(sol, p, dT="hold", V_max=4.1)
    return _summary(ptt.simulate_cont(sol, p, V="hold"), p)


@pytest.fixture(scope="module")
def golden64(request):
    """Each golden run once per test run (two workers may run one each)."""
    runs = {}

    def get(runner):
        if runner not in runs:
            runs[runner] = shared(request, f"cc_ct_cv_float64_{runner}",
                                  lambda: _golden_run(runner))
        return runs[runner]
    return get


@pytest.mark.parametrize("runner", ["simulate", "simulate_protocol"])
def test_cc_ct_cv_golden_float64(runner, golden64):
    """The float64 CC-CT-CV lands on the reference's trace (the bands of
    tests/test_simulate.py::test_cc_ct_cv_protocol_golden: 1865.61 s, final
    I 0.1959C, mean T 25.6963 °C) through the chained `simulate` calls (the
    dT hold's method "dT"; the recorded T stays in (298, 314) K and the CT
    segment holds the mean temperature at T_max) and through
    `simulate_protocol` (one RunResult a segment, the final T in kelvin)."""
    g = golden64(runner)
    assert g["exits"] == EXITS
    assert g["methods"][0] == "I"
    assert abs(g["t"] - 1865.61) / 1865.61 < 0.005
    assert abs(g["I"] - 0.1959) / 0.1959 < 0.025
    assert abs(g["V"] - 4.1) < 1e-3
    assert abs(g["SOC"] - 1.0) < 1e-3
    assert abs(g["mean_T"] - (25.6963 + 273.15)) < 0.1
    if runner == "simulate":
        assert g["methods"] == ["I", "dT", "V"]
        T = g["T"]
        assert 298.0 < T.min() and T.max() < 314.0
        assert np.all(np.abs(T[g["ct"]].mean(axis=1) - 313.15) < 0.05)
    else:
        assert g["input_reprs"] == ["given", "given", "hold"]
        assert np.all((g["T_final"] > 298.0) & (g["T_final"] < 314.0))


def test_protocol_matches_host_chaining(golden64):
    """`simulate_protocol` of the float64 CC-CT-CV equals `simulate` then
    `simulate_cont` with the mean temperature and then V held: the same
    exits and steps, final t, I and state."""
    a, b = golden64("simulate_protocol"), golden64("simulate")
    assert a["exits"] == b["exits"] == EXITS
    assert a["steps"] == b["steps"]
    np.testing.assert_allclose(a["t"], b["t"], rtol=1e-12)
    np.testing.assert_allclose(a["I"], b["I"], rtol=1e-10)
    np.testing.assert_allclose(a["Y_final"], b["Y_final"], rtol=1e-10, atol=1e-14)


def test_batch_protocol_per_cell_switching():
    """Four cells with D_sn × 0.5, 1, 2, 4 switch from CC to CV at four
    distinct times; every cell leaves CC at V_max (flag 2) and CV at SOC_max
    (flag 4), its SOC within 2e-3 of 1; a cell of the batch equals the same
    cell run alone."""
    p = ptt.petlion(ptt.LCO, device="cpu")
    tb = {"D_sn": 3.9e-14 * np.array([0.5, 1.0, 2.0, 4.0])}
    cc, cv = ptt.batch_protocol(p, CCCV, SOC=0.0, theta_batch=tb)
    t_switch = cc.t_final.numpy()
    assert len(np.unique(t_switch.round(3))) == 4
    assert cc.flag.tolist() == [2] * 4 and cv.flag.tolist() == [4] * 4
    np.testing.assert_allclose(cv.soc_final.numpy(), 1.0, atol=2e-3)
    one = ptt.batch_protocol(p, CCCV, SOC=0.0, theta_batch={"D_sn": tb["D_sn"][2:3]})
    np.testing.assert_allclose(one[1].t_final.numpy(), cv.t_final.numpy()[2:3], rtol=1e-9)


def test_batch_protocol_matches_jax(request):
    """`batch_protocol` of two cells (D_sn × 0.7 and 1.6) through the CC-CV
    charge equals the JAX package's `batch_protocol` cell by cell: exits,
    steps, t_final (1e-6) and y_final (1e-8 of 1 + |y|) of each segment."""
    tb = {"D_sn": 3.9e-14 * np.array([0.7, 1.6])}

    def jax_ref():
        out = jax_batch_protocol(pt.petlion(pt.LCO), CCCV, SOC=0.0, theta_batch=tb,
                                 max_save=4)
        return [{k: np.asarray(getattr(r, k)) for k in
                 ("flag", "t_final", "y_final", "n_steps", "n_rejected")} for r in out]

    want = shared(request, "batch_protocol_cccv", jax_ref)
    got = ptt.batch_protocol(ptt.petlion(ptt.LCO, device="cpu"), CCCV, SOC=0.0,
                             theta_batch=tb, max_save=4)
    assert len(got) == len(want) == 2
    for r, w in zip(got, want):
        assert r.flag.tolist() == w["flag"].tolist()
        assert r.n_steps.tolist() == w["n_steps"].tolist()
        assert r.n_rejected.tolist() == w["n_rejected"].tolist()
        np.testing.assert_allclose(r.t_final.numpy(), w["t_final"], rtol=1e-6)
        gap = np.max(np.abs(r.y_final.numpy() - w["y_final"]) / (1 + np.abs(w["y_final"])))
        assert gap < 1e-8, gap


def test_segments_and_unported_options():
    """`build_segments` reads each segment's mode (a given setpoint, a hold
    measured from the carry, rest; the dT hold is a given 0), its bounds and
    duration; unknown keys raise, and so do a `mesh=` that is not a
    ``make_cell_mesh`` mesh and a batch that does not divide over the mesh
    (`mesh=` itself is ported since); `fast_solver=False` (ported since)
    runs a segment on the dense route."""
    p = ptt.petlion(ptt.LCO, device="cpu", temperature=True)
    segs, values, tfs, bounds = build_segments(
        p, [dict(I=4, V_max=4.1, tf=60.0), dict(dT="hold"), dict(V="hold"),
            dict(I="rest", tf=10.0)])
    assert [s.value_mode for s in segs] == ["given", "given", "hold", "rest"]
    assert [s.spec.method for s in segs] == ["I", "res", "V", "I"]
    assert [s.is_temperature_hold for s in segs] == [False, True, False, False]
    assert [s.is_rest for s in segs] == [False, False, False, True]
    assert values == [4.0, 0.0, 0.0, 0.0] and tfs == [60.0, 1e6, 1e6, 10.0]
    assert bounds[0]["V_max"] == 4.1
    with pytest.raises(ValueError):
        Segment(spec=segs[0].spec, value_mode="later")
    with pytest.raises(TypeError, match="unknown"):
        build_segments(p, [dict(I=1, wobble=3)])
    with pytest.raises(TypeError, match="mesh"):
        ptt.batch_protocol(p, CCCV, n_cells=2, mesh=object())
    with pytest.raises(ValueError, match="do not divide"):
        ptt.batch_protocol(p, CCCV, n_cells=3, mesh=ptt.make_cell_mesh(devices=["cpu"] * 2))
    dense = ptt.simulate_protocol(p, [dict(I=-1, tf=5.0)], SOC=0.5, fast_solver=False)
    assert dense.exit_reasons() == ["Final time reached"]
    with pytest.raises(TypeError, match="unknown"):
        ptt.simulate_protocol(p, CCCV, wobble=1)


@pytest.mark.slow
def test_cc_ct_cv_protocol_float32():
    """The thermal CC-CT-CV protocol in float32 (abstol 5e-4, reltol 1e-3)
    through the refined pivoted LU (no Schur factorization): the three
    exits, t within 1% of the reference's 1865.61 s and I within 6% of
    0.1959C (tests/test_batch.py::test_protocol_thermal_f32's bands), the
    public Y_final's T in kelvin."""
    p = ptt.petlion(ptt.LCO, device="cpu", temperature=True, dtype=torch.float32)
    linsolve.LU_FACTORS[0] = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sol = ptt.simulate_protocol(p, CC_CT_CV, SOC=0.0, max_save=256, abstol=5e-4,
                                    reltol=1e-3)
    assert linsolve.LU_FACTORS[0] > 0
    assert sol.exit_reasons() == EXITS
    assert abs(sol.t[-1] - 1865.61) / 1865.61 < 0.01
    assert abs(sol.I[-1] - 0.1959) / 0.1959 < 0.06
    T = sol.Y_final[p.layout.sl("T")]
    assert np.all(T > 290.0) and np.all(T < 330.0)


@pytest.mark.slow
def test_cc_ct_cv_float32_matches_jax():
    """The float32 thermal CC-CT-CV (abstol 5e-4, reltol 1e-3) against the
    JAX package's float32 run on the CPU. Float32 rounding makes either
    package's run wander with its start: over starts SOC 0–8e-4 JAX's t_end
    spread 1859.5–1882.4 s and its CT segment took 38–188 steps (ROADMAP
    C.3), so the port runs four starts (SOC 0, 1e-4, 2e-4, 3e-4) and is held
    to JAX's run from SOC 0: the same exits; CC and CT ending within 0.5%
    of JAX's times; the median t_end within 1% of JAX's and of the
    reference's 1865.61 s; the median CC steps, CV steps and attempts in all
    (steps and rejections of the three segments) within a factor 1.5 of
    JAX's. A refinement residual summed by a BLAS gemv left the port's CV at
    4× JAX's steps and its attempts at 2.6×."""
    import jax.numpy as jnp
    from petlion_tpu.protocols import simulate_protocol as jax_simulate_protocol

    kw = dict(max_save=256, abstol=5e-4, reltol=1e-3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jax_simulate_protocol(pt.petlion(pt.LCO, temperature=True), CC_CT_CV, SOC=0.0,
                                  dtype=jnp.float32, **kw)
        p = ptt.petlion(ptt.LCO, device="cpu", temperature=True, dtype=torch.float32)
        runs = [ptt.simulate_protocol(p, CC_CT_CV, SOC=s, **kw) for s in (0.0, 1e-4, 2e-4, 3e-4)]

    def ends(sol):
        return [float(r.tspan[1]) for r in sol.results]

    def attempts(sol):
        return sum(r.n_steps + r.n_rejected for r in sol.results)

    assert j.exit_reasons() == EXITS
    for sol in runs:
        assert sol.exit_reasons() == EXITS
        np.testing.assert_allclose(ends(sol)[:2], ends(j)[:2], rtol=5e-3)
    t_med = float(np.median([float(sol.t[-1]) for sol in runs]))
    assert abs(t_med - float(j.t[-1])) / float(j.t[-1]) < 0.01
    assert abs(t_med - 1865.61) / 1865.61 < 0.01
    for got, want in ((np.median([sol.results[0].n_steps for sol in runs]), j.results[0].n_steps),
                      (np.median([sol.results[2].n_steps for sol in runs]), j.results[2].n_steps),
                      (np.median([attempts(sol) for sol in runs]), attempts(j))):
        assert want / 1.5 <= got <= 1.5 * want, (got, want)


@pytest.mark.slow
def test_thermal_batch_float32_in_chunks():
    """Three thermal cells in float32 through two 250 s chunks of a 1C
    discharge, the second from the first's states and SOC: every cell at
    tf in both chunks, the chunked run equal to one 500 s run to float32
    rounding (V within 2 mV), the pivoted LU route taken."""
    p = ptt.petlion(ptt.LCO, device="cpu", temperature=True, dtype=torch.float32)
    tb = {"D_sp": 1e-14 * np.array([0.95, 1.0, 1.05])}
    kw = dict(I=-1.0, theta_batch=tb, abstol=5e-4, reltol=1e-3, max_save=2)
    linsolve.LU_FACTORS[0] = 0
    a = ptt.batch_simulate(p, 250.0, SOC=1.0, **kw)
    b = ptt.batch_simulate(p, 250.0, SOC=a.soc_final.numpy(), y_start=a.y_final, **kw)
    assert linsolve.LU_FACTORS[0] > 0
    whole = ptt.batch_simulate(p, 500.0, SOC=1.0, **kw)
    assert a.flag.tolist() == b.flag.tolist() == whole.flag.tolist() == [0] * 3
    L = p.layout
    np.testing.assert_allclose(L.V(b.y_final).numpy(), L.V(whole.y_final).numpy(), atol=2e-3)

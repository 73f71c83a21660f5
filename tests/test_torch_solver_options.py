"""The solver options end to end on the CPU in float64: the port's golden
1C discharge with Jacobian reuse (`jac_reuse=6`) and with the "ida" step
control against the JAX package's `simulate` (each JAX program run once per
session through tests/torch_shared.py) and against the golden bounds of
the JAX package's own tests (tests/test_simulate.py:43,56); the dense
route (`fast_solver=False`) against the port's fast route, as the JAX
package's tests/test_batch.py:39 and tests/test_half_cell.py:74,172 hold
its own. Slow: a batch of three cells with reuse, and the float32 thermal
protocol with reuse, against the JAX package's runs."""

import numpy as np
import pytest
import torch

import petlion_tpu as pt
import petlion_tpu_torch as ptt
from torch_shared import shared

torch.set_num_threads(1)

GOLDEN_KW = dict(I=-1, SOC=1)
OPTIONS = {"jac_reuse": dict(jac_reuse=6), "ida": dict(step_control="ida")}


def _golden(sol):
    """The golden bounds of the JAX package's tests/test_simulate.py:43,56."""
    assert sol.final_exit_reason() == "Below min. SOC"
    assert abs(sol.t[-1] - 3600.0) < 1.0
    assert abs(sol.V[-1] - 2.9357) / 2.9357 < 0.01


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_golden_discharge_with_option_matches_jax(option, request):
    """The 1C discharge from SOC 1 with jac_reuse=6 (factor once per chunk,
    the stale matrix damped by cjratio) or step_control="ida": the port's
    run has the JAX package's exit, steps and rejections, t[-1] within 1e-10
    relative and V[-1] within 1e-11 (measured on the CPU: 2e-16 and
    3e-15 relative for reuse, 2e-15 and 5e-14 for ida), and meets the
    golden bounds of the JAX package's test of the option."""
    kw = OPTIONS[option]
    sj = shared(request, f"golden_{option}",
                lambda: pt.simulate(pt.petlion(pt.LCO), **GOLDEN_KW, **kw))
    st = ptt.simulate(ptt.petlion(ptt.LCO, device="cpu"), **GOLDEN_KW, **kw)
    _golden(st)
    rj, rt = sj.results[-1], st.results[-1]
    assert (rt.exit_reason, rt.n_steps, rt.n_rejected) == \
        (rj.exit_reason, rj.n_steps, rj.n_rejected)
    np.testing.assert_allclose(st.t[-1], sj.t[-1], rtol=1e-10)
    np.testing.assert_allclose(st.V[-1], sj.V[-1], rtol=1e-11)


@pytest.mark.parametrize("model, tf, tol", [
    (dict(), None, dict(V=1e-8, t=1e-10)),
    (dict(anode="Li_metal"), 600.0, dict(V=1e-8)),
    (dict(anode="Li_metal", temperature=True), 600.0, dict(V=1e-7, T=1e-8))],
    ids=["lco", "half_cell", "thermal_half_cell"])
def test_dense_route_matches_fast_route(model, tf, tol):
    """fast_solver=False (the dense Jacobian, one stacked pass over identity
    seeds, and the equilibrated pivoted LU; the initialization's algebraic
    block dense too) against the port's fast route, at the JAX package's
    tolerances for its own two routes: the LCO golden discharge (V rtol
    1e-8, t rtol 1e-10), 600 s of the half cell (V rtol 1e-8) and of the
    thermal half cell (V rtol 1e-7, T within 1e-8 K)."""
    p = ptt.petlion(ptt.LCO, device="cpu", **model)
    kw = dict(I=-1, SOC=1.0) if tf is None else dict(I=-1, SOC=1.0, tf=tf)
    fast = ptt.simulate(p, **kw)
    dense = ptt.simulate(p, fast_solver=False, **kw)
    assert dense.exit_reasons() == fast.exit_reasons()
    np.testing.assert_allclose(dense.V[-1], fast.V[-1], rtol=tol["V"])
    if "t" in tol:
        _golden(dense)
        np.testing.assert_allclose(dense.t[-1], fast.t[-1], rtol=tol["t"])
    if "T" in tol:
        s = p.layout.sl("T")
        np.testing.assert_allclose(dense.Y_final[s], fast.Y_final[s], rtol=0, atol=tol["T"])


@pytest.mark.slow
def test_batch_reuse_matches_jax():
    """batch_simulate(jac_reuse=6) of three cells (D_sp perturbed) over a
    full 1C discharge against the JAX package's: the same flags, steps and
    rejections, t_final within 1e-10 and the final V within 1e-9
    (relative)."""
    from petlion_tpu.parallel.batch import batch_simulate as jax_batch_simulate
    tb = {"D_sp": np.array([1e-14, 1.2e-14, 0.85e-14])}
    kw = dict(I=-1.0, SOC=1.0, theta_batch=tb, jac_reuse=6, outputs=("t", "V"),
              max_save=256)
    pj = pt.petlion(pt.LCO)
    rj = jax_batch_simulate(pj, 3.9e3, **kw)
    p = ptt.petlion(ptt.LCO, device="cpu")
    rt = ptt.batch_simulate(p, 3.9e3, **kw)
    for f in ("flag", "n_steps", "n_rejected"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)))
    np.testing.assert_allclose(rt.t_final.numpy(), np.asarray(rj.t_final), rtol=1e-10)
    V_j = [float(pj.layout.V(y)) for y in np.asarray(rj.y_final)]
    np.testing.assert_allclose(p.layout.V(rt.y_final).numpy(), V_j, rtol=1e-9)


@pytest.mark.slow
def test_thermal_float32_protocol_reuse_matches_jax():
    """The thermal CC-CT-CV of one cell in float32 (abstol 5e-4, reltol
    1e-3, the refined pivoted LU) with jac_reuse=6, the configuration the
    JAX package's options recommend reuse for, against the JAX package's
    run from SOC 0: the same exits; since float32 runs wander with their
    start in both packages (ROADMAP C.3), the port runs four starts (SOC 0
    to 3e-4) and their median total time lies within 1.5% of JAX's and of
    the reference's 1865.61 s, with the median attempts within a factor 1.5
    of JAX's."""
    import warnings

    import jax.numpy as jnp
    from petlion_tpu.protocols import simulate_protocol as jax_simulate_protocol
    segs = [dict(I=4, V_max=4.1, T_max=313.15), dict(dT="hold", V_max=4.1),
            dict(V="hold")]
    exits = ["Above max. temperature", "Above max. voltage", "Above max. SOC"]
    kw = dict(max_save=256, abstol=5e-4, reltol=1e-3, jac_reuse=6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jax_simulate_protocol(pt.petlion(pt.LCO, temperature=True), segs, SOC=0.0,
                                  dtype=jnp.float32, **kw)
        p = ptt.petlion(ptt.LCO, device="cpu", temperature=True, dtype=torch.float32)
        runs = [ptt.simulate_protocol(p, segs, SOC=s, **kw) for s in (0.0, 1e-4, 2e-4, 3e-4)]

    def attempts(sol):
        return sum(r.n_steps + r.n_rejected for r in sol.results)

    assert j.exit_reasons() == exits
    assert all(sol.exit_reasons() == exits for sol in runs)
    t_med = float(np.median([float(sol.t[-1]) for sol in runs]))
    assert abs(t_med - float(j.t[-1])) / float(j.t[-1]) < 0.015
    assert abs(t_med - 1865.61) / 1865.61 < 0.015
    att = float(np.median([attempts(sol) for sol in runs]))
    assert attempts(j) / 1.5 <= att <= 1.5 * attempts(j), (att, attempts(j))

"""End-to-end runs of the physics variants against the JAX package, float64
on the CPU: NMC with SEI aging (one cell charging, so the side reaction and
the film-growth stop run, one discharging) and the lithium-foil half cell,
each 600 s at 1C through both packages' `batch_simulate` at B = 2. Each test
compiles one JAX program (about a minute on the CPU); the SEI cycling chain
of the JAX suite's configuration 4 against JAX is slow."""

import pathlib

import numpy as np
import pytest
import torch

import jax
import petlion_tpu as pt
import petlion_tpu_torch as ptt
from petlion_tpu.parallel.batch import batch_simulate as jax_batch

torch.set_num_threads(1)


def _both(chem, kw, **run):
    """The same 600 s batch in both packages: (JAX result as numpy, port
    result)."""
    pj = pt.petlion(getattr(pt, chem), **kw)
    p = ptt.petlion(getattr(ptt, chem), device="cpu", dtype=torch.float64, **kw)
    run["theta_batch"] = {"D_sp": np.array([1.0, 1.05]) * float(pj.theta["D_sp"])}
    want = jax.tree_util.tree_map(np.asarray, jax_batch(pj, 600.0, **run))
    return want, ptt.batch_simulate(p, 600.0, **run), p


def _same_run(want, got, states=()):
    """Equal flags and counts; t and V within rtol 1e-8; each state in
    `states` within 1e-8 of its largest magnitude."""
    for k in ("flag", "n_steps", "n_rejected", "n_saved"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(want, k), err_msg=k)
    for k in ("t", "V"):
        np.testing.assert_allclose(got.bufs[k].numpy(), want.bufs[k], rtol=1e-8, atol=0,
                                   err_msg=k)
    for k in states:
        scale = np.abs(want.bufs[k]).max()
        assert scale > 0, k
        assert np.abs(got.bufs[k].numpy() - want.bufs[k]).max() <= 1e-8 * scale, k
    np.testing.assert_allclose(got.t_final.numpy(), want.t_final, rtol=1e-8, atol=0)


def test_nmc_sei_batch_matches_jax():
    """NMC + SEI, cell 0 charging at 1C from SOC 0.3 until its film grows
    faster than dfilm_max (flag 10, localized on the dense output), cell 1
    discharging from SOC 0.8 to tf: the JAX run's flags, counts, t, V, SOH,
    film and j_s."""
    want, got, p = _both("NMC", dict(aging="SEI"), SOC=np.array([0.3, 0.8]),
                         value_batch=np.array([1.0, -1.0]), I=1.0, dfilm_max=1.2e-15,
                         outputs=("t", "V", "SOH", "film", "j_s"))
    assert got.flag.tolist() == [10, 0]
    _same_run(want, got, states=("SOH", "film", "j_s"))
    dfilm = got.yp_final[0, p.layout.sl("film")].max()
    assert float(dfilm) == pytest.approx(1.2e-15, rel=1e-6)
    soh = got.bufs["SOH"][0, :int(got.n_saved[0]), 0].numpy()
    assert soh[-1] < 1.0 and np.all(np.diff(soh) <= 0)


def test_half_cell_batch_matches_jax():
    """The lithium-foil half cell (LCO cathode), 1C discharge from SOC 1 and
    0.6: the JAX run's flags, counts, t and V."""
    want, got, _ = _both("LCO", dict(anode="Li_metal"), SOC=np.array([1.0, 0.6]),
                         I=-1.0, outputs=("t", "V"))
    _same_run(want, got)


@pytest.mark.slow
def test_sei_cycling_matches_jax():
    """The JAX suite's configuration 4 in float64: a charge at 1C from SOC
    0.3 to SOC 0.9, then three times a discharge to SOC 0.3 and a charge
    back, through `simulate`/`simulate_cont` in both packages: the same
    seven exits and step counts, t, V and SOH within 1e-8."""
    kw = dict(outputs=("t", "V", "SOH"), abstol=5e-4, reltol=1e-3)
    sols = []
    for pkg in (pt, ptt):
        p = (pkg.petlion(pkg.NMC, aging="SEI") if pkg is pt
             else pkg.petlion(pkg.NMC, aging="SEI", device="cpu"))
        s = pkg.simulate(p, I=1, SOC=0.3, SOC_max=0.9, V_max=4.25, **kw)
        for _ in range(3):
            s = pkg.simulate_cont(s, p, I=-1, SOC_min=0.3, V_min=2.8)
            s = pkg.simulate_cont(s, p, I=1, SOC_max=0.9, V_max=4.25)
        sols.append(s)
    sj, st = sols
    assert st.exit_reasons() == sj.exit_reasons()
    assert len(st.exit_reasons()) == 7
    assert [r.n_steps for r in st.results] == [r.n_steps for r in sj.results]
    for k in ("t", "V", "SOH"):
        np.testing.assert_allclose(np.asarray(st.arrays[k]), np.asarray(sj.arrays[k]),
                                   rtol=1e-8, atol=0, err_msg=k)


def test_path7_is_the_suite_configuration():
    """Path 7 is bench_suite.py's 4b_sei_discharge_batched at its published
    width — 256 NMC cells with SEI aging, the suite's float32 tolerances,
    maxiters 500, D_sp/D_sn/k_p/k_n perturbed ±5% per cell (cell 0 kept at
    the published values) — and its cycling chain the suite's 4_sei_cycling
    tolerances; the 92-state core is what K1 sees."""
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops.plan import get_plan
    src = (pathlib.Path(mp.__file__).resolve().parents[1] / "bench_suite.py").read_text()
    assert "Bs = 256" in src and 'pt.petlion(pt.NMC, aging="SEI")' in src
    assert mp.SEI_B == 256 and mp.SEI_CYCLE_TOL == dict(abstol=5e-4, reltol=1e-3)
    p = mp.sei_model(device="cpu")
    assert p.dtype == torch.float32 and p.numerics.aging == "SEI"
    assert p.numerics.cathode == "NMC" and p.layout.N_tot == 322
    o = p.opts
    assert (o.abstol, o.reltol, o.maxiters) == (5e-4, 1e-3, 500)
    assert o.outputs == ("t", "V", "SOH")
    tb = mp.sei_theta_batch(p, seed=3)
    for k in ("D_sp", "D_sn", "k_p", "k_n"):
        v = float(p.theta[k])
        assert tb[k].shape == (256,) and tb[k][0] == v
        assert 0.8 * v < tb[k].min() and tb[k].max() < 1.2 * v
    np.testing.assert_array_equal(mp.sei_theta_batch(p, seed=3)["k_n"], tb["k_n"])
    plan = get_plan(p.cfg, p.theta_floats())
    assert len(plan.split.i_core) == 92

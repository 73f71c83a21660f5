"""The port's single-cell API and per-cell stop times on the card against
the same runs on the CPU. They skip where torch.cuda.is_available() is
False. This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_simulate.py
"""

import numpy as np
import pytest
import torch

import petlion_tpu_torch as ptt
from petlion_tpu_torch.ops import gj_kernel as gk

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

THETA = {"D_sp": np.array([1e-14, 1.04e-14, 0.97e-14])}
TSTOPS = np.array([[80.0, 412.5], [150.25, 300.0], [33.3, 577.0]])


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def test_simulate_on_card_matches_cpu():
    """A 600 s 1C discharge then a rest, float64: the card's run (K1 for the
    71x71 core) equals the CPU's to 1e-9 on t, V and Y_final."""
    _need_card()
    sols = {}
    for dev in ("cpu", "cuda"):
        p = ptt.petlion(ptt.LCO, device=dev, dtype=torch.float64)
        before = gk.LAUNCHES["gj_inverse"]
        sol = ptt.simulate(p, 600.0, I=-1, SOC=1, outputs=("t", "V", "Y", "YP"))
        sol = ptt.simulate_cont(sol, p, 300.0, I="rest")
        if dev == "cuda":
            assert gk.LAUNCHES["gj_inverse"] > before
        sols[dev] = sol
    c, g = sols["cpu"], sols["cuda"]
    assert g.exit_reasons() == c.exit_reasons() == ["Final time reached"] * 2
    assert [r.n_steps for r in g.results] == [r.n_steps for r in c.results]
    for k in ("t", "V"):
        np.testing.assert_allclose(g.arrays[k], c.arrays[k], rtol=1e-9, atol=1e-9)
    assert np.max(np.abs(g.Y_final - c.Y_final) / (1 + np.abs(c.Y_final))) < 1e-9


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_per_cell_tstops_on_card_match_cpu(dtype):
    """Per-cell stop times and a shared discontinuity at B = 3: in float64
    the card's run equals the CPU's (flags, step counts, t within rtol
    1e-7); in float32 every cell ends at tf and lands on each of its stops
    within two float32 ulps. (A stop a fraction of a second past a step
    makes that step t_stop − t, a difference of close numbers, which
    magnifies the rounding of t by t / (t_stop − t), here up to ~1e3.)"""
    _need_card()
    kw = dict(theta_batch=THETA, tstops=TSTOPS, tdiscon=[200.0], I=-1.0, SOC=1.0,
              outputs=("t", "V"), max_save=64)
    if dtype == torch.float32:
        kw["abstol"] = 1e-3
    res = {dev: ptt.batch_simulate(ptt.petlion(ptt.LCO, device=dev, dtype=dtype),
                                   600.0, **kw) for dev in ("cpu", "cuda")}
    g = res["cuda"]
    assert (g.flag.cpu().numpy() == 0).all()
    reltol = ptt.SimOptions().reltol
    stops = np.concatenate([TSTOPS, np.full((3, 1), 200.0 - reltol / 2)], axis=1)
    t, n = g.bufs["t"].cpu().numpy(), g.n_saved.cpu().numpy()
    for b in range(3):
        for s in stops[b].astype(np.float32 if dtype == torch.float32 else np.float64):
            tol = 2 * np.spacing(s) if dtype == torch.float32 else 1e-6
            assert np.min(np.abs(t[b, :n[b]] - s)) <= tol
    if dtype == torch.float64:
        c = res["cpu"]
        for k in ("flag", "n_steps", "n_rejected", "n_saved"):
            np.testing.assert_array_equal(getattr(g, k).cpu().numpy(), getattr(c, k).numpy())
        np.testing.assert_allclose(t, c.bufs["t"].numpy(), rtol=1e-7, atol=0)


def test_cc_cv_on_card_matches_cpu():
    """Path 6's CC→CV pair (2C from SOC 0 to 4.1 V, then V = "hold" to
    I_min 0.05C or SOC_max), float64: the card's runs (K1 for every 71x71
    core) equal the CPU's to 1e-9 on t, V and Y_final, with the same exits
    and step counts."""
    _need_card()
    from petlion_tpu_torch import main_path as mp
    sols = {}
    for dev in ("cpu", "cuda"):
        p = ptt.petlion(ptt.LCO, device=dev, dtype=torch.float64)
        before = gk.LAUNCHES["gj_inverse"]
        sols[dev] = mp.run_cccv(p)[0]
        if dev == "cuda":
            assert gk.LAUNCHES["gj_inverse"] > before
    c, g = sols["cpu"], sols["cuda"]
    assert g.exit_reasons() == c.exit_reasons()
    assert g.exit_reasons()[0] == "Above max. voltage"
    assert [r.n_steps for r in g.results] == [r.n_steps for r in c.results]
    for k in ("t", "V"):
        np.testing.assert_allclose(g.arrays[k], c.arrays[k], rtol=1e-9, atol=1e-9)
    assert np.max(np.abs(g.Y_final - c.Y_final) / (1 + np.abs(c.Y_final))) < 1e-9


def test_gitt_on_card_matches_cpu():
    """Path 5's pulse at B = 3 in float64 (three pulse ends from the path's
    seed, each cell re-initialized at its own): the card's run equals the
    CPU's (flags, step counts, the re-initialization trips; t, V and
    Y_final within 1e-9)."""
    _need_card()
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.solver import run as runner
    res, reinit = {}, {}
    for dev in ("cpu", "cuda"):
        p = ptt.petlion(ptt.LCO, device=dev, dtype=torch.float64)
        p.opts = p.opts.replace(**mp.BENCH_OPTS)
        runner.reset_trip_counts()
        res[dev] = mp.run_gitt(p, seed=0, n_cells=3)[0]
        reinit[dev] = runner.TRIPS["reinit"]
    c, g = res["cpu"], res["cuda"]
    assert reinit["cuda"] == reinit["cpu"] > 0
    assert (g.flag.cpu().numpy() == 0).all()
    for k in ("flag", "n_steps", "n_rejected", "n_saved"):
        np.testing.assert_array_equal(getattr(g, k).cpu().numpy(), getattr(c, k).numpy())
    for k in ("t", "V"):
        np.testing.assert_allclose(g.bufs[k].cpu().numpy(), c.bufs[k].numpy(),
                                   rtol=1e-9, atol=1e-9)
    yc = c.y_final.numpy()
    assert np.max(np.abs(g.y_final.cpu().numpy() - yc) / (1 + np.abs(yc))) < 1e-9


@pytest.mark.parametrize("chem, kw, I, soc, core", [
    ("NMC", dict(aging="SEI"), 1.0, 0.3, 92),
    ("LCO", dict(anode="Li_metal"), -1.0, 1.0, 41)], ids=["nmc_sei_charge", "half_cell"])
def test_variant_on_card_matches_cpu(chem, kw, I, soc, core):
    """NMC with SEI aging (charging, so the side reaction runs) and the
    lithium-foil half cell, 600 s at 1C in float64 at B = 2: the card's run
    (K1 at the 92- and 41-state cores) equals the CPU's to 1e-9 on t, V,
    SOH and the final state, with the same flags and step counts."""
    _need_card()
    outs = ("t", "V", "SOH") if "aging" in kw else ("t", "V")
    runs = {}
    for dev in ("cpu", "cuda"):
        p = ptt.petlion(getattr(ptt, chem), device=dev, dtype=torch.float64, **kw)
        gk.reset_launch_counts()
        runs[dev] = ptt.batch_simulate(p, 600.0, I=I, SOC=soc, outputs=outs,
                                       theta_batch={"D_sp": np.array([1.0, 1.04])
                                                    * float(p.theta["D_sp"])})
        if dev == "cuda":
            assert gk.LAUNCHES_BY_N["gj_inverse"].get(core, 0) > 0
    c, g = runs["cpu"], runs["cuda"]
    assert g.flag.tolist() == c.flag.tolist()
    assert g.n_steps.tolist() == c.n_steps.tolist()
    for k in outs:
        np.testing.assert_allclose(g.bufs[k].cpu().numpy(), c.bufs[k].numpy(),
                                   rtol=1e-9, atol=1e-9 * float(c.bufs[k].abs().max()))
    yg, yc = g.y_final.cpu().numpy(), c.y_final.numpy()
    assert np.max(np.abs(yg - yc) / (1 + np.abs(yc))) < 1e-9


@pytest.mark.parametrize("chem", ["LCO", "NMC_LGM50"])
def test_thermal_on_card_matches_cpu(chem):
    """A thermal cell (float64; LCO with temperature=True at 4C, and
    NMC_LGM50 at its default at 1C) charged for 60 s, then its mean
    temperature held for 30 s: the card's runs (K1 at the 121-state core)
    take the CPU's steps and equal its V (relative) and Y_final (kelvin, of
    1 + |Y|) to 1e-7. The dT-hold matrix (cond near 1e16) turns any other
    order of the arithmetic into a gap in V: on the CPU the two routes' plain
    versions (two elimination orders) part by 3.2e-9 of V for LCO and
    1.24e-7 for NMC_LGM50, and the card lay 1.05e-8 of V from the CPU for
    LCO, so LCO's V is held to 3e-8. chip_smoke.py's path 9 holds the
    golden flow's card = CPU to 1e-9 V."""
    _need_card()
    sols = {}
    for dev in ("cpu", "cuda"):
        kw = dict(temperature=True) if chem == "LCO" else {}
        p = ptt.petlion(getattr(ptt, chem), device=dev, dtype=torch.float64, **kw)
        gk.reset_launch_counts()
        sol = ptt.simulate(p, 60.0, I=4 if chem == "LCO" else 1, SOC=0.2)
        sol = ptt.simulate_cont(sol, p, 30.0, dT="hold")
        if dev == "cuda":
            assert gk.LAUNCHES_BY_N["gj_inverse"].get(121, 0) > 0
        sols[dev] = sol
    c, g = sols["cpu"], sols["cuda"]
    assert g.exit_reasons() == c.exit_reasons() == ["Final time reached"] * 2
    assert [r.n_steps for r in g.results] == [r.n_steps for r in c.results]
    np.testing.assert_allclose(g.V, c.V, rtol=3e-8 if chem == "LCO" else 1e-7)
    assert np.max(np.abs(g.Y_final - c.Y_final) / (1 + np.abs(c.Y_final))) < 1e-7


def test_thermal_float32_takes_the_lu_route_on_card():
    """Two thermal cells in float32 on the card, 60 s at 1C: the Newton
    matrices go through the pivoted LU (no K1 launch at the 121-state
    core), every cell reaches tf, V within 2 mV of the float64 CPU run."""
    _need_card()
    from petlion_tpu_torch.solver import linsolve
    kw = dict(I=-1.0, SOC=1.0, theta_batch={"D_sp": np.array([1e-14, 1.05e-14])},
              abstol=5e-4, reltol=1e-3)
    p = ptt.petlion(ptt.LCO, device="cuda", dtype=torch.float32, temperature=True)
    gk.reset_launch_counts()
    linsolve.LU_FACTORS[0] = 0
    r = ptt.batch_simulate(p, 60.0, **kw)
    assert linsolve.LU_FACTORS[0] > 0
    assert gk.LAUNCHES_BY_N["gj_inverse"].get(121, 0) == 0
    ref = ptt.batch_simulate(ptt.petlion(ptt.LCO, device="cpu", temperature=True), 60.0, **kw)
    assert r.flag.tolist() == ref.flag.tolist() == [0, 0]
    L = p.layout
    np.testing.assert_allclose(L.V(r.y_final).double().cpu().numpy(),
                               L.V(ref.y_final).numpy(), atol=2e-3)


def test_batch_protocol_on_card_matches_cpu():
    """The CC-CV protocol of three cells (float64): the card's per-segment
    results equal the CPU's (flags, steps, t_final and y_final to 1e-9)."""
    _need_card()
    segs = [dict(I=2, V_max=4.1, SOC_max=1.0), dict(V="hold", SOC_max=1.0)]
    tb = {"D_sn": 3.9e-14 * np.array([0.6, 1.0, 1.7])}
    out = {}
    for dev in ("cpu", "cuda"):
        p = ptt.petlion(ptt.LCO, device=dev, dtype=torch.float64)
        out[dev] = ptt.batch_protocol(p, segs, SOC=0.0, theta_batch=tb, max_save=4)
    for c, g in zip(out["cpu"], out["cuda"]):
        assert g.flag.tolist() == c.flag.tolist()
        assert g.n_steps.tolist() == c.n_steps.tolist()
        np.testing.assert_allclose(g.t_final.cpu().numpy(), c.t_final.numpy(), rtol=1e-9)
        y_g, y_c = g.y_final.cpu().numpy(), c.y_final.numpy()
        assert np.max(np.abs(y_g - y_c) / (1 + np.abs(y_c))) < 1e-9


def _solver_option_run(dev, case):
    """One float64 run of `case` on `dev` with the launch counts set to 0
    first: a RunResultDev of three cells (600 s of path 1's discharge)."""
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops.plan import FULL_KERNEL_ROUTE
    from petlion_tpu_torch.ops.structured import make_schur_solver
    p = ptt.petlion(ptt.LCO, device=dev, dtype=torch.float64)
    gk.reset_launch_counts()
    kw = dict(I=-1.0, SOC=1.0, outputs=("t", "V"), theta_batch=THETA)
    if case == "reuse":
        return ptt.batch_simulate(p, 600.0, jac_reuse=6, **kw)
    if case == "reuse_full_kernel":
        return ptt.batch_simulate(p, 600.0, jac_reuse=6, route=FULL_KERNEL_ROUTE, **kw)
    if case == "dense":
        return ptt.batch_simulate(p, 600.0, fast_solver=False, **kw)
    # the particle-Schur route through run_once, path 13(c)'s entry
    return mp.run_solver(p, 0, n_cells=3, linear_solver=make_schur_solver(p.layout))[0]


@pytest.mark.parametrize("case, needs", [
    ("reuse", {"gj_inverse": 71}),
    ("reuse_full_kernel", {"gj_blocks": None, "dchain": None}),
    ("dense", {"gj_inverse": 71}),
    ("schur", {"gj_inverse": 101})])
def test_solver_option_on_card_matches_cpu(case, needs):
    """The solver options at B = 3 in float64 on the card against the same
    run on the CPU: jac_reuse=6 on the default route (K1 at the 71-state
    core) and on the full-kernel route (K2 and K3), fast_solver=False (the
    dense Jacobian and LU; K1 at the initialization's 71-state block), and
    run_once(linear_solver=make_schur_solver(layout)) over path 1's full
    discharge of its first three cells (K1 at the 101-state core): the same
    flags and step counts, t and V within 1e-9."""
    _need_card()
    runs = {}
    for dev in ("cpu", "cuda"):
        runs[dev] = _solver_option_run(dev, case)
    for k, n in needs.items():
        assert gk.LAUNCHES[k] > 0, k
        if n is not None:
            assert gk.LAUNCHES_BY_N[k].get(n, 0) > 0, (k, n)
    c, g = runs["cpu"], runs["cuda"]
    assert g.flag.tolist() == c.flag.tolist()
    assert g.n_steps.tolist() == c.n_steps.tolist()
    assert g.n_rejected.tolist() == c.n_rejected.tolist()
    for k in ("t", "V"):
        np.testing.assert_allclose(g.bufs[k].cpu().numpy(), c.bufs[k].numpy(),
                                   rtol=1e-9, atol=1e-9)

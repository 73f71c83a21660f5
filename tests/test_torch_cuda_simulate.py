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

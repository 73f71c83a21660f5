"""The port's main path end to end on the CPU in float64: the batched LCO 1C
discharge against the golden exit, the stored oracle trace, a single-cell
run of the same cell, and (slow) the JAX package's batch_simulate."""

import os

import numpy as np
import pytest
import torch

import petlion_tpu_torch as ptt

torch.set_num_threads(1)

ORACLE = os.path.join(os.path.dirname(__file__), "data", "oracle_lco_1c.npz")
CELL1 = {"D_sp": 1.05e-14, "k_n": 4.8e-11}


@pytest.fixture(scope="module")
def runs():
    p = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    kw = dict(I=-1.0, SOC=1.0, outputs=("t", "V"), max_save=256)
    tb = {k: np.array([p.theta_floats()[k], v]) for k, v in CELL1.items()}
    both = ptt.batch_simulate(p, 3.9e3, theta_batch=tb, **kw)
    single = ptt.batch_simulate(
        p, 3.9e3, theta_batch={k: np.array([v]) for k, v in CELL1.items()}, **kw)
    return p, both, single


def test_golden_exit_and_oracle_trace(runs):
    """Cell 0 (published parameters) exits "Below min. SOC" at 3600 s with
    V ≈ 2.9404 V, and its saved V(t) tracks the float64 oracle within 2 mV
    up to 3500 s."""
    p, res, _ = runs
    assert ptt.EXIT_REASONS[int(res.flag[0])] == "Below min. SOC"
    assert abs(float(res.t_final[0]) - 3600.0) < 1.0
    assert abs(float(p.layout.V(res.y_final[0])) - 2.9404) < 2e-3
    assert bool(res.init_converged.all()) and not bool(res.truncated.any())
    oracle = np.load(ORACLE)
    n = int(res.n_saved[0])
    t = res.bufs["t"][0, :n].numpy()
    V = res.bufs["V"][0, :n].numpy()
    keep = (t >= oracle["t"][0]) & (t <= 3500.0)
    assert keep.sum() > 20
    ref = np.interp(t[keep], oracle["t"], oracle["V"])
    assert np.abs(V[keep] - ref).max() < 2e-3


def test_batched_cell_equals_single_run(runs):
    _, both, single = runs
    assert int(both.flag[1]) == int(single.flag[0]) == 3
    assert int(both.n_steps[1]) == int(single.n_steps[0])
    assert int(both.n_rejected[1]) == int(single.n_rejected[0])
    for a, b in ((both.t_final[1], single.t_final[0]),
                 (both.y_final[1], single.y_final[0]),
                 (both.bufs["V"][1], single.bufs["V"][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=0)


@pytest.mark.slow
def test_matches_jax_batch_simulate(monkeypatch):
    """Three per-cell-perturbed cells against the JAX package's colored-
    Jacobian batch_simulate: flags, exit times and voltages at 1e-8, equal
    step counts."""
    import petlion_tpu as pt
    from petlion_tpu.ops import plan as jax_plan
    from petlion_tpu.parallel.batch import batch_simulate as jax_batch

    monkeypatch.setenv("PETLION_JACA", "0")
    monkeypatch.setattr(jax_plan, "_PLAN_CACHE", {})
    rng = np.random.default_rng(3)
    base = {"D_sp": 1e-14, "D_sn": 3.9e-14, "k_p": 2.334e-11, "k_n": 5.031e-11}
    tb = {k: v * (1 + 0.05 * rng.standard_normal(3)) for k, v in base.items()}
    kw = dict(I=-1.0, SOC=1.0, outputs=("t", "V"), max_save=16)
    ref = jax_batch(pt.petlion(pt.LCO), 3.9e3, theta_batch=tb, **kw)
    p = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    got = ptt.batch_simulate(p, 3.9e3, theta_batch=tb, **kw)
    np.testing.assert_array_equal(got.flag.numpy(), np.asarray(ref.flag))
    np.testing.assert_array_equal(got.n_steps.numpy(), np.asarray(ref.n_steps))
    np.testing.assert_array_equal(got.n_rejected.numpy(),
                                  np.asarray(ref.n_rejected))
    np.testing.assert_allclose(got.t_final.numpy(), np.asarray(ref.t_final),
                               rtol=1e-8)
    V_ref = np.asarray(ref.y_final)[:, 280] - np.asarray(ref.y_final)[:, 299]
    np.testing.assert_allclose(p.layout.V(got.y_final).numpy(), V_ref, rtol=1e-8)


@pytest.mark.slow
def test_full_kernel_route_matches_jax_batch_simulate(monkeypatch):
    """Three per-cell-perturbed cells on the port's full-kernel route (nested
    levels, K2/K3's plain versions on the CPU, analytic assembly) against the
    JAX package's batch_simulate with PETLION_NESTED=1 (its analytic, nested
    XLA route off the TPU): flags and step counts equal, exit times and
    voltages at 1e-8."""
    import petlion_tpu as pt
    from petlion_tpu.ops import plan as jax_plan
    from petlion_tpu.parallel.batch import batch_simulate as jax_batch
    from petlion_tpu_torch.ops.plan import FULL_KERNEL_ROUTE

    monkeypatch.setenv("PETLION_NESTED", "1")
    monkeypatch.setattr(jax_plan, "_PLAN_CACHE", {})
    rng = np.random.default_rng(4)
    base = {"D_sp": 1e-14, "D_sn": 3.9e-14, "k_p": 2.334e-11, "k_n": 5.031e-11}
    tb = {k: v * (1 + 0.05 * rng.standard_normal(3)) for k, v in base.items()}
    kw = dict(I=-1.0, SOC=1.0, outputs=("t", "V"), max_save=16)
    ref = jax_batch(pt.petlion(pt.LCO), 3.9e3, theta_batch=tb, **kw)
    p = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    got = ptt.batch_simulate(p, 3.9e3, theta_batch=tb, route=FULL_KERNEL_ROUTE,
                             **kw)
    np.testing.assert_array_equal(got.flag.numpy(), np.asarray(ref.flag))
    np.testing.assert_array_equal(got.n_steps.numpy(), np.asarray(ref.n_steps))
    np.testing.assert_array_equal(got.n_rejected.numpy(),
                                  np.asarray(ref.n_rejected))
    np.testing.assert_allclose(got.t_final.numpy(), np.asarray(ref.t_final),
                               rtol=1e-8)
    V_ref = np.asarray(ref.y_final)[:, 280] - np.asarray(ref.y_final)[:, 299]
    np.testing.assert_allclose(p.layout.V(got.y_final).numpy(), V_ref, rtol=1e-8)

"""Explicit stop times (`tstops`) and known input discontinuities
(`tdiscon`) in the port's `batch_simulate` and `simulate`, against the JAX
package's `batch_simulate` at B = 3 on 600 s 1C runs; and the model options
carried across by `model_from_numpy`."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import petlion_tpu as pt
import petlion_tpu_torch as ptt
from petlion_tpu.parallel.batch import batch_simulate as jax_batch
from torch_shared import shared

torch.set_num_threads(1)

_rng = np.random.default_rng(5)
TSTOPS = np.sort(_rng.uniform(50.0, 550.0, (3, 2)), axis=1)     # per cell
THETA = {"D_sp": 1e-14 * (1 + 0.05 * _rng.standard_normal(3))}
TDISCON = [300.0]                                               # shared
KW = dict(I=-1.0, SOC=1.0, outputs=("t", "V"), max_save=64)


def _stops(reltol):
    """Each cell's stop times, the discontinuity's placed reltol/2 before it."""
    return np.concatenate([TSTOPS, np.full((3, 1), TDISCON[0] - reltol / 2)], axis=1)


def _landed(t, n_saved, stops):
    """Per cell and stop: the recorded time nearest the stop."""
    return np.array([[t[b, :n_saved[b]][np.argmin(np.abs(t[b, :n_saved[b]] - s))]
                      for s in stops[b]] for b in range(len(stops))])


@pytest.fixture(scope="module")
def jax64(request):
    """The JAX batch with per-cell stops, computed once per session (see
    torch_shared.py)."""
    return shared(request, "tstops_jax64", lambda: jax.tree_util.tree_map(
        np.asarray, jax_batch(pt.petlion(pt.LCO), 600.0, theta_batch=THETA,
                              tstops=TSTOPS, tdiscon=TDISCON, **KW)))


def test_model_from_numpy_keeps_opts():
    """A model carried across keeps its options: batch_simulate without SOC=
    starts from p.opts.SOC, as the JAX package's does. With the options
    dropped for SimOptions() (as model_from_numpy did), the run starts at
    SOC 1 instead of 0.5: V(t = 0) 0.347 V higher."""
    pj = pt.petlion(pt.LCO, SOC=0.5)
    args = ({k: np.float64(v) for k, v in pj.theta.items()}, pj.bounds, pj.N,
            pj.numerics)
    m = ptt.model_from_numpy(*args, opts=pj.opts, device="cpu", dtype=torch.float64)
    for f in dataclasses.fields(pj.opts):
        assert getattr(m.opts, f.name) == getattr(pj.opts, f.name), f.name
    kw = dict(n_cells=1, I=-1.0, outputs=("t", "V", "SOC"), max_save=8)
    got = ptt.batch_simulate(m, 60.0, **kw)
    want = ptt.batch_simulate(ptt.petlion(ptt.LCO, device="cpu"), 60.0, SOC=0.5, **kw)
    assert float(got.bufs["SOC"][0, 0]) == pj.opts.SOC == 0.5
    np.testing.assert_array_equal(got.bufs["V"].numpy(), want.bufs["V"].numpy())
    dropped = ptt.batch_simulate(
        ptt.model_from_numpy(*args, device="cpu", dtype=torch.float64), 60.0, **kw)
    assert float(dropped.bufs["SOC"][0, 0]) == 1.0
    gap = float(dropped.bufs["V"][0, 0] - got.bufs["V"][0, 0])
    assert gap == pytest.approx(0.3474, abs=1e-3)


def test_per_cell_tstops_and_tdiscon_match_jax(jax64):
    """Per-cell (3, 2) tstops plus a shared tdiscon, float64: the same
    flags, step counts and saved points as the JAX package (t and V within
    rtol 1e-8), and every cell's stops land on a recorded time."""
    p = ptt.petlion(ptt.LCO, device="cpu")
    got = ptt.batch_simulate(p, 600.0, theta_batch=THETA, tstops=TSTOPS,
                             tdiscon=TDISCON, **KW)
    for k in ("flag", "n_steps", "n_rejected", "n_saved"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(jax64, k), err_msg=k)
    for k in ("t", "V"):
        np.testing.assert_allclose(got.bufs[k].numpy(), jax64.bufs[k], rtol=1e-8, atol=0)
    stops = _stops(p.opts.reltol)
    landed = _landed(got.bufs["t"].numpy(), got.n_saved.numpy(), stops)
    assert np.abs(landed - stops).max() < 1e-6


def test_single_cell_tstops_match_jax(jax64):
    """`simulate` of each cell with its own stops and the discontinuity
    records the JAX batch's times for that cell (rtol 1e-8), in as many
    steps."""
    p = ptt.petlion(ptt.LCO, device="cpu")
    for b in range(3):
        p.theta["D_sp"] = torch.tensor(THETA["D_sp"][b], dtype=torch.float64)
        sol = ptt.simulate(p, 600.0, tstops=list(TSTOPS[b]), tdiscon=TDISCON, **KW)
        n = int(jax64.n_saved[b])
        np.testing.assert_allclose(sol.t, jax64.bufs["t"][b, :n], rtol=1e-8, atol=0)
        np.testing.assert_allclose(sol.V, jax64.bufs["V"][b, :n], rtol=1e-8, atol=0)
        assert sol.results[0].n_steps == int(jax64.n_steps[b])
        for s in list(TSTOPS[b]) + [TDISCON[0] - p.opts.reltol / 2]:
            assert np.min(np.abs(sol.t - s)) < 1e-6


def test_shared_tstops_equal_per_cell_rows():
    """A shared (K,) list is every cell's row; stops past tf or padded with
    inf change nothing; malformed shapes raise."""
    p = ptt.petlion(ptt.LCO, device="cpu")
    shared = [123.456, 250.0]
    a = ptt.batch_simulate(p, 600.0, theta_batch=THETA, tstops=shared, **KW)
    b = ptt.batch_simulate(p, 600.0, theta_batch=THETA,
                           tstops=np.array([shared + [np.inf, 900.0]] * 3), **KW)
    for k in ("flag", "n_steps", "n_rejected", "n_saved"):
        np.testing.assert_array_equal(getattr(a, k).numpy(), getattr(b, k).numpy())
    np.testing.assert_array_equal(a.bufs["t"].numpy(), b.bufs["t"].numpy())
    landed = _landed(a.bufs["t"].numpy(), a.n_saved.numpy(), np.array([shared] * 3))
    assert np.abs(landed - np.array(shared)).max() < 1e-6
    for bad in (np.zeros((2, 2)), np.zeros((3, 2, 1))):
        with pytest.raises(ValueError):
            ptt.batch_simulate(p, 600.0, theta_batch=THETA, tstops=bad, **KW)


def _run32():
    p = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float32)
    return p, ptt.batch_simulate(p, 600.0, theta_batch=THETA, tstops=TSTOPS,
                                 tdiscon=TDISCON, abstol=1e-3, **KW)


def test_per_cell_tstops_float32():
    """In float32 every cell ends at tf and lands on each of its stops (the
    float32 stop time, reltol/2 before the discontinuity) within two ulps."""
    p, got = _run32()
    assert (got.flag.numpy() == 0).all()
    stops = _stops(p.opts.reltol).astype(np.float32)
    landed = _landed(got.bufs["t"].numpy(), got.n_saved.numpy(), stops)
    assert (np.abs(landed - stops) <= 2 * np.spacing(stops)).all()


@pytest.mark.slow
def test_per_cell_tstops_float32_against_jax():
    """The float32 run against the JAX package's float32 batch: the same
    flags and the same landed stop times. (Step counts are printed: the two
    float32 runs part from their first step, whose size follows the
    float32 rounding of the consistent initialization's algebraic YP.)"""
    p, got = _run32()
    with jax.enable_x64(False):
        ref = jax_batch(pt.petlion(pt.LCO), 600.0, theta_batch=THETA, tstops=TSTOPS,
                        tdiscon=TDISCON, abstol=1e-3, **KW)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    np.testing.assert_array_equal(got.flag.numpy(), ref.flag)
    stops = _stops(p.opts.reltol).astype(np.float32)
    np.testing.assert_array_equal(
        _landed(got.bufs["t"].numpy(), got.n_saved.numpy(), stops),
        _landed(ref.bufs["t"], ref.n_saved, stops))
    print("steps per cell: port", got.n_steps.numpy(), "JAX", ref.n_steps,
          "; first step h0: port", got.bufs["t"][:, 1].numpy(), "JAX", ref.bufs["t"][:, 1])

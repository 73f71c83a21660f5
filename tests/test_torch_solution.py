"""The port's Solution container against the JAX package's: the same seeded
numpy run buffers go into both `append_run`s, and per-run views,
interpolation (Hermite on Y, natural splines elsewhere), reset_t, exit
reasons, repr, plot and the .npz checkpoint (written by either package and
loaded by the other) must agree."""

import dataclasses
import importlib
import os

import numpy as np
import pytest

import petlion_tpu as pt
import petlion_tpu_torch as ptt
# the modules (both packages' `solution` names are aliases of Solution)
jsol = importlib.import_module("petlion_tpu.solution")
tsol = importlib.import_module("petlion_tpu_torch.solution")

MAX_SAVE = 40
RUNS = ((23, 0.0, 3, "-1.0"), (17, 1e-12, 0, "0.0"))   # n_saved, offset, flag, input


def _bufs(rng, t0):
    """One run's output buffers (MAX_SAVE rows, the tail unused) and final
    state, as the runner hands them over."""
    t = np.concatenate([[0.0], np.cumsum(rng.uniform(1.0, 60.0, MAX_SAVE - 1))])
    w = rng.uniform(0.5, 2.0, 7)
    Y = np.sin(np.outer(t + t0, w) / 400.0) + rng.standard_normal(7)
    YP = np.cos(np.outer(t + t0, w) / 400.0) * w / 400.0
    bufs = dict(t=t, V=4.0 - 1e-4 * t + 1e-3 * rng.standard_normal(MAX_SAVE),
                I=np.full(MAX_SAVE, -1.0), P=rng.standard_normal(MAX_SAVE),
                SOC=1.0 - t / 3600.0, c_e=1000 + rng.standard_normal((MAX_SAVE, 5)),
                Y=Y, YP=YP)
    return bufs, Y[-1] + 1.0, YP[-1], rng.uniform()


def _build(mod):
    rng = np.random.default_rng(11)
    sol = mod.Solution()
    for n_saved, eps, flag, inp in RUNS:
        t_offset = float(sol.t[-1]) + eps if sol else 0.0
        bufs, yf, ypf, socf = _bufs(rng, t_offset)
        meta = dict(method="I", input_repr=inp,
                    tspan=(t_offset, t_offset + float(bufs["t"][n_saved - 1])),
                    flag=flag, exit_reason=mod.exit_reason_string(flag),
                    n_steps=n_saved + 3, n_rejected=2, init_converged=True,
                    truncated=False)
        sol.append_run(bufs, n_saved, t_offset, meta, yf, ypf, socf)
        sol._Y_final_int = yf - 1.0
        sol._outputs = ("t", "V", "c_e", "Y", "YP")
    return sol


@pytest.fixture(scope="module")
def sols():
    return _build(jsol), _build(tsol)


def _results(sol):
    """Run results as dicts (a loaded checkpoint's tspan is a list)."""
    return [dict(dataclasses.asdict(r), tspan=tuple(r.tspan)) for r in sol.results]


def _same(sj, st, atol=0.0):
    assert sorted(st.arrays) == sorted(sj.arrays)
    for k, v in sj.arrays.items():
        assert st.arrays[k].shape == v.shape, k
        np.testing.assert_allclose(st.arrays[k], v, rtol=0, atol=atol, err_msg=k)
    assert _results(st) == _results(sj)
    for k in ("Y_final", "YP_final", "SOC_final", "_Y_final_int", "_outputs"):
        np.testing.assert_array_equal(getattr(st, k), getattr(sj, k), err_msg=k)


def test_append_run_and_views(sols):
    """The concatenated runs, their results and each per-run view `sol[i]`."""
    sj, st = sols
    assert len(st) == len(sj) == 2 and bool(st)
    _same(sj, st)
    for i in (0, 1, -1):
        vj, vt = sj[i], st[i]
        for k, v in vj.arrays.items():
            np.testing.assert_array_equal(vt.arrays[k], v)
        assert _results(vt) == _results(vj)
    assert ptt.final_exit_reason(st) == pt.final_exit_reason(sj) == "Final time reached"
    assert ptt.exit_reasons(st) == pt.exit_reasons(sj) == ["Below min. SOC",
                                                          "Final time reached"]
    assert tsol.exit_reason_string(-2) == jsol.exit_reason_string(-2)
    assert tsol.STATE_NAMES == jsol.STATE_NAMES


@pytest.mark.parametrize("interp_bc", ["interpolate", "extrapolate"])
def test_call_matches_jax(sols, interp_bc):
    """sol(t) over both runs, before the first and past the last point:
    Hermite on Y (YP saved), natural splines on the rest, to 1e-12."""
    sj, st = sols
    tq = np.concatenate([[-50.0], np.linspace(0.0, float(sj.t[-1]) + 80.0, 61)])
    _same(sj(tq, interp_bc=interp_bc), st(tq, interp_bc=interp_bc), atol=1e-12)
    # without YP, Y also goes through the spline
    for s in (sj, st):
        s.arrays["YP_saved"] = s.arrays.pop("YP")
    try:
        yj = sj(tq, interp_bc=interp_bc).arrays["Y"]
        yt = st(tq, interp_bc=interp_bc).arrays["Y"]
    finally:
        for s in (sj, st):
            s.arrays["YP"] = s.arrays.pop("YP_saved")
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-12)


def test_reset_t_repr_and_plot():
    sj, st = _build(jsol), _build(tsol)
    for s in (sj, st):
        s.arrays["t"] = s.arrays["t"] + 50.0
    assert ptt.reset_t(st) is st
    pt.reset_t(sj)
    _same(sj, st)
    assert st.t[0] == 0.0 and isinstance(st.results[1].tspan[0], float)
    assert repr(st) == repr(sj)
    assert repr(tsol.Solution()) == repr(pt.Solution())
    ax_j, ax_t = sj.plot("c_e"), st.plot("c_e")
    assert (ax_t.get_xlabel(), ax_t.get_ylabel()) == (ax_j.get_xlabel(), ax_j.get_ylabel())
    assert len(ax_t.lines) == len(ax_j.lines)
    with pytest.raises(KeyError):
        st.plot("film")


def test_checkpoint_loads_across_packages(sols, tmp_path):
    """A checkpoint written by either package has the same keys and loads
    in the other to the same solution."""
    sj, st = sols
    pj, ptp = os.fspath(tmp_path / "jax.npz"), os.fspath(tmp_path / "port.npz")
    sj.save(pj)
    st.save(ptp)
    with np.load(pj) as zj, np.load(ptp) as zt:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    _same(sj, tsol.Solution.load(pj))
    _same(pt.Solution.load(ptp), st)
    _same(sj, ptt.Solution.load(ptp))

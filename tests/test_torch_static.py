"""The PyTorch port's static model (config, layout, LCO chemistry, parameter
carry-over, the main path's definition) against the JAX package and its
benchmark program, and the port's import boundary."""

import dataclasses
import math
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import petlion_tpu as pt
import petlion_tpu_torch as ptt

torch.set_num_threads(1)

PKG = pathlib.Path(ptt.__file__).resolve().parent


@pytest.fixture(scope="module")
def p_jax():
    return pt.petlion(pt.LCO)


VARIANTS = ({}, {"temperature": True}, {"aging": "SEI"}, {"aging": "stress"},
            {"solid_diffusion": "polynomial"}, {"anode": "Li_metal"},
            {"temperature": True, "aging": "SEI"})


def test_layout_matches_jax(p_jax):
    """Default LCO (301/230/71) and the variant layouts equal the JAX
    package's entry by entry; the accessors read the same elements."""
    for kw in VARIANTS:
        Lj = pt.StateLayout.build(pt.Discretizations(), pt.Numerics(**kw))
        Lt = ptt.StateLayout.build(ptt.Discretizations(), ptt.Numerics(**kw))
        assert (Lt.N_tot, Lt.N_diff, Lt.N_alg, Lt.half_cell) == \
            (Lj.N_tot, Lj.N_diff, Lj.N_alg, Lj.half_cell), kw
        assert list(Lt.entries) == list(Lj.entries), kw
        for name, ej in Lj.entries.items():
            et = Lt.entries[name]
            assert (et.start, et.length, et.var_type, et.sections) == \
                (ej.start, ej.length, ej.var_type, ej.sections), (kw, name)
    Lj = p_jax.cfg.layout
    Lt = ptt.petlion(ptt.LCO, device="cpu").layout
    assert (Lt.N_tot, Lt.N_diff, Lt.N_alg) == (301, 230, 71)
    y = np.arange(301.0)
    yt = torch.as_tensor(y)
    for el in ("p", "n"):
        np.testing.assert_array_equal(Lt.c_s_surf(yt, el).numpy(),
                                      Lj.c_s_surf(y, el))
    assert float(Lt.V(yt)) == float(Lj.V(y))
    assert float(Lt.I(yt)) == float(Lj.I(y))
    assert float(Lt.eta_plating(yt)) == float(Lj.eta_plating(y))


def _same(a, b):
    return (a == b) or (isinstance(a, float) and math.isnan(a) and math.isnan(b))


def test_lco_theta_bounds_opts_match_jax():
    th_j, b_j, o_j, N_j, num_j = pt.LCO()
    th_t, b_t, o_t, N_t, num_t = ptt.LCO()
    assert th_t == th_j
    for f in dataclasses.fields(b_j):
        assert _same(getattr(b_t, f.name), getattr(b_j, f.name)), f.name
    for f in dataclasses.fields(o_j):
        assert getattr(o_t, f.name) == getattr(o_j, f.name), f.name
    assert dataclasses.asdict(N_t) == dataclasses.asdict(N_j)
    for f in dataclasses.fields(num_j):
        vj, vt = getattr(num_j, f.name), getattr(num_t, f.name)
        if callable(vj):
            assert vt.__name__ == vj.__name__, f.name
        else:
            assert vt == vj, f.name
    assert ptt.EXIT_REASONS == pt.EXIT_REASONS


def test_model_from_numpy_round_trips(p_jax):
    m = ptt.model_from_numpy(
        {k: np.float64(v) for k, v in p_jax.theta.items()}, p_jax.bounds,
        p_jax.N, p_jax.numerics, opts=p_jax.opts, device="cpu",
        dtype=torch.float64)
    assert m.theta_floats() == p_jax.theta
    for f in dataclasses.fields(p_jax.opts):
        assert getattr(m.opts, f.name) == getattr(p_jax.opts, f.name), f.name
    assert m.cfg.layout == ptt.petlion(ptt.LCO, device="cpu").cfg.layout
    assert m.numerics == ptt.LCO()[4]
    for f in dataclasses.fields(p_jax.bounds):
        assert _same(getattr(m.bounds, f.name), getattr(p_jax.bounds, f.name))
    assert m.I1C == pytest.approx(p_jax.I1C, rel=1e-15)
    # the thermal model (ported): the JAX package's layout, 351 states
    lt, lj = (ptt.petlion(ptt.LCO, device="cpu", temperature=True).cfg.layout,
              pt.petlion(pt.LCO, temperature=True).cfg.layout)
    assert lt.N_tot == lj.N_tot == 351
    assert [(k, e.start, e.length) for k, e in lt._entries] == \
        [(k, e.start, e.length) for k, e in lj._entries]


def test_main_path_is_the_bench_program():
    """The port's main path sweeps bench.py's θ with bench.py's draws (cell 0
    kept at the published values) under bench.py's options."""
    import bench
    from petlion_tpu_torch import main_path as mp
    assert mp.SWEPT_THETA == bench.SWEPT_THETA
    assert mp.BENCH_OPTS == dict(abstol=5e-4, reltol=1e-3, max_save=2,
                                 maxiters=500)
    tb = mp.theta_batch(3)
    want = bench.fresh_theta(np.random.default_rng(3), mp.B_MAIN)
    for k, v in mp.SWEPT_THETA.items():
        assert tb[k].shape == (mp.B_MAIN,) and tb[k][0] == v
        np.testing.assert_array_equal(tb[k][1:], want[k][1:])
    p = mp.model(device="cpu")
    assert (p.dtype, p.opts.abstol, p.opts.maxiters) == (torch.float32, 5e-4, 500)


def test_port_sources_import_no_jax():
    """No source of the port imports JAX or names the JAX package, and none
    reaches into the repository's csrc/ (the JAX package's native runtime):
    the port builds its own csrc/ sources into build/."""
    bad = re.compile(r"^\s*(import jax|from jax)|petlion_tpu(?!_torch)"
                     r"|parents\[2\]\s*/\s*[\"']csrc|\.\./csrc|petlion_native", re.M)
    offenders = [str(f.relative_to(PKG)) for f in PKG.rglob("*")
                 if f.suffix in (".py", ".cu", ".cuh", ".cpp")
                 and bad.search(f.read_text())]
    assert offenders == []
    from petlion_tpu_torch.ops import gj_kernel
    from petlion_tpu_torch.runtime import native
    for src in (gj_kernel.CSRC, native.SOURCE.parent):
        assert src == PKG / "csrc"
    for out in (gj_kernel.BUILD_DIR, native.BUILD_DIR):
        assert out.parent == PKG.parent / "build"


def test_import_leaves_jax_unloaded():
    code = ("import sys, petlion_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('petlion_tpu.') or m == 'petlion_tpu' "
            "for m in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
